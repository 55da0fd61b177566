"""Fused kNN adjacency: the hand-written Hopper kernels and their plain version.

Replaces the TPU kernel ``mused_tpu/ops/pallas/affinity_kernel.py:
knn_adjacency_pallas``.  The CUDA source is ``mused_tpu_torch/csrc/
knn_adjacency.cu`` (its header note gives the design and what bounds it on
an H100).  :func:`knn_adjacency` launches it for CUDA tensors and raises on
anything it does not take; for tensors on the CPU it runs
:func:`knn_adjacency_reference`, the same function in plain PyTorch.  There
is no fallback from a CUDA tensor to the plain version.

Metrics (every modality of the standard path, plus the generic types) and
the keys kernel each takes on the card:
  dot        tensor cores (3xTF32); cosine / TF-IDF cosine on pre-normalized rows
  euclidean  tensor cores (3xTF32); -(|r|^2 + |c|^2 - 2 r.c), norms hoisted
  jaccard    tensor cores (one exact TF32 pass on 0/1 incidence); inter / union
  l1         coordinate kernel; negative |dt_taken| + |dt_upload| (time, d = 2)
  chord3     coordinate kernel; negative squared chord of unit-xyz differences
             (location; unlike the f32 dot it keeps resolution at city-scale
             angles)
Every metric stores its keys to a device scratch of (chunk rows, n), from
which a radix select of one CTA per row picks each row's k.

``input_dtype="bfloat16"`` rounds the operands to bf16 first, as the TPU
kernel's option does; products stay exact and sums f32, and on the
tensor-core route the lo half of every operand is then zero, so its
products are skipped and one TF32 pass remains.
"""
from __future__ import annotations

from typing import Callable

import torch

from mused_tpu_torch.ops import affinity
from mused_tpu_torch.ops.kernels import build

METRICS = ("dot", "euclidean", "jaccard", "l1", "chord3")
TENSOR_CORE = ("dot", "euclidean", "jaccard")   # the rest: the coordinate kernel
INPUT_DTYPES = ("float32", "bfloat16")
MAX_ROWS = 32_768   # dense-window limit (larger windows take the blocked path)
KEY_SCRATCH_BYTES = 256 << 20   # keys of every row up to this size: no memory query
KEY_MEMORY_SHARE = 0.5          # above it, at most this share of the free memory
TILE = 64                       # the tensor-core output tile; chunks are multiples of it

launches = 0        # kernel launches so far (plain-version calls not counted)


def reset_launches() -> None:
    global launches
    launches = 0


def similarity(x: torch.Tensor, metric: str) -> torch.Tensor:
    """Dense (n, n) similarity under ``metric`` (the kernel's _sim_block).

    The sums of l1 and chord3 run in the same order as the JAX package's so
    the values agree bit for bit."""
    if metric == "dot":
        return x @ x.T
    if metric == "euclidean":
        rn = torch.sum(x * x, dim=1, keepdim=True)
        return -(rn + rn.T - 2.0 * (x @ x.T))
    if metric == "jaccard":
        return affinity.jaccard_matrix(x)
    if metric in ("l1", "chord3"):
        cols = x.shape[1] if metric == "l1" else 3
        acc = None
        for j in range(cols):
            diff = x[:, None, j] - x[None, :, j]
            term = torch.abs(diff) if metric == "l1" else diff * diff
            acc = term if acc is None else acc + term
        return -acc
    raise ValueError(f"unknown metric {metric!r}: expected one of {METRICS}")


def _operands(x: torch.Tensor, input_dtype: str) -> torch.Tensor:
    """x as the kernel consumes it: float32, rounded to bf16 if asked."""
    x = x.float()
    return x.to(torch.bfloat16).float() if input_dtype == "bfloat16" else x


def route(metric: str) -> str:
    """The keys kernel a CUDA call of ``metric`` runs: "tensor-core" or "coordinate"."""
    return "tensor-core" if metric in TENSOR_CORE else "coordinate"


def key_stride(n: int) -> int:
    """Columns of a key-scratch row: n rounded up to 4 (16-byte rows)."""
    return -(-n // 4) * 4


def chunk_rows_for(n: int, free: Callable[[], int], chunk_rows: int | None = None) -> int:
    """Rows of keys one chunk holds: ``chunk_rows`` if given, else all n when
    their keys fit ``KEY_SCRATCH_BYTES`` or ``KEY_MEMORY_SHARE`` of the
    ``free()`` bytes (asked only then), else as many as fit that share.
    Below n the count is rounded down to a multiple of ``TILE`` (at least
    one tile).  One chunk of all rows lets the tensor-core route compute the
    upper triangle only."""
    row_bytes = 4 * key_stride(n)
    if chunk_rows:
        rows = int(chunk_rows)
    elif n * row_bytes <= KEY_SCRATCH_BYTES:
        rows = n
    else:
        rows = int(free() * KEY_MEMORY_SHARE) // row_bytes
    return n if rows >= n else max(TILE, rows // TILE * TILE)


def free_bytes(device: torch.device) -> int:
    """Device memory an allocation can take: free on the card plus what the
    caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def knn_adjacency_reference(x: torch.Tensor, valid: torch.Tensor, k: int,
                            metric: str = "dot", *,
                            input_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version: dense similarity, mask, stable sort, scatter."""
    return affinity.knn_adjacency(similarity(_operands(x, input_dtype), metric), valid, k)


def _check(x: torch.Tensor, valid: torch.Tensor, metric: str, input_dtype: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}: expected one of {METRICS}")
    if input_dtype not in INPUT_DTYPES:
        raise ValueError(f"unknown input_dtype {input_dtype!r}: expected one of "
                         f"{INPUT_DTYPES}")
    if x.ndim != 2 or x.dtype != torch.float32:
        raise TypeError(f"x must be a 2-D float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if valid.shape != (x.shape[0],) or valid.dtype != torch.bool:
        raise TypeError(f"valid must be a ({x.shape[0]},) bool tensor, "
                        f"got {valid.dtype} {tuple(valid.shape)}")
    if valid.device != x.device:
        raise ValueError(f"x on {x.device} but valid on {valid.device}")
    if metric == "chord3" and x.shape[1] != 3:
        raise ValueError(f"chord3 takes (n, 3) unit vectors, got {tuple(x.shape)}")


def knn_adjacency(x: torch.Tensor, valid: torch.Tensor, k: int,
                  metric: str = "dot", *, input_dtype: str = "float32",
                  chunk_rows: int | None = None) -> torch.Tensor:
    """Directed kNN adjacency (n, n) float32 0/1 from (n, d) features.

    Same semantics as ``affinity.knn_adjacency`` on the metric's similarity
    (exclude self, exactly k per valid row, lowest index first on ties).
    CUDA tensors run the hand-written kernels; CPU tensors the plain version.
    ``chunk_rows`` bounds the rows whose keys a call holds at once (default:
    :func:`chunk_rows_for` on the free device memory).  A call counts as one
    launch however many chunks and CUDA kernels it runs.
    """
    _check(x, valid, metric, input_dtype)
    if x.device.type == "cpu":
        return knn_adjacency_reference(x, valid, k, metric, input_dtype=input_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"knn_adjacency runs on cuda or cpu tensors, not {x.device}")
    if not (x.is_contiguous() and valid.is_contiguous()):
        raise ValueError("x and valid must be contiguous")
    n, d = x.shape
    if n > MAX_ROWS:
        raise ValueError(f"n={n} rows exceeds the dense-window kernel's "
                         f"{MAX_ROWS}; huge windows take the blocked path")
    k = max(0, min(int(k), n - 1))
    if k == 0:
        return torch.zeros((n, n), dtype=torch.float32, device=x.device)
    if input_dtype == "bfloat16":
        x = _operands(x, input_dtype)
    lib = build.load()
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if metric in TENSOR_CORE and (d % 4 or x.data_ptr() % 16):   # 16-byte rows
            x = torch.nn.functional.pad(x, (0, -d % 4)).contiguous()
        chunk = chunk_rows_for(n, lambda: free_bytes(x.device), chunk_rows)
        stats = torch.empty(n, dtype=torch.float32, device=x.device)
        keys = torch.empty((chunk, key_stride(n)), dtype=torch.int32, device=x.device)
        code = lib.mused_knn_adjacency(x.data_ptr(), valid.data_ptr(), stats.data_ptr(),
                                       keys.data_ptr(), out.data_ptr(), n, x.shape[1], k,
                                       METRICS.index(metric), chunk, stream)
    build.check(code, f"knn_adjacency[{metric}] n={n} d={d} k={k} chunk={chunk}")
    global launches
    launches += 1
    return out


def location_to_unit_xyz(latlon: torch.Tensor) -> torch.Tensor:
    """(n, 2) degrees -> (n, 3) unit-sphere vectors (chord ranks like
    haversine)."""
    rad = torch.deg2rad(latlon)
    lat, lon = rad[:, 0], rad[:, 1]
    return torch.stack([torch.cos(lat) * torch.cos(lon),
                        torch.cos(lat) * torch.sin(lon),
                        torch.sin(lat)], dim=1)
