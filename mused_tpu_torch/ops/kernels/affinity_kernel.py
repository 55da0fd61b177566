"""Fused kNN adjacency: the hand-written Hopper kernel and its plain version.

Replaces the TPU kernel ``mused_tpu/ops/pallas/affinity_kernel.py:
knn_adjacency_pallas``.  The CUDA source is ``mused_tpu_torch/csrc/
knn_adjacency.cu`` (its header note gives the design and what bounds it on
an H100).  :func:`knn_adjacency` launches it for CUDA tensors and raises on
anything it does not take; for tensors on the CPU it runs
:func:`knn_adjacency_reference`, the same function in plain PyTorch.  There
is no fallback from a CUDA tensor to the plain version.

Metrics (every modality of the standard path, plus the generic types):
  dot        cosine / TF-IDF cosine on pre-normalized rows
  euclidean  negative squared distance
  jaccard    inter / union over 0/1 incidence, set sizes reduced in the kernel
  l1         negative |dt_taken| + |dt_upload| (time, d = 2)
  chord3     negative squared chord of unit-xyz differences (location; unlike
             the f32 dot it keeps resolution at city-scale angles)
"""
from __future__ import annotations

import torch

from mused_tpu_torch.ops import affinity
from mused_tpu_torch.ops.kernels import build

METRICS = ("dot", "euclidean", "jaccard", "l1", "chord3")
MAX_ROWS = 32_768   # dense-window limit: one row's f32 strip fits shared memory

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


def knn_adjacency_reference(x: torch.Tensor, valid: torch.Tensor, k: int,
                            metric: str = "dot") -> torch.Tensor:
    """Plain PyTorch version: dense similarity, mask, stable sort, scatter."""
    return affinity.knn_adjacency(similarity(x.float(), metric), valid, k)


def _check(x: torch.Tensor, valid: torch.Tensor, metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}: expected one of {METRICS}")
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
                  metric: str = "dot") -> torch.Tensor:
    """Directed kNN adjacency (n, n) float32 0/1 from (n, d) features.

    Same semantics as ``affinity.knn_adjacency`` on the metric's similarity
    (exclude self, exactly k per valid row, lowest index first on ties).
    CUDA tensors run the hand-written kernel; CPU tensors the plain version.
    """
    _check(x, valid, metric)
    if x.device.type == "cpu":
        return knn_adjacency_reference(x, valid, k, metric)
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
    lib = build.load()
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.mused_knn_adjacency(x.data_ptr(), valid.data_ptr(), out.data_ptr(),
                                       n, d, k, METRICS.index(metric), stream)
    build.check(code, f"knn_adjacency[{metric}] n={n} d={d} k={k}")
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
