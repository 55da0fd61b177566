"""Products with candidate-form fused adjacency rows: the hand-written Hopper
kernels K4 / K5 and their plain versions.

Replaces the TPU kernels ``mused_tpu/ops/pallas/cand_matvec.py:
matvec_t_pallas`` (K4) and ``matvec_pallas`` (K5).  The CUDA source is
``mused_tpu_torch/csrc/cand_matvec.cu`` (its header note gives the design
and what bounds it on an H100).

The huge-window FD fold consumes a (block, n) fused adjacency block only
through products.  A :class:`CandBlock` holds the block as int8 candidate
slabs, one per binned modality:

    slab[r, s] = group id g of the kept candidate (column g * nbins + s)
               = -1 when slot s keeps no candidate for row r

plus the username modality as uids (rows -1 and columns -2 where invalid,
so invalid never matches).  The fused tile of column group g is
``OR_m (slab_m == g) | (uid_row == uid_col & not self)``; the kernels
rebuild it on the fly, so the dense block never exists in memory.

``matvec_t`` / ``matvec`` launch the kernels for CUDA tensors and raise on
anything they do not take; for tensors on the CPU they run the plain
versions ``matvec_t_reference`` / ``matvec_reference``.  Operands are bf16
and sums f32 (the 0/1 tile is bf16-exact, so each product equals the f32
product of the bf16 operand).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mused_tpu_torch.ops.kernels import build

launches_t = 0      # K4 launches so far (plain-version calls not counted)
launches = 0        # K5 launches so far


def reset_launches() -> None:
    global launches_t, launches
    launches_t = launches = 0


class CandBlock(NamedTuple):
    """Candidate-form fused adjacency rows [start, start+block) of an
    implicit (n, n) fused kNN adjacency, n = groups * nbins.  ``g0`` is the
    global id of local group 0 (0 on one device)."""

    slabs: torch.Tensor                 # (M, block, nbins) int8: local grp or -1
    uid_rows: torch.Tensor | None       # (block, 1) int32, -1 where invalid
    uid_cols: torch.Tensor              # (groups, nbins) int32, -2 where invalid
    start: int                          # global row offset
    g0: int = 0                         # global group offset

    @property
    def block(self) -> int:
        return self.slabs.shape[1]

    @property
    def nbins(self) -> int:
        return self.slabs.shape[2]

    @property
    def groups(self) -> int:
        return self.uid_cols.shape[0]


def pack_slab(keep: torch.Tensor, grp: torch.Tensor) -> torch.Tensor:
    """(block, nbins) int8 slab from budgeted_keep's mask + group ids."""
    return torch.where(keep, grp, torch.tensor(-1, dtype=torch.int8, device=grp.device))


def mask_uids(uid: torch.Tensor, valid: torch.Tensor, nbins: int,
              rows_start: int | None = None, block: int | None = None):
    """(uid_rows (block, 1), uid_cols (groups, nbins)) int32 operands of a
    CandBlock from the window's (n,) uids and validity; column
    c = g * nbins + s lands at [g, s]."""
    ucol = torch.where(valid, uid, -2).reshape(-1, nbins).to(torch.int32)
    urow = torch.where(valid, uid, -1).to(torch.int32)
    if rows_start is not None:
        urow = urow[rows_start:rows_start + block]
    return urow.reshape(-1, 1), ucol


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def dense_tile_reference(cand: CandBlock, g: int) -> torch.Tensor:
    """(block, nbins) bool fused tile of local column group ``g``."""
    mask = cand.slabs[0].to(torch.int32) == g
    for m in range(1, cand.slabs.shape[0]):
        mask = mask | (cand.slabs[m].to(torch.int32) == g)
    if cand.uid_rows is not None:
        dev = mask.device
        same = cand.uid_rows == cand.uid_cols[g][None, :]
        rows = cand.start + torch.arange(cand.block, device=dev)[:, None]
        cols = (cand.g0 + g) * cand.nbins + torch.arange(cand.nbins, device=dev)[None, :]
        mask = mask | (same & (rows != cols))
    return mask


def dense_rows_reference(cand: CandBlock) -> torch.Tensor:
    """(block, n) bool fused adjacency rows: the concatenated group tiles."""
    return torch.cat([dense_tile_reference(cand, g) for g in range(cand.groups)], dim=1)


def matvec_t_reference(cand: CandBlock, x_t: torch.Tensor):
    """Plain version of K4: per-group x_t @ W_g with f32 operands (bf16 x
    0/1 is exact) -> (out_t (r, n) f32, edges () f32)."""
    xf = x_t.float()
    outs, edges = [], torch.zeros((), dtype=torch.float32, device=x_t.device)
    for g in range(cand.groups):
        w = dense_tile_reference(cand, g).float()
        outs.append(xf @ w)
        edges = edges + torch.sum(w)
    return torch.cat(outs, dim=1), edges


def matvec_reference(cand: CandBlock, y: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: sum over groups of W_g @ y_g, in group order."""
    nbins = cand.nbins
    yf = y.float()
    out = torch.zeros((cand.block, y.shape[1]), dtype=torch.float32, device=y.device)
    for g in range(cand.groups):
        out = out + dense_tile_reference(cand, g).float() @ yf[g * nbins:(g + 1) * nbins]
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cand(cand: CandBlock, operand: torch.Tensor, name: str) -> None:
    s = cand.slabs
    if s.ndim != 3 or s.dtype != torch.int8:
        raise TypeError(f"slabs must be (M, block, nbins) int8, got {s.dtype} "
                        f"{tuple(s.shape)}")
    if cand.uid_cols.dtype != torch.int32 or cand.uid_cols.ndim != 2 \
            or cand.uid_cols.shape[1] != cand.nbins:
        raise TypeError(f"uid_cols must be (groups, {cand.nbins}) int32, got "
                        f"{cand.uid_cols.dtype} {tuple(cand.uid_cols.shape)}")
    if cand.groups > 127:
        raise ValueError(f"{cand.groups} groups exceed int8 group ids")
    tensors = [s, cand.uid_cols, operand]
    if cand.uid_rows is not None:
        if cand.uid_rows.dtype != torch.int32 or cand.uid_rows.shape != (cand.block, 1):
            raise TypeError(f"uid_rows must be ({cand.block}, 1) int32, got "
                            f"{cand.uid_rows.dtype} {tuple(cand.uid_rows.shape)}")
        tensors.append(cand.uid_rows)
    if operand.dtype != torch.bfloat16 or operand.ndim != 2:
        raise TypeError(f"{name} must be a 2-D bfloat16 tensor, got {operand.dtype} "
                        f"{tuple(operand.shape)}")
    if any(t.device != s.device for t in tensors):
        raise ValueError(f"slabs, uids and {name} must share a device")
    if s.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cand_matvec runs on cuda or cpu tensors, not {s.device}")


def _cand_args(cand: CandBlock):
    uid_rows = None if cand.uid_rows is None else cand.uid_rows.data_ptr()
    return (cand.slabs.data_ptr(), uid_rows, cand.uid_cols.data_ptr(),
            cand.slabs.shape[0], cand.block, cand.nbins, cand.groups, int(cand.start),
            int(cand.g0))


def matvec_t(cand: CandBlock, x_t: torch.Tensor):
    """rows^T @ x for the implicit fused rows (K4): x_t is x pre-transposed,
    (r, block) bf16.  Returns (out_t (r, n) f32, edges () f32), edges the
    exact fused edge count (exact in f32 below 2**24 edges per block)."""
    _check_cand(cand, x_t, "x_t")
    if x_t.shape[1] != cand.block:
        raise ValueError(f"x_t must be (r, {cand.block}), got {tuple(x_t.shape)}")
    if x_t.device.type == "cpu":
        return matvec_t_reference(cand, x_t)
    r = x_t.shape[0]
    dev = x_t.device
    out_t = torch.empty((r, cand.groups * cand.nbins), dtype=torch.float32, device=dev)
    edges = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mused_cand_matvec_t(*_cand_args(cand), x_t.data_ptr(), r,
                                       out_t.data_ptr(), edges.data_ptr(), stream)
    build.check(code, f"cand_matvec_t block={cand.block} nbins={cand.nbins} "
                      f"groups={cand.groups} r={r}")
    global launches_t
    launches_t += 1
    return out_t, edges[0].float()


def matvec(cand: CandBlock, y: torch.Tensor) -> torch.Tensor:
    """rows @ y for the implicit fused rows (K5): y (n, r) bf16 -> (block, r)
    f32.  Any r: the kernel pads the live columns in shared memory and
    writes only those."""
    _check_cand(cand, y, "y")
    if y.shape[0] != cand.groups * cand.nbins:
        raise ValueError(f"y must be ({cand.groups * cand.nbins}, r), got "
                         f"{tuple(y.shape)}")
    if y.device.type == "cpu":
        return matvec_reference(cand, y)
    r = y.shape[1]
    dev = y.device
    lib = build.load()
    splits = lib.mused_cand_matvec_splits(cand.slabs.shape[0], cand.block, cand.nbins, r)
    out = torch.empty((cand.block, r), dtype=torch.float32, device=dev)
    scratch = (torch.empty((splits, cand.block, r), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mused_cand_matvec(*_cand_args(cand), y.data_ptr(), r, out.data_ptr(),
                                     None if scratch is None else scratch.data_ptr(),
                                     splits, stream)
    build.check(code, f"cand_matvec block={cand.block} nbins={cand.nbins} "
                      f"groups={cand.groups} r={r}")
    global launches
    launches += 1
    return out
