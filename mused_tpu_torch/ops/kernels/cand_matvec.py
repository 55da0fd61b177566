"""Products with candidate-form fused adjacency rows: the hand-written Hopper
kernels K4 / K5, the candidate lists they gather over, and their plain
versions.

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
``OR_m (slab_m == g) | (uid_row == uid_col & not self)``; the dense block
never exists in memory.  On the card the products gather over the block's
kept entries: :func:`build_lists` (one launch of the list kernels per block,
counted in ``launches_lists``) turns the slabs into per-row and per-column
lists and per-user tables, which :func:`with_lists` attaches to the block so
that its products share them.

``matvec_t`` / ``matvec`` launch the kernels for CUDA tensors and raise on
anything they do not take; for tensors on the CPU they run the plain
versions ``matvec_t_reference`` / ``matvec_reference``.  Operands are bf16
and sums f32 (the 0/1 tile is bf16-exact, so each product equals the f32
product of the bf16 operand).  ``lists_reference`` is the plain version of
the lists.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mused_tpu_torch.ops.kernels import build

launches_t = 0      # K4 launches so far (plain-version calls not counted)
launches = 0        # K5 launches so far
launches_lists = 0  # list builds so far


def reset_launches() -> None:
    global launches_t, launches, launches_lists
    launches_t = launches = launches_lists = 0


class CandLists(NamedTuple):
    """The lists of one candidate block on the card, in one int32 workspace
    laid out by the CUDA source (``mused_cand_lists_layout``): each row's
    kept columns (slot order; entries the username term counts left out),
    each column's rows (ascending), the block's distinct uids with each
    user's rows and columns, and the exact edge count.  ``source`` is what
    they were built from; the products refuse a block that differs."""

    workspace: torch.Tensor
    names: tuple                         # the arrays, in workspace order
    offsets: tuple                       # int32 words
    sizes: tuple
    q: int                               # column chunks of the user-column sort
    source: tuple                        # _lists_source of the block

    def array(self, name: str) -> torch.Tensor:
        k = self.names.index(name)
        return self.workspace[self.offsets[k]:self.offsets[k] + self.sizes[k]]

    @property
    def edges(self) -> torch.Tensor:
        """(1,) int64: the exact fused edge count of the block."""
        return self.array("edges").view(torch.int64)


class CandBlock(NamedTuple):
    """Candidate-form fused adjacency rows [start, start+block) of an
    implicit (n, n) fused kNN adjacency, n = groups * nbins.  ``g0`` is the
    global id of local group 0 (0 on one device).  ``lists``, when set, are
    this block's candidate lists (:func:`with_lists`); they hold the
    tensors and offsets they were built from, and every product raises on
    a block whose fields differ (replace a field with ``lists=None``)."""

    slabs: torch.Tensor                 # (M, block, nbins) int8: local grp or -1
    uid_rows: torch.Tensor | None       # (block, 1) int32, -1 where invalid
    uid_cols: torch.Tensor              # (groups, nbins) int32, -2 where invalid
    start: int                          # global row offset
    g0: int = 0                         # global group offset
    lists: CandLists | None = None      # built from these slabs (with_lists)

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
    return grp.masked_fill(~keep, -1)     # no scalar tensor: no copy, no host wait


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


def _exclusive(counts: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(torch.cumsum(counts, 0), (1, 0))


def lists_reference(cand: CandBlock) -> dict:
    """Plain version of the list kernels: int64 tensors named as the
    workspace's arrays (:meth:`CandLists.array`; ``ucolptr`` for the
    per-user column offsets the kernel keeps in ``hoff``; the user tables
    only with usernames) and the exact ``edges`` (a Python int).

    A row's list holds the local column of every (slot, group) some plane
    keeps, once (the first plane to hold it), in (slot, plane) order, less
    the columns with the row's uid other than its own (the username term
    counts those); ``colrows`` lists each column's rows ascending.  The
    username term of (row i, column c) is ``row_user[i] == col_user[c]``
    off the self pair."""
    sl = cand.slabs.long()
    m_count, block, nbins = sl.shape
    groups, dev = cand.groups, sl.device
    n = groups * nbins
    keep = (sl >= 0) & (sl < groups)
    for m in range(1, m_count):
        keep[m] &= ~(sl[:m] == sl[m]).any(0)
    col = sl.clamp(0, groups - 1) * nbins + torch.arange(nbins, device=dev)
    user = cand.uid_rows is not None
    if user:
        urow = cand.uid_rows[:, 0].long()
        ucol = cand.uid_cols.reshape(-1).long()
        self_col = cand.start + torch.arange(block, device=dev) - cand.g0 * nbins
        keep &= ~((ucol[col] == urow[None, :, None]) & (col != self_col[None, :, None]))
    rows, slots, planes = keep.permute(1, 2, 0).nonzero(as_tuple=True)
    rowcols = col[planes, rows, slots]
    out = {"rowptr": _exclusive(torch.bincount(rows, minlength=block)), "rowcols": rowcols,
           "colptr": _exclusive(torch.bincount(rowcols, minlength=n)),
           "colrows": rows[torch.sort(rowcols, stable=True).indices]}
    edges = rowcols.numel()
    if user:
        uids, row_user = torch.unique(urow, sorted=True, return_inverse=True)
        nu = uids.numel()
        pos = torch.searchsorted(uids, ucol).clamp(max=nu - 1)
        col_user = torch.where(uids[pos] == ucol, pos, -1)
        matched = col_user >= 0
        userptr = _exclusive(torch.bincount(row_user, minlength=nu))
        self_row = cand.g0 * nbins + torch.arange(n, device=dev) - cand.start
        inside = (self_row >= 0) & (self_row < block)
        own = inside & (row_user[self_row.clamp(0, block - 1)] == col_user)
        sizes = (userptr[1:] - userptr[:-1])[col_user.clamp(min=0)]
        edges += int(torch.where(matched, sizes - own.long(), 0).sum())
        out.update(nu=torch.tensor([nu], device=dev), uids=uids, row_user=row_user,
                   userptr=userptr, userrows=torch.sort(row_user, stable=True).indices,
                   col_user=col_user,
                   ucolptr=_exclusive(torch.bincount(col_user[matched], minlength=nu)),
                   ucols=torch.sort(torch.where(matched, col_user, nu),
                                    stable=True).indices[:int(matched.sum())])
    out["edges"] = edges
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def check_cand(cand: CandBlock, operand: torch.Tensor | None = None,
               name: str = "") -> None:
    """Raise on a candidate block (and bf16 ``operand``) the kernels do not
    take: types, shapes, one device, contiguous on the card."""
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
    tensors = [s, cand.uid_cols]
    if cand.uid_rows is not None:
        if cand.uid_rows.dtype != torch.int32 or cand.uid_rows.shape != (cand.block, 1):
            raise TypeError(f"uid_rows must be ({cand.block}, 1) int32, got "
                            f"{cand.uid_rows.dtype} {tuple(cand.uid_rows.shape)}")
        tensors.append(cand.uid_rows)
    if operand is not None:
        if operand.dtype != torch.bfloat16 or operand.ndim != 2:
            raise TypeError(f"{name} must be a 2-D bfloat16 tensor, got {operand.dtype} "
                            f"{tuple(operand.shape)}")
        tensors.append(operand)
    if cand.lists is not None:
        if not _lists_match(cand):
            raise ValueError("the block's lists were built from other slabs, uids, start or "
                             "g0: replace a field with lists=None")
        tensors.append(cand.lists.workspace)
    if any(t.device != s.device for t in tensors):
        raise ValueError(f"slabs, uids, lists and {name or 'operands'} must share a device")
    if s.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cand_matvec runs on cuda or cpu tensors, not {s.device}")


def _lists_source(cand: CandBlock) -> tuple:
    return cand.slabs, cand.uid_rows, cand.uid_cols, int(cand.start), int(cand.g0)


def _lists_match(cand: CandBlock) -> bool:
    """The block's lists were built from its own tensors (the same objects:
    the lists keep them alive, so no other tensor can take their memory)
    and offsets."""
    slabs, uid_rows, uid_cols, start, g0 = cand.lists.source
    return (slabs is cand.slabs and uid_rows is cand.uid_rows and uid_cols is cand.uid_cols
            and start == int(cand.start) and g0 == int(cand.g0))


def _cand_args(cand: CandBlock):
    uid_rows = None if cand.uid_rows is None else cand.uid_rows.data_ptr()
    return (cand.slabs.data_ptr(), uid_rows, cand.uid_cols.data_ptr(),
            cand.slabs.shape[0], cand.block, cand.nbins, cand.groups, int(cand.start),
            int(cand.g0))


def build_lists(cand: CandBlock) -> CandLists:
    """The candidate lists of a block on the card (one launch of the list
    kernels, counted in ``launches_lists``).  CUDA tensors only: the plain
    version is :func:`lists_reference`, and the plain products read the
    slabs."""
    check_cand(cand)
    if cand.slabs.device.type != "cuda":
        raise ValueError("the candidate lists are the kernels' operand: build them for "
                         "CUDA tensors (the CPU runs the plain products)")
    lib = build.load()
    names = tuple(lib.mused_cand_list_names().decode().split(","))
    offsets = (ctypes.c_longlong * len(names))()
    sizes = (ctypes.c_longlong * len(names))()
    words, q = ctypes.c_longlong(), ctypes.c_int()
    what = (f"cand_lists block={cand.block} nbins={cand.nbins} groups={cand.groups} "
            f"planes={cand.slabs.shape[0]}")
    build.check(lib.mused_cand_lists_layout(cand.slabs.shape[0], cand.block, cand.nbins,
                                            cand.groups, offsets, sizes, ctypes.byref(words),
                                            ctypes.byref(q)),
                what + " (a shape the list kernels do not take)")
    dev = cand.slabs.device
    workspace = torch.empty((words.value,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mused_cand_lists(*_cand_args(cand), workspace.data_ptr(), stream)
    build.check(code, what)
    global launches_lists
    launches_lists += 1
    return CandLists(workspace, names, tuple(offsets), tuple(sizes), q.value,
                     _lists_source(cand))


def with_lists(cand: CandBlock) -> CandBlock:
    """``cand`` with its lists attached when the kernels will run it (CUDA
    tensors), so that its products share one build; unchanged on the CPU or
    when it has them."""
    if cand.lists is not None or cand.slabs.device.type != "cuda":
        return cand
    return cand._replace(lists=build_lists(cand))


def _launch(fn, cand: CandBlock, operand: torch.Tensor, r: int, out: torch.Tensor,
            k4: bool, what: str) -> CandLists:
    cand = with_lists(cand)
    lists = cand.lists
    lib = build.load()
    dev = operand.device
    words = lib.mused_cand_scratch_words(int(k4), cand.slabs.shape[0], cand.block, cand.nbins,
                                         cand.groups, r, int(cand.uid_rows is not None))
    scratch = torch.empty((words,), dtype=torch.float32, device=dev) if words else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*_cand_args(cand), lists.workspace.data_ptr(), operand.data_ptr(), r,
                  out.data_ptr(), None if scratch is None else scratch.data_ptr(), stream)
    build.check(code, f"{what} block={cand.block} nbins={cand.nbins} "
                      f"groups={cand.groups} r={r}")
    return lists


def matvec_t(cand: CandBlock, x_t: torch.Tensor):
    """rows^T @ x for the implicit fused rows (K4): x_t is x pre-transposed,
    (r, block) bf16.  Returns (out_t (r, n) f32, edges () f32), edges the
    exact fused edge count (exact in f32 below 2**24 edges per block).  A
    block without lists gets them built first (one list launch)."""
    check_cand(cand, x_t, "x_t")
    if x_t.shape[1] != cand.block:
        raise ValueError(f"x_t must be (r, {cand.block}), got {tuple(x_t.shape)}")
    if x_t.device.type == "cpu":
        return matvec_t_reference(cand, x_t)
    r = x_t.shape[0]
    out_t = torch.empty((r, cand.groups * cand.nbins), dtype=torch.float32, device=x_t.device)
    lists = _launch(build.load().mused_cand_matvec_t, cand, x_t, r, out_t, True,
                    "cand_matvec_t")
    global launches_t
    launches_t += 1
    return out_t, lists.edges[0].float()


def matvec(cand: CandBlock, y: torch.Tensor) -> torch.Tensor:
    """rows @ y for the implicit fused rows (K5): y (n, r) bf16 -> (block, r)
    f32, any r.  A block without lists gets them built first."""
    check_cand(cand, y, "y")
    n = cand.groups * cand.nbins
    if y.shape[0] != n:
        raise ValueError(f"y must be ({n}, r), got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return matvec_reference(cand, y)
    r = y.shape[1]
    out = torch.empty((cand.block, r), dtype=torch.float32, device=y.device)
    _launch(build.load().mused_cand_matvec, cand, y, r, out, False, "cand_matvec")
    global launches
    launches += 1
    return out
