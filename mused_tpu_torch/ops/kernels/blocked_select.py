"""Stride-binned kNN candidates: the hand-written Hopper kernels K2 / K3 and
their plain versions.

Replaces the TPU kernels ``mused_tpu/ops/pallas/blocked_select.py:
binned_candidates_pallas`` (K2) and ``binned_candidates_pair_pallas`` (K3).
The CUDA source is ``mused_tpu_torch/csrc/blocked_select.cu`` (its header
note gives the design and what bounds it on an H100).

For rows [start, start+block) of an n-column window, the similarity against
every column is masked (invalid and self columns rank at -1e30) and
max-accumulated into ``nbins`` residue bins: column c = g * nbins + slot
lands in bin ``slot``, and the bin keeps the largest value and its group id
``g``; on equal values the lowest group wins.  Only the (block, nbins)
candidates leave the kernel, never the (block, n) similarity strip.

Metrics and the operand types the kernels take:
  dot      bf16 panels (pre-scaled / normalized text rows, embeddings)
  jaccard  int8 count panels with hoisted f32 row sums (tags)
  chord    bf16 panels with hoisted squared norms (generic ``default_safe``)
  chord3   f32 unit-xyz panels, (n, >= 3) (location)
  l1       f32 time panels, (n, >= 2)

The row side is given whole: ``rows`` (block, K) and, for jaccard / chord,
``row_stats`` (block,) need not be slices of the column panel.  ``start`` is
the rows' global index and is read only by the self-column test, so it may
be negative or past n: a column-sharded sweep (``parallel/colsharded``)
hands a shard the row block of another shard with the shard-local offset.
Without ``row_stats`` the rows must be the slice [start, start+block) of
the panel, and their statistics are sliced from ``row_sums``.

K3 (:func:`binned_candidates_pair`) takes any two metrics: two coordinate
metrics share the coordinate kernel's sweep, two tensor-core metrics run
K2's tile program per half in one launch, and a mixed pair runs a simple
kernel (:func:`pair_route`).

The postings route.  The text and tags panels hold 1-5 nonzeros per row in
4096 / 2048 features, so their dense products are almost all zeros.  A
:class:`Postings` layout of the column panel (:func:`build_postings`: for
each feature, the panel's columns that hold it, in ascending order, with
their values) lets K2 add each row's similarity over its terms' postings
instead.  A caller that hands K2 / K3 ``postings`` (dot and jaccard only,
``nbins`` a multiple of 128, :func:`takes_postings`) gets that kernel; the
route follows from the operands alone (:func:`route`).  The row side stays
the dense ``rows``: the kernel reads each row's nonzero features from it.
On CPU tensors the postings are checked against the panel's shape and the
dense plain version runs.  :func:`binned_candidates_postings_plain` is the
plain version of the postings route, in the kernel's summation order.

``binned_candidates`` / ``binned_candidates_pair`` launch the kernels for
CUDA tensors and raise on anything they do not take; for tensors on the CPU
they run :func:`binned_candidates_plain`, the same function in plain
PyTorch (similarity strip, then :func:`binned_candidates_reference`).

The union kernel (:func:`union_rowblock`) writes the (block, n) fused
adjacency rows of a candidate block (``cand_matvec.CandBlock``: the kept
candidates as int8 slabs, and the username operands) once, in the dtype
its consumer reads, for any number of slabs (past ``UNION_MAX_PLANES``, one
launch per group of slabs, OR-ed); its plain version,
``cand_matvec.dense_rows_reference``, writes the blocks of CPU slabs.
:func:`union_blocks_written` counts the blocks the kernel wrote on the
calling thread.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from mused_tpu_torch.ops.kernels import build
from mused_tpu_torch.ops.kernels import cand_matvec as cm

NEG = -1e30
METRICS = ("dot", "jaccard", "chord", "chord3", "l1")
MMA_METRICS = ("dot", "jaccard", "chord")       # tensor-core tiles
COORD_METRICS = ("chord3", "l1")                # coordinate kernel
STAT_METRICS = ("jaccard", "chord")             # take hoisted row statistics
_DTYPE = {"dot": torch.bfloat16, "chord": torch.bfloat16, "jaccard": torch.int8,
          "chord3": torch.float32, "l1": torch.float32}
_MIN_K = {"chord3": 3, "l1": 2}

POSTINGS_METRICS = ("dot", "jaccard")         # the postings route's metrics
POSTINGS_UNIT = 128            # columns per step of a postings table
POSTINGS_MAX_NBINS = 16_384    # the kernel keeps a row's nbins bins in shared memory

launches = 0        # K2 launches so far, every route (plain-version calls not counted)
pair_launches = 0   # K3 launches so far, every route
postings_launches = 0        # of them, K2 launches on the postings route
postings_pair_launches = 0   # and K3 launches on it
union_launches = 0  # union kernel launches so far
_union_written = threading.local()   # .blocks: row blocks the union kernel wrote

UNION_DTYPES = (torch.bool, torch.bfloat16, torch.float32)   # the union kernel's outputs
UNION_MAX_PLANES = 8    # candidate slabs the union kernel holds in registers


def reset_launches() -> None:
    global launches, pair_launches, postings_launches, postings_pair_launches, union_launches
    launches = pair_launches = postings_launches = postings_pair_launches = 0
    union_launches = 0


def route(metric: str, postings=None) -> str:
    """K2's kernel for a metric: "postings" when the caller hands the column
    panel's postings, else "coordinate" (chord3 / l1) or "mma" (the
    tensor-core tiles)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}: expected one of {METRICS}")
    if postings is not None:
        return "postings"
    return "coordinate" if metric in COORD_METRICS else "mma"


def pair_route(metricA: str, metricB: str, postings: bool = False) -> str:
    """K3's kernel for a pair: "postings" (both halves hand their postings),
    "coordinate" (chord3 / l1 both), "mma" (two tensor-core metrics) or
    "simple" (one of each)."""
    for m in (metricA, metricB):
        if m not in METRICS:
            raise ValueError(f"unknown metric {m!r}: expected one of {METRICS}")
    if postings:
        return "postings"
    if metricA in COORD_METRICS and metricB in COORD_METRICS:
        return "coordinate"
    if metricA in MMA_METRICS and metricB in MMA_METRICS:
        return "mma"
    return "simple"


def takes_postings(nbins: int) -> bool:
    """Whether the postings route takes this bin count: whole 128-column
    steps of the postings table per group, and a row's bins in shared
    memory.  Callers hand K2 / K3 postings only then."""
    return 0 < nbins <= POSTINGS_MAX_NBINS and nbins % POSTINGS_UNIT == 0


# ---------------------------------------------------------------------------
# the postings layout of a sparse column panel
# ---------------------------------------------------------------------------

class Postings(NamedTuple):
    """The postings of an (n, K) column panel: for each feature t, the
    panel's columns that hold it, in ascending order, with their values.

    ``cols`` / ``vals`` hold the entries sorted by (feature, column); their
    capacity is fixed when the layout is built (the token arrays' size), and
    the entries past ``table[-1, -1]`` are padding.  ``table[t, u]`` is the
    index of feature t's first entry at a column >= u * POSTINGS_UNIT
    (u = 0 .. ceil(n / POSTINGS_UNIT)), so feature t's entries in any range
    of whole 128-column steps are one contiguous slice, found without a
    search."""

    table: torch.Tensor    # (K, ceil(n / 128) + 1) int32
    cols: torch.Tensor     # (capacity,) int32: the column of each entry
    vals: torch.Tensor     # (capacity,) the panel's type: the panel's value there
    n: int

    @property
    def k(self) -> int:
        return self.table.shape[0]

    @property
    def entries(self) -> torch.Tensor:
        """(1,) int32 on the layout's device: the live entries (no host read)."""
        return self.table[-1, -1:]


def build_postings(panel: torch.Tensor, ids: torch.Tensor | None = None) -> Postings:
    """The postings of ``panel`` (n, K), built with no host read.

    ``ids`` (n, T) are each row's feature ids (-1 padding), a superset of its
    nonzero features: the featurizer's token ids, so the capacity is n * T
    (T is at most the token cap).  Without ``ids`` every feature of every row
    is a candidate (capacity n * K).  Duplicate ids and features whose panel
    value is 0 hold no entry.  Sorted by (feature, column) in one sort of
    int64 keys; the table is one ``searchsorted``."""
    if panel.ndim != 2:
        raise ValueError(f"the panel must be 2-D, got {tuple(panel.shape)}")
    n, k = panel.shape
    dev = panel.device
    if ids is None:
        feats = torch.arange(k, device=dev).expand(n, k)
    else:
        if ids.ndim != 2 or ids.shape[0] != n:
            raise ValueError(f"ids must be ({n}, T), got {tuple(ids.shape)}")
        feats = torch.sort(torch.where(ids >= 0, ids.long(), k), dim=1).values
        feats = torch.where(feats < k, feats, k)
        dup = torch.zeros_like(feats, dtype=torch.bool)
        dup[:, 1:] = feats[:, 1:] == feats[:, :-1]
        feats = torch.where(dup, k, feats)
    safe = torch.clamp(feats, max=k - 1)
    live = (feats < k) & (panel.gather(1, safe) != 0)
    rows = torch.arange(n, device=dev)[:, None]
    keys = torch.where(live, feats * n + rows, k * n + rows).reshape(-1)
    keys = torch.sort(keys).values
    cols = torch.remainder(keys, n)
    feat = torch.div(keys, n, rounding_mode="floor")
    vals = panel[cols, torch.clamp(feat, max=k - 1)]
    vals = torch.where(feat < k, vals, torch.zeros_like(vals))
    steps = -(-n // POSTINGS_UNIT)
    units = torch.clamp(torch.arange(steps + 1, device=dev) * POSTINGS_UNIT, max=n)
    query = torch.arange(k, device=dev)[:, None] * n + units[None, :]
    table = torch.searchsorted(keys, query).to(torch.int32)
    return Postings(table=table.contiguous(), cols=cols.to(torch.int32).contiguous(),
                    vals=vals.contiguous(), n=n)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _row_side_stats(metric, row_sums, row_stats, start: int, block: int):
    """(block,) row statistics: ``row_stats`` when given, else the slice of
    ``row_sums``, which exists only when the rows are the panel's slice
    [start, start+block) (a Python slice past either end would quietly
    return other rows or fewer)."""
    if row_stats is not None:
        return row_stats
    if start < 0 or start + block > row_sums.shape[0]:
        raise ValueError(
            f"rows [{start}, {start + block}) are not a slice of the {row_sums.shape[0]}-row "
            f"panel: {metric} needs their statistics as row_stats")
    return row_sums[start:start + block]


def _row_stats(metric, row_sums, start: int, block: int, row_stats=None):
    """(s_r (block, 1), s_c (1, n)) f32 hoisted statistics, or (None, None)."""
    if metric not in STAT_METRICS:
        return None, None
    if row_sums is None:
        raise ValueError(f"metric {metric!r} needs row_sums (hoisted column statistics)")
    s_r = _row_side_stats(metric, row_sums, row_stats, start, block)
    return s_r.float().reshape(block, 1), row_sums.float().reshape(1, -1)


def sim_strip(cols: torch.Tensor, rows: torch.Tensor, metric: str, s_r=None,
              s_c=None) -> torch.Tensor:
    """(block, n) f32 similarity of ``rows`` against ``cols`` (the kernel's
    tile formula; the unfused sums of chord3 / l1 run in the JAX package's
    order, so they agree bit for bit).  bf16 and int8 operands are upcast
    to f32 before the product: bf16 products and small-int counts are exact
    in f32, and torch's own bf16 product would round its result."""
    if metric in ("dot", "chord", "jaccard"):
        dot = rows.float() @ cols.float().T
        if metric == "dot":
            return dot
        if metric == "jaccard":
            return dot / torch.clamp(s_r + s_c - dot, min=1e-9)
        return -torch.clamp(s_r + s_c - 2.0 * dot, min=0.0)
    if metric in ("chord3", "l1"):
        acc = None
        for c in range(_MIN_K[metric]):
            d = rows[:, c, None] - cols[None, :, c]
            term = d * d if metric == "chord3" else torch.abs(d)
            acc = term if acc is None else acc + term
        return -acc
    raise ValueError(f"unknown metric {metric!r}: expected one of {METRICS}")


def binned_candidates_reference(sim: torch.Tensor, col_valid: torch.Tensor, start: int,
                                nbins: int):
    """Candidates of a materialized (block, n) similarity strip: mask, then
    max / first-argmax over the groups of each residue bin.  Returns
    (vals (block, nbins) f32, grp (block, nbins) int8)."""
    block, n = sim.shape
    cols = torch.arange(n, device=sim.device)
    rows = start + torch.arange(block, device=sim.device)
    keep = col_valid.to(torch.bool)[None, :] & (rows[:, None] != cols[None, :])
    s = torch.where(keep, sim, NEG).reshape(block, n // nbins, nbins)
    # torch.argmax returns the first maximal index: the lowest group wins
    return torch.amax(s, dim=1), torch.argmax(s, dim=1).to(torch.int8)


def binned_candidates_plain(cols, rows, col_valid, start: int, *, metric: str,
                            nbins: int, block: int, row_sums=None, row_stats=None):
    """Plain PyTorch version of K2: similarity strip + reference binning."""
    s_r, s_c = _row_stats(metric, row_sums, start, block, row_stats)
    return binned_candidates_reference(sim_strip(cols, rows, metric, s_r, s_c),
                                       col_valid, start, nbins)


def postings_sim_strip(post: Postings, rows: torch.Tensor, metric: str, s_r=None,
                       s_c=None) -> torch.Tensor:
    """(block, n) f32 similarity of ``rows`` against the panel through its
    postings, in the postings kernel's order: each row adds its nonzero
    features' products in ascending feature order, one rounding per step (a
    bf16 or int8 product is exact in f32, so ``acc + r * v`` is the kernel's
    ``fmaf``).  Pairs that share no feature stay 0."""
    block = rows.shape[0]
    rv = rows.float()
    acc = torch.zeros((block, post.n), dtype=torch.float32, device=rows.device)
    table = post.table.long()
    for f in torch.nonzero(torch.any(rv != 0, dim=0)).flatten().tolist():
        lo, hi = int(table[f, 0]), int(table[f, -1])
        if lo == hi:
            continue
        c = post.cols[lo:hi].long()
        r = torch.nonzero(rv[:, f] != 0).flatten()
        acc[r[:, None], c[None, :]] += rv[r, f][:, None] * post.vals[lo:hi].float()[None, :]
    if metric == "dot":
        return acc
    if metric == "jaccard":
        return acc / torch.clamp(s_r + s_c - acc, min=1e-9)
    raise ValueError(f"the postings route takes {POSTINGS_METRICS}, not {metric!r}")


def binned_candidates_postings_plain(post: Postings, rows, col_valid, start: int, *,
                                     metric: str, nbins: int, block: int, row_sums=None,
                                     row_stats=None):
    """Plain PyTorch version of K2's postings route: the similarity strip
    through the postings (:func:`postings_sim_strip`), then the reference
    binning.  Bit-equal to the kernel; to :func:`binned_candidates_plain`
    within f32 reassociation for dot (bit-equal on integer-valued operands)
    and bit-equal for jaccard."""
    s_r, s_c = _row_stats(metric, row_sums, start, block, row_stats)
    return binned_candidates_reference(postings_sim_strip(post, rows, metric, s_r, s_c),
                                       col_valid, start, nbins)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(cols, rows, col_valid, metric, nbins, block, row_sums, row_stats=None) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}: expected one of {METRICS}")
    want = _DTYPE[metric]
    if cols.ndim != 2 or rows.ndim != 2 or cols.dtype != want or rows.dtype != want:
        raise TypeError(f"{metric} takes 2-D {want} cols and rows, got cols "
                        f"{cols.dtype} {tuple(cols.shape)}, rows {rows.dtype} "
                        f"{tuple(rows.shape)}")
    n, k = cols.shape
    if rows.shape != (block, k):
        raise ValueError(f"rows must be ({block}, {k}), got {tuple(rows.shape)}")
    if k < _MIN_K.get(metric, 1):
        raise ValueError(f"{metric} needs >= {_MIN_K[metric]} features, got {k}")
    if col_valid.shape != (n,) or col_valid.dtype != torch.bool:
        raise TypeError(f"col_valid must be a ({n},) bool tensor, got "
                        f"{col_valid.dtype} {tuple(col_valid.shape)}")
    if nbins <= 0 or n % nbins or n // nbins > 127:
        raise ValueError(f"nbins={nbins} must divide n={n} into <= 127 groups "
                         "(int8 group ids)")
    tensors = [cols, rows, col_valid]
    if metric in STAT_METRICS:
        if row_sums is None or row_sums.shape != (n,) or row_sums.dtype != torch.float32:
            raise TypeError(f"{metric} needs ({n},) float32 row_sums")
        tensors.append(row_sums)
        if row_stats is not None:
            if row_stats.shape != (block,) or row_stats.dtype != torch.float32:
                raise TypeError(f"row_stats must be a ({block},) float32 tensor, got "
                                f"{row_stats.dtype} {tuple(row_stats.shape)}")
            tensors.append(row_stats)
    if any(t.device != cols.device for t in tensors):
        raise ValueError("cols, rows, col_valid and row statistics must share a device")


def _check_postings(post, cols: torch.Tensor, metric: str, nbins: int) -> None:
    """The postings route takes ``post`` for this panel, metric and nbins."""
    if not isinstance(post, Postings):
        raise TypeError(f"postings must be a Postings layout, got {type(post).__name__}")
    if metric not in POSTINGS_METRICS:
        raise ValueError(f"the postings route takes {POSTINGS_METRICS}, not {metric!r}")
    if not takes_postings(nbins):
        raise ValueError(f"the postings route takes nbins a multiple of {POSTINGS_UNIT} up "
                         f"to {POSTINGS_MAX_NBINS}, got {nbins} (check takes_postings)")
    n, k = cols.shape
    steps = -(-n // POSTINGS_UNIT)
    if (post.n != n or post.table.shape != (k, steps + 1) or post.table.dtype != torch.int32
            or post.cols.dtype != torch.int32 or post.vals.dtype != cols.dtype
            or post.cols.shape != post.vals.shape or post.cols.ndim != 1):
        raise ValueError(f"postings of an ({post.n}, {post.k}) {post.vals.dtype} panel "
                         f"(table {tuple(post.table.shape)}) do not fit the ({n}, {k}) "
                         f"{cols.dtype} panel")
    if any(t.device != cols.device for t in (post.table, post.cols, post.vals)):
        raise ValueError("the postings and the panel must share a device")


def _check_cuda(tensors, metric: str) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if metric in MMA_METRICS:
        kbytes = tensors[0].shape[1] * tensors[0].element_size()
        if kbytes % 64 or any(t.data_ptr() % 16 for t in tensors[:2]):
            raise ValueError(f"{metric} panels need a feature width of a multiple of "
                             f"64 bytes and 16-byte aligned rows (pad to 128 "
                             f"features: pad_features_128), got {kbytes} bytes")


def _stats_for_kernel(metric, row_sums, row_stats, start, block):
    """(s_r, s_c) contiguous for jaccard / chord; (None, None) for the other
    metrics, whose kernels read neither (null pointers: no tensor, no fill)."""
    if metric not in STAT_METRICS:
        return None, None
    s_r = _row_side_stats(metric, row_sums, row_stats, start, block)
    return s_r.contiguous(), row_sums.contiguous()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _postings_half(post: Postings, rows, col_valid, s_r, s_c, metric: str) -> list:
    """The postings kernel's operands of one half, in the C entry point's
    order (rows, table, cols, vals, colv, s_r, s_c), checked contiguous."""
    tensors = [rows, post.table, post.cols, post.vals, col_valid]
    if not all(t.is_contiguous() for t in tensors + [x for x in (s_r, s_c) if x is not None]):
        raise ValueError("the postings kernel takes contiguous tensors")
    return [t.data_ptr() for t in tensors] + [_ptr(s_r), _ptr(s_c)]


def binned_candidates(cols: torch.Tensor, rows: torch.Tensor, col_valid: torch.Tensor,
                      start: int, *, metric: str, nbins: int, block: int,
                      row_sums: torch.Tensor | None = None,
                      row_stats: torch.Tensor | None = None,
                      postings: Postings | None = None):
    """Stride-binned kNN candidates of ``rows`` against the column panel (K2).

    cols: (n, K) column panel; rows: (block, K); col_valid: (n,) bool;
    ``start``: the rows' global index, for the self-column test only (any
    int).  ``row_sums`` are the (n,) hoisted column statistics of jaccard /
    chord (token sums, squared norms); ``row_stats`` the rows' own (block,),
    else sliced from ``row_sums`` (then the rows must be the panel's slice
    [start, start+block)).  Returns (vals (block, nbins) f32, grp (block,
    nbins) int8); column = grp * nbins + slot.  ``postings`` (the panel's
    :class:`Postings`, dot / jaccard, :func:`takes_postings`) select the
    postings route.  CUDA tensors run the kernel, CPU tensors the plain
    version."""
    start = int(start)
    _check(cols, rows, col_valid, metric, nbins, block, row_sums, row_stats)
    if postings is not None:
        _check_postings(postings, cols, metric, nbins)
    if cols.device.type == "cpu":
        return binned_candidates_plain(cols, rows, col_valid, start, metric=metric,
                                       nbins=nbins, block=block, row_sums=row_sums,
                                       row_stats=row_stats)
    if cols.device.type != "cuda":
        raise ValueError(f"binned_candidates runs on cuda or cpu tensors, not {cols.device}")
    s_r, s_c = _stats_for_kernel(metric, row_sums, row_stats, start, block)
    n, k = cols.shape
    vals = torch.empty((block, nbins), dtype=torch.float32, device=cols.device)
    grp = torch.empty((block, nbins), dtype=torch.int8, device=cols.device)
    if postings is not None:
        return _launch_postings(postings, rows, col_valid, s_r, s_c, vals, grp, n, block, k,
                                nbins, start, metric)
    _check_cuda([t for t in (cols, rows, col_valid, s_r, s_c) if t is not None], metric)
    lib = build.load()
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        code = lib.mused_binned_candidates(
            cols.data_ptr(), rows.data_ptr(), col_valid.data_ptr(), _ptr(s_r),
            _ptr(s_c), vals.data_ptr(), grp.data_ptr(), n, block, k, nbins, start,
            METRICS.index(metric), stream)
    build.check(code, f"binned_candidates[{metric}] n={n} block={block} K={k} "
                      f"nbins={nbins}")
    global launches
    launches += 1
    return vals, grp


def _launch_postings(post, rows, col_valid, s_r, s_c, vals, grp, n, block, k, nbins, start,
                     metric):
    half = _postings_half(post, rows, col_valid, s_r, s_c, metric)
    lib = build.load()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        code = lib.mused_binned_postings(*half, vals.data_ptr(), grp.data_ptr(), n, block, k,
                                         nbins, start, METRICS.index(metric), stream)
    build.check(code, f"binned_candidates[{metric}, postings] n={n} block={block} K={k} "
                      f"nbins={nbins}")
    global launches, postings_launches
    launches += 1
    postings_launches += 1
    return vals, grp


def kernel_splits(n: int, block: int, nbins: int, metric: str) -> int:
    """Group-range splits (CTAs per cluster sharing one output tile) the K2
    kernel takes at this shape on the current CUDA device; 1 for the
    coordinate metrics."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}: expected one of {METRICS}")
    splits = build.load().mused_binned_candidates_splits(n, block, nbins,
                                                         METRICS.index(metric))
    if splits <= 0:
        raise ValueError(f"no K2 launch at n={n} block={block} nbins={nbins}")
    return splits


def binned_candidates_pair(colsA, colsB, rowsA, rowsB, colvA, colvB, start: int, *,
                           metricA: str, metricB: str, nbins: int, block: int,
                           row_sumsA=None, row_statsA=None, row_sumsB=None,
                           row_statsB=None, postingsA=None, postingsB=None):
    """Candidates of TWO metrics over the same rows in one launch (K3): each
    half takes :func:`binned_candidates`' operands (``row_sums{A,B}``,
    ``row_stats{A,B}``, ``postings{A,B}``) and its output is identical to
    that call's.  The single-device sweep pairs location chord3 + time l1;
    the column-sharded sweep pairs consecutive modalities (tags jaccard +
    text dot on standard streams, both with their postings).  Both halves
    hand postings, or neither.  Returns (valsA, grpA, valsB, grpB)."""
    start = int(start)
    if (postingsA is None) != (postingsB is None):
        raise ValueError("the pair's halves hand their postings both or neither")
    pair_route(metricA, metricB)          # raises on an unknown metric
    _check(colsA, rowsA, colvA, metricA, nbins, block, row_sumsA, row_statsA)
    _check(colsB, rowsB, colvB, metricB, nbins, block, row_sumsB, row_statsB)
    if colsA.shape[0] != colsB.shape[0] or colsA.device != colsB.device:
        raise ValueError("the pair's panels need the same rows and device, got "
                         f"{tuple(colsA.shape)} on {colsA.device} and "
                         f"{tuple(colsB.shape)} on {colsB.device}")
    if postingsA is not None:
        _check_postings(postingsA, colsA, metricA, nbins)
        _check_postings(postingsB, colsB, metricB, nbins)
    if colsA.device.type == "cpu":
        return (*binned_candidates_plain(colsA, rowsA, colvA, start, metric=metricA,
                                         nbins=nbins, block=block, row_sums=row_sumsA,
                                         row_stats=row_statsA),
                *binned_candidates_plain(colsB, rowsB, colvB, start, metric=metricB,
                                         nbins=nbins, block=block, row_sums=row_sumsB,
                                         row_stats=row_statsB))
    if colsA.device.type != "cuda":
        raise ValueError(f"binned_candidates_pair runs on cuda or cpu tensors, "
                         f"not {colsA.device}")
    dev = colsA.device
    srA, scA = _stats_for_kernel(metricA, row_sumsA, row_statsA, start, block)
    srB, scB = _stats_for_kernel(metricB, row_sumsB, row_statsB, start, block)
    n = colsA.shape[0]
    if postingsA is not None:
        return _launch_postings_pair(postingsA, postingsB, rowsA, rowsB, colvA, colvB,
                                     (srA, scA), (srB, scB), metricA, metricB, n, block,
                                     nbins, start)
    _check_cuda([t for t in (colsA, rowsA, colvA, srA, scA) if t is not None], metricA)
    _check_cuda([t for t in (colsB, rowsB, colvB, srB, scB) if t is not None], metricB)
    outs = [torch.empty((block, nbins), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int8, torch.float32, torch.int8)]
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mused_binned_candidates_pair(
            colsA.data_ptr(), rowsA.data_ptr(), colvA.data_ptr(), _ptr(srA), _ptr(scA),
            colsA.shape[1], METRICS.index(metricA), colsB.data_ptr(), rowsB.data_ptr(),
            colvB.data_ptr(), _ptr(srB), _ptr(scB),
            colsB.shape[1], METRICS.index(metricB), *(o.data_ptr() for o in outs),
            n, block, nbins, start, stream)
    build.check(code, f"binned_candidates_pair[{metricA},{metricB}] n={n} "
                      f"block={block} nbins={nbins}")
    global pair_launches
    pair_launches += 1
    return tuple(outs)


def _launch_postings_pair(postA, postB, rowsA, rowsB, colvA, colvB, statsA, statsB,
                          metricA, metricB, n, block, nbins, start):
    """K3 on the postings route: one launch, grid z picks the half."""
    dev = rowsA.device
    outs = [torch.empty((block, nbins), dtype=dt, device=dev)
            for dt in (torch.float32, torch.int8, torch.float32, torch.int8)]
    halfA = _postings_half(postA, rowsA, colvA, *statsA, metricA)
    halfB = _postings_half(postB, rowsB, colvB, *statsB, metricB)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mused_binned_postings_pair(
            *halfA, rowsA.shape[1], METRICS.index(metricA), *halfB, rowsB.shape[1],
            METRICS.index(metricB), *(o.data_ptr() for o in outs), n, block, nbins, start,
            stream)
    build.check(code, f"binned_candidates_pair[{metricA},{metricB}, postings] n={n} "
                      f"block={block} nbins={nbins}")
    global pair_launches, postings_pair_launches
    pair_launches += 1
    postings_pair_launches += 1
    return tuple(outs)


def pair_splits(n: int, block: int, nbins: int) -> int:
    """Group-range splits the tensor-core K3 takes at this shape on the
    current CUDA device."""
    splits = build.load().mused_binned_candidates_pair_splits(n, block, nbins)
    if splits <= 0:
        raise ValueError(f"no K3 launch at n={n} block={block} nbins={nbins}")
    return splits


# ---------------------------------------------------------------------------
# candidates -> adjacency, and sizing
# ---------------------------------------------------------------------------

def budgeted_keep(vals: torch.Tensor, row_valid: torch.Tensor, k: int) -> torch.Tensor:
    """Exact-k candidate mask: the k-th candidate value thresholds the bins,
    and ties at the threshold are admitted in slot order up to the
    remaining budget (at nbins == n this is lax.top_k's lowest-index rule).
    Only the top-k VALUES are read, so torch.topk's tie order is moot."""
    kk = min(k, vals.shape[1])
    thr = torch.topk(vals, kk, dim=1).values[:, -1:]
    real = vals > NEG / 2
    above = (vals > thr) & real
    tie = (vals == thr) & real
    budget = kk - torch.sum(above, dim=1, keepdim=True, dtype=torch.int32)
    order = torch.cumsum(tie.to(torch.int32), dim=1)
    keep = above | (tie & (order <= budget))
    return keep & row_valid[:, None]


def union_rowblock(cand, out_dtype=torch.float32) -> torch.Tensor:
    """(block, n) fused adjacency rows of any ``cand_matvec.CandBlock``,
    written once in ``out_dtype`` (bool, bf16 or f32): by the union kernel
    for CUDA slabs (more than ``UNION_MAX_PLANES`` slabs: one launch per
    group of them into bool rows, the username term in the first, OR-ed and
    cast once), by the plain version ``dense_rows_reference`` for CPU
    slabs.  Element (r, g * nbins + s) is 1 where some slab keeps group g
    at (r, s), or where the row's uid equals the column's off the row's own
    column.  Raises on an output dtype or a block it cannot write."""
    if out_dtype not in UNION_DTYPES:
        raise TypeError(f"the union kernel writes {UNION_DTYPES}, not {out_dtype}")
    cm.check_cand(cand)
    if cand.slabs.device.type == "cpu":
        return cm.dense_rows_reference(cand).to(out_dtype)
    if cand.slabs.device.type != "cuda":
        raise ValueError(f"union_rowblock runs on cuda or cpu tensors, not "
                         f"{cand.slabs.device}")
    planes = cand.slabs.shape[0]
    if planes <= UNION_MAX_PLANES:
        out = _launch_union(cand, cand.slabs, cand.uid_rows, out_dtype)
    else:
        out = _launch_union(cand, cand.slabs[:UNION_MAX_PLANES], cand.uid_rows, torch.bool)
        for p in range(UNION_MAX_PLANES, planes, UNION_MAX_PLANES):
            out |= _launch_union(cand, cand.slabs[p:p + UNION_MAX_PLANES], None, torch.bool)
        out = out.to(out_dtype)
    _union_written.blocks = union_blocks_written() + 1
    return out


def _launch_union(cand, slabs, uid_rows, out_dtype) -> torch.Tensor:
    """One union kernel launch over 1 to ``UNION_MAX_PLANES`` of ``cand``'s
    slabs (``uid_rows`` None: no username term)."""
    dev = slabs.device
    out = torch.empty((cand.block, cand.groups * cand.nbins), dtype=out_dtype, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mused_union_rowblock(
            slabs.data_ptr(), _ptr(uid_rows), cand.uid_cols.data_ptr(), out.data_ptr(),
            slabs.shape[0], cand.block, cand.nbins, cand.groups, int(cand.start),
            int(cand.g0), UNION_DTYPES.index(out_dtype), stream)
    build.check(code, f"union_rowblock block={cand.block} nbins={cand.nbins} "
                      f"groups={cand.groups} planes={slabs.shape[0]}")
    global union_launches
    union_launches += 1
    return out


def union_blocks_written() -> int:
    """Row blocks the union kernel has written on the calling thread so far:
    one per :func:`union_rowblock` call on CUDA slabs, whatever its
    launches (a sweep's own count, untouched by other threads' sweeps)."""
    return getattr(_union_written, "blocks", 0)


def pad_features_128(x: torch.Tensor) -> torch.Tensor:
    """Pad the feature axis to a multiple of 128 with zeros (they vanish in
    dot / chord)."""
    pad = (-x.shape[1]) % 128
    return x if pad == 0 else torch.nn.functional.pad(x, (0, pad))


def resolve_select(cfg, n: int, device) -> tuple[str, int]:
    """(select, nbins) for an n-column blocked sweep from
    ``cfg.huge_window_fused_select``: None = binned on a CUDA device, strip
    elsewhere (the plain binning saves nothing on a CPU); True / False force
    the binned / strip route."""
    fuse_sel = cfg.huge_window_fused_select
    if fuse_sel is None:
        fuse_sel = torch.device(device).type == "cuda"
    nbins = default_nbins(n, k_max=3 * cfg.k_basis) if fuse_sel else 0
    return ("binned" if nbins else "strip"), nbins


def pick_tn(n: int, nbins: int) -> int:
    """Column-tile width dividing both nbins and n (the JAX package's rule;
    the binned route's eligibility follows from it)."""
    for tn in (512, 256, 128):
        if nbins % tn == 0 and n % tn == 0:
            return tn
    return nbins


def default_nbins(n: int, tn: int = 512, target_reduction: int = 64,
                  k_max: int = 0) -> int:
    """nbins = n / g with g | (n // tn), g <= target_reduction, and at least
    ~8 * k_max bins when feasible (0: n % tn, the strip route).  1536 at
    n = 98,304 with k_max = 150."""
    if n % tn != 0:
        return 0
    groups = n // tn
    g = 1
    for cand in range(min(target_reduction, groups), 0, -1):
        if groups % cand == 0:
            g = cand
            break
    nbins = n // g
    while k_max and nbins < 8 * k_max and g > 1:
        g //= 2
        while groups % g != 0:
            g -= 1
        nbins = n // g
    return nbins
