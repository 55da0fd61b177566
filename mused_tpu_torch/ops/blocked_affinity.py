"""Rematerialized row-block affinity for huge windows — port of
``mused_tpu/ops/blocked_affinity.py``.

A window too large to hold its (n, n) fused adjacency (BASELINE.md #3:
100k-row windows) is consumed by reductions that only need products with
it: the FD fold (SWFDMC), the blocked randomized SVD (sSVDMC family, the
batch engine) and blocked spectral clustering (``ops/blocked_spectral``).
Each sweep rebuilds (block, n) row blocks from per-window column panels
(:class:`Columns`, built once per window) in a Python loop over blocks
(:func:`scan_blocks`, the counterpart of the JAX package's ``lax.scan``).

Two routes build a block's kNN candidates per modality:

  strip   the (block, n) similarity strip + exact top-k
          (``affinity.knn_adjacency_block``);
  binned  the stride-binned candidate kernels K2 / K3
          (``ops/kernels/blocked_select``) + ``budgeted_keep``; the strip
          never exists.  On CPU tensors the kernels' wrappers run their
          plain versions.

The binned route packs a block's kept candidates as a candidate-form block
(:func:`candidate_rowblock`: int8 slabs + username uids).  The FD fold takes
its products straight off the slabs (K4 / K5, ``ops/kernels/cand_matvec``
via ``fd.shrink_rr_cands``); every other consumer takes the dense (block, n)
rows that ``blocked_select.union_rowblock`` writes from it once, in the
consumer's dtype (:func:`fused_rowblock`).  The modalities the candidate
form cannot hold take their similarity strips, OR-ed into those rows.  Each
sweep counts the blocks the union kernel wrote (counter
``blocked.union_blocks``; 0 on the CPU).

The tags and text panels carry their postings (``Columns.postings``, built
once per window by the column builders, or by :func:`hoist_columns` for a
panel handed in): K2 / K3 then take the postings route wherever
``blocked_select.takes_postings(nbins)``; the other kinds keep the dense
tensor-core tiles.

Column kinds are the ones the column builders emit: ``location_xyz``,
``time``, ``username``, ``tags`` (int8 counts + hoisted f32 row sums),
``text_bf16``, ``embedding_bf16`` (and the legacy ``embedding_split``, the
same dot), ``default_safe`` (bf16 + hoisted squared norms); ``hoist_columns``
turns a raw ``location`` or untupled ``tags`` into them.  The legacy
hand-assembled kinds run on the strip route only, as in the JAX package
(:func:`_legacy_strip`): ``text_split`` (bf16 [hi | lo] halves, the
three-term product), ``text`` (raw counts, idf-scaled when the columns
carry an idf, then L2-normalized), ``text_norm`` (pre-normalized rows),
``embedding_unit`` (pre-normalized f32 rows), ``embedding`` (raw rows,
normalized here) and raw ``default`` (Euclidean, masked here), which any
other kind name also takes, as in the JAX package.  The JAX
package computes ``text`` at ``Precision.HIGH`` (three bf16 passes on the
TPU, exact f32 on its CPU); the port computes it in true fp32, which is at
least as precise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mused_tpu_torch.data.features import SparseWindowFeatures
from mused_tpu_torch.ops import affinity
from mused_tpu_torch.ops.kernels import affinity_kernel as ak
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.ops.kernels import cand_matvec as cm
from mused_tpu_torch.utils import profiling
from mused_tpu_torch.utils.config import FeatureConfig


class Columns(NamedTuple):
    """Full-window device tensors for each modality."""

    kinds: tuple               # modality kind per tensor
    tensors: tuple             # (n, d) tensor, or (tensor, hoisted row stat)
    valids: tuple              # (n,) bool per modality
    idf: torch.Tensor | None   # (H_text,) for the text modality, else None
    postings: tuple | None = None   # blocked_select.Postings per modality, or None

    def postings_of(self) -> tuple:
        """The postings per modality (None where a kind has none)."""
        return self.postings or (None,) * len(self.kinds)

    @property
    def n(self) -> int:
        t = self.tensors[0]
        return (t[0] if isinstance(t, tuple) else t).shape[0]


def _unit_xyz(latlon: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(n, 2) degrees -> (n, 3) unit vectors; invalid rows at a fixed dummy
    point (masked out of every kNN anyway)."""
    return ak.location_to_unit_xyz(torch.where(valid[:, None], latlon, 0.0))


def standard_columns(wf, features_cfg=None) -> Columns:
    """Columns of the five standard modalities from a (Sparse)WindowFeatures
    whose fields are tensors on the target device.  Sparse tokens scatter to
    dense on the device.  Text is idf-scaled and L2-normalized here, once
    per window, then stored bf16; tags store int8 counts with their f32 row
    sums (exact: counts are small integers).  Both carry their postings,
    built from the token ids (capacity n x the token arrays' width; dense
    features: n x the hash width)."""
    fc = features_cfg or FeatureConfig()
    loc, tim, uid = wf.location.float(), wf.times.float(), wf.user_ids.to(torch.int32)
    if isinstance(wf, SparseWindowFeatures):
        tags = affinity.counts_from_tokens(wf.tags_ids, None, fc.tags_hash_dim)
        text = affinity.counts_from_tokens(wf.text_ids, wf.text_cnt, fc.text_hash_dim)
        tags_ids, text_ids = wf.tags_ids, wf.text_ids
    else:
        tags, text = wf.tags.float(), wf.text.float()
        tags_ids = text_ids = None
    text_valid = torch.sum(text, dim=1) > 0
    n_docs = torch.clamp(torch.sum(text_valid.float()), min=1.0)
    df = torch.sum((text > 0) & text_valid[:, None], dim=0).float()
    idf = torch.log((1.0 + n_docs) / (1.0 + df)) + 1.0
    text = text * idf[None, :]
    text = text / torch.clamp(torch.linalg.norm(text, dim=1, keepdim=True), min=1e-12)
    loc_valid = torch.all(torch.isfinite(loc), dim=1)
    tags8, text16 = tags.to(torch.int8), text.to(torch.bfloat16)
    return Columns(
        kinds=("location_xyz", "time", "username", "tags", "text_bf16"),
        tensors=(_unit_xyz(loc, loc_valid), tim, uid, (tags8, torch.sum(tags, dim=1)),
                 text16),
        valids=(loc_valid, affinity.time_valid(tim), uid >= 0,
                wf.tags_valid.to(torch.bool), text_valid),
        idf=idf,
        postings=(None, None, None, bs.build_postings(tags8, tags_ids),
                  bs.build_postings(text16, text_ids)))


def bf16_pack(x: torch.Tensor) -> torch.Tensor:
    """One bf16 tensor of f32 rows, feature width padded to a 128 multiple."""
    return bs.pad_features_128(x.to(torch.bfloat16))


def generic_columns(mats, types, device) -> Columns:
    """Columns of numeric modalities on ``device``: location -> unit xyz,
    time as is, embedding -> normalized bf16 rows, default -> masked bf16
    rows with squared norms of the packed rows (so self-distance is 0);
    any other type keeps its raw rows (a legacy kind)."""
    tensors, valids, kinds = [], [], []
    for m, t in zip(mats, types):
        m = torch.as_tensor(m, dtype=torch.float32).to(device)
        finite = torch.all(torch.isfinite(m), dim=1)
        if t == "location":
            kinds.append("location_xyz")
            valids.append(finite)
            tensors.append(_unit_xyz(m, finite))
        elif t == "time":
            kinds.append(t)
            valids.append(affinity.time_valid(m))
            tensors.append(m)
        elif t == "embedding":
            x, valid = affinity.normalized_embedding(m)
            kinds.append("embedding_bf16")
            valids.append(valid)
            tensors.append(bf16_pack(x))
        elif t == "default":
            packed = bf16_pack(torch.where(finite[:, None], m, 0.0))
            pf = packed.float()
            kinds.append("default_safe")
            valids.append(finite)
            tensors.append((packed, torch.sum(pf * pf, dim=1)))
        else:
            kinds.append(t)
            valids.append(finite)
            tensors.append(m)
    return Columns(kinds=tuple(kinds), tensors=tuple(tensors), valids=tuple(valids),
                   idf=None)


# kind -> the panel type whose postings the kind carries
_POSTINGS_DTYPE = {"tags": torch.int8, "text_bf16": torch.bfloat16}


def hoist_columns(cols: Columns) -> Columns:
    """Hoisted forms the sweeps assume: a raw ``location`` latlon panel
    becomes unit xyz, untupled ``tags`` gain their row sums, and int8 tags /
    bf16 text panels on a CUDA device without postings gain them (from the
    dense panel: capacity n x K), once per sweep rather than once per block.
    A CPU panel gets none: there the kernels' plain versions run, which read
    no postings."""
    kinds, tensors = list(cols.kinds), list(cols.tensors)
    postings = list(cols.postings_of())
    for i, (k, t, v) in enumerate(zip(kinds, tensors, cols.valids)):
        if k == "location":
            kinds[i], tensors[i] = "location_xyz", _unit_xyz(t.float(), v)
        elif k == "tags" and not isinstance(t, tuple):
            tensors[i] = (t, torch.sum(t.float(), dim=1))
        panel = tensors[i][0] if isinstance(tensors[i], tuple) else tensors[i]
        if (postings[i] is None and panel.dtype == _POSTINGS_DTYPE.get(kinds[i])
                and panel.ndim == 2 and panel.device.type == "cuda"):
            postings[i] = bs.build_postings(panel)
    return cols._replace(kinds=tuple(kinds), tensors=tuple(tensors),
                         postings=tuple(postings))


# ---------------------------------------------------------------------------
# per-modality candidates
# ---------------------------------------------------------------------------

# kind -> metric of its kNN graph
_METRIC = {"location": "chord3", "location_xyz": "chord3", "time": "l1", "tags": "jaccard",
           "text_bf16": "dot", "embedding_bf16": "dot", "embedding_split": "dot",
           "default_safe": "chord"}


LEGACY_KINDS = ("text_split", "text", "text_norm", "embedding_unit", "embedding", "default")


def _metric_k(kind: str, k_basis: int) -> tuple[str, int]:
    """(metric, k) of a modality kind: the one place the mapping lives, shared
    by the strip, binned and candidate-form blocks so all select the same
    edges.  Time takes 3 * k_basis neighbours; default counts self among
    its k_basis, as the reference does."""
    if kind not in _METRIC:
        raise ValueError(f"column kind {kind!r} has no kernel metric: expected one of "
                         f"{sorted(_METRIC)} or a legacy strip kind {LEGACY_KINDS}")
    metric = _METRIC[kind]
    return metric, {"l1": 3 * k_basis, "chord": max(1, k_basis) - 1}.get(metric, k_basis)


def _binned_ok(kind: str, t) -> bool:
    """Whether a kind has a binned route: the coordinate metrics always, the
    tensor-core metrics on panels whose width is a multiple of 128."""
    tt = t[0] if isinstance(t, tuple) else t
    return kind in _METRIC and (_METRIC[kind] in bs.COORD_METRICS or tt.shape[1] % 128 == 0)


def _legacy_strip(kind: str, t: torch.Tensor, valid: torch.Tensor, rows: slice,
                  idf: torch.Tensor | None, k_basis: int) -> tuple[torch.Tensor, int]:
    """(block, n) f32 similarity strip and k of a legacy hand-assembled kind
    (``mused_tpu/ops/blocked_affinity.py:479-555``); an unknown kind is raw
    ``default``.  bf16 operands are upcast before the product (their
    products are exact in f32)."""
    x = t.float()
    if kind == "text_split":            # hi@hi + hi@lo + lo@hi of the bf16 halves
        h = x.shape[1] // 2
        hc, lc = x[:, :h], x[:, h:]
        hr, lr = hc[rows], lc[rows]
        return hr @ hc.T + hr @ lc.T + lr @ hc.T, k_basis
    if kind in ("text", "embedding"):   # normalized here (text idf-scaled first)
        if kind == "text" and idf is not None:
            x = x * idf[None, :]
        x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
        return x[rows] @ x.T, k_basis
    if kind in ("text_norm", "embedding_unit"):     # pre-normalized rows
        return x[rows] @ x.T, k_basis
    # "default", and any other kind: Euclidean, self counted among k_basis
    return affinity.euclidean_sim(x[rows], x, valid[rows], valid), max(1, k_basis) - 1


def _cand_held(kinds, tensors) -> list[bool]:
    """Which modalities the candidate form holds: each kind with a binned
    route (:func:`_binned_ok`), and the first username panel when its uids
    are int32 (the union and K4 / K5 compare int32 uids).  The others take
    their similarity strips."""
    held, user = [], False
    for kind, t in zip(kinds, tensors):
        if kind == "username":
            held.append(not user and t.dtype == torch.int32)
            user = True
        else:
            held.append(_binned_ok(kind, t))
    return held


def _strip_adjacency(cols: Columns, i: int, start: int, block: int,
                     k_basis: int) -> torch.Tensor:
    """(block, n) bool adjacency of modality ``i`` from its similarity strip
    and exact top-k (username: uid equality off the row's own column)."""
    kind, t, valid = cols.kinds[i], cols.tensors[i], cols.valids[i]
    n = cols.n
    rows = slice(start, start + block)
    vr = valid[rows]
    if kind == "username":
        not_self = (start + torch.arange(block, device=t.device))[:, None] \
            != torch.arange(n, device=t.device)[None, :]
        return (t[rows, None] == t[None, :]) & vr[:, None] & valid[None, :] & not_self
    if kind not in _METRIC:         # a legacy kind
        sim, k = _legacy_strip(kind, t, valid, rows, cols.idf, k_basis)
    else:
        metric, k = _metric_k(kind, k_basis)
        t, stats = t if isinstance(t, tuple) else (t, None)
        s_r, s_c = (None, None) if stats is None else (stats[rows, None], stats[None, :])
        sim = bs.sim_strip(t, t[rows], metric, s_r, s_c)
    return affinity.knn_adjacency_block(sim, vr, valid, k, start, out_dtype=torch.bool)


def _modality_candidates(t, tr, valid, vr, k, metric, *, start: int, block: int,
                         n: int, nbins: int, row_sums=None, postings=None):
    """(keep, grp) binned candidates of one modality's row block (K2, on the
    postings route when the panel's ``postings`` are given and the bin count
    takes them), or None at k == 0 (the modality contributes no edges)."""
    k = max(0, min(k, n - 1))
    if k == 0:
        return None
    vals, grp = bs.binned_candidates(
        t.contiguous(), tr.contiguous(), valid, start, metric=metric, nbins=nbins,
        block=block, row_sums=row_sums,
        postings=postings if bs.takes_postings(nbins) else None)
    return bs.budgeted_keep(vals, vr, k), grp


def _pair_loc_time(cols: Columns, start: int, block: int, n: int, nbins: int,
                   k_basis: int) -> dict:
    """{kind: (vals, grp)} for location_xyz + time from ONE K3 launch; {}
    when either is missing or clamps to k = 0."""
    if "location_xyz" not in cols.kinds or "time" not in cols.kinds:
        return {}
    if min(k_basis, n - 1) <= 0:
        return {}
    iL, iT = cols.kinds.index("location_xyz"), cols.kinds.index("time")
    tL, tT = cols.tensors[iL], cols.tensors[iT]
    rows = slice(start, start + block)
    tL, tT, rL, rT = (x.contiguous() for x in (tL, tT, tL[rows], tT[rows]))
    vaL, grL, vaT, grT = bs.binned_candidates_pair(
        tL, tT, rL, rT, cols.valids[iL], cols.valids[iT], start, metricA="chord3",
        metricB="l1", nbins=nbins, block=block)
    return {"location_xyz": (vaL, grL), "time": (vaT, grT)}


def _pair_keep(kind: str, pair: dict, vr, k_basis: int, n: int):
    vals, grp = pair[kind]
    k = _metric_k(kind, k_basis)[1]
    return bs.budgeted_keep(vals, vr, max(0, min(k, n - 1))), grp


def fused_rowblock(cols: Columns, start: int, block: int, k_basis: int,
                   select: str = "strip", nbins: int = 0,
                   out_dtype=torch.float32) -> torch.Tensor:
    """(block, n) fused adjacency rows [start, start+block), a pure function
    of the column panels.  ``select="binned"`` (with ``nbins`` from
    ``default_nbins``) writes the modalities the candidate form holds from
    :func:`candidate_rowblock` through ``blocked_select.union_rowblock``, in
    ``out_dtype``; ``"strip"`` takes every modality through its similarity
    strip and exact top-k.  On both routes the modalities the candidate
    form does not hold (legacy kinds, panels without a 128-multiple width,
    a username panel past the first or not int32) are OR-ed in from their
    strips, as bool, cast once at the end."""
    cols = hoist_columns(cols)          # a no-op for the column builders' kinds
    n = cols.n
    binned = select == "binned" and nbins > 0 and n % nbins == 0
    held = _cand_held(cols.kinds, cols.tensors) if binned else [False] * len(cols.kinds)
    strips = [_strip_adjacency(cols, i, start, block, k_basis)
              for i, h in enumerate(held) if not h]
    fused = None
    if any(held):
        fused = bs.union_rowblock(candidate_rowblock(cols, start, block, k_basis, nbins),
                                  torch.bool if strips else out_dtype)
    for m in strips:
        fused = m if fused is None else fused | m
    if fused is None:      # no modality (e.g. n == 1 clamps each to k = 0)
        fused = torch.zeros((block, n), dtype=torch.bool, device=cols.valids[0].device)
    return fused.to(out_dtype)


def scan_blocks(cols: Columns, block: int, k_basis: int, select: str = "strip",
                nbins: int = 0, out_dtype=torch.float32, starts=None):
    """Yield ``(start, fused_rowblock(...))`` over every row block in order
    (or over the block starts ``starts``: a row-sharded sweep's share), the
    counterpart of the JAX package's ``_scan_blocks``, with
    ``hoist_columns`` applied once per sweep.  The sweeps that accumulate
    over blocks (degrees, ``A^T v``) would count a clamped last block's rows
    twice, so ``block`` must divide n: it raises otherwise.  A finished
    sweep records the counter ``blocked.union_blocks``: the blocks the union
    kernel wrote."""
    cols = hoist_columns(cols)
    n = cols.n
    if n % block:
        raise ValueError(f"block={block} must divide n={n} (pad rows upstream): a "
                         "clamped last block would count rows twice")
    before = bs.union_blocks_written()
    for start in (range(0, n, block) if starts is None else starts):
        yield start, fused_rowblock(cols, start, block, k_basis, select, nbins, out_dtype)
    profiling.counter("blocked.union_blocks", bs.union_blocks_written() - before)


# ---------------------------------------------------------------------------
# candidate-form row blocks (the dense block never exists)
# ---------------------------------------------------------------------------

def cand_fold_supported(kinds, tensors, nbins: int, n: int) -> bool:
    """True when the candidate form holds every modality (:func:`_cand_held`;
    username is taken inside K4 / K5): the precondition of the
    candidate-native FD fold."""
    if nbins <= 0 or n % nbins or n // nbins > 127:
        return False
    return all(_cand_held(kinds, tensors))


def candidate_rowblock(cols: Columns, start: int, block: int, k_basis: int,
                       nbins: int) -> cm.CandBlock:
    """The edges of the modalities the candidate form holds
    (:func:`_cand_held`) in rows [start, start+block), packed as int8
    candidate slabs + username uids; the others are left out.  Where
    :func:`cand_fold_supported` holds, these are all of
    ``fused_rowblock(select="binned")``'s edges."""
    cols = hoist_columns(cols)
    n = cols.n
    rows = slice(start, start + block)
    pair = _pair_loc_time(cols, start, block, n, nbins, k_basis)
    slabs, uid_rows, uid_cols = [], None, None
    for kind, t, valid, post, held in zip(cols.kinds, cols.tensors, cols.valids,
                                          cols.postings_of(),
                                          _cand_held(cols.kinds, cols.tensors)):
        if not held:
            continue
        if kind == "username":
            uid_rows, uid_cols = cm.mask_uids(t, valid, nbins, start, block)
            continue
        if kind in pair:
            slabs.append(cm.pack_slab(*_pair_keep(kind, pair, valid[rows], k_basis, n)))
            continue
        metric, k = _metric_k(kind, k_basis)
        t, stats = t if isinstance(t, tuple) else (t, None)
        res = _modality_candidates(t, t[rows], valid, valid[rows], k, metric, start=start,
                                   block=block, n=n, nbins=nbins, row_sums=stats,
                                   postings=post)
        if res is not None:
            slabs.append(cm.pack_slab(*res))
    device = cols.valids[0].device
    if not slabs:                # username-only (or all k = 0) windows
        slabs = [torch.full((block, nbins), -1, dtype=torch.int8, device=device)]
    if uid_cols is None:
        uid_cols = torch.full((n // nbins, nbins), -2, dtype=torch.int32, device=device)
    return cm.CandBlock(torch.stack(slabs), uid_rows, uid_cols, int(start))


# ---------------------------------------------------------------------------
# consumers: FD fold and blocked randomized SVD
# ---------------------------------------------------------------------------

def blocked_fd_sketch(cols: Columns, *, ell: int, block: int, k_basis: int,
                      mode: str = "subspace", select: str = "strip", nbins: int = 0,
                      cand_fold: bool | None = None, starts=None):
    """FD sketch (ell, n) of the implicit fused adjacency's rows in one
    rematerialized sweep -> (sketch, sq_frobenius, shrink_loss), the
    huge-window SWFDMC summary; ``starts`` folds only the row blocks that
    start there (a row-sharded sweep's share), else every block.

    ``cand_fold`` absorbs candidate-form blocks (``fd.shrink_rr_cands``: the
    fold's products run off the int8 slabs through K4 / K5); it needs the rr
    shrink, the binned route, block | n and every modality binned-eligible.
    None = on when eligible on a CUDA device, off elsewhere; True forces it
    (the CPU then runs the kernels' plain versions).  Its edges equal the
    dense binned fold's by construction; products differ only in f32
    summation order and the bf16 rounding of the probe and bound operands."""
    from mused_tpu_torch.ops import fd
    mode = fd.resolve_fold_mode(mode)
    cols = hoist_columns(cols)
    n = cols.n
    if n % block:
        raise ValueError(f"block={block} must divide n={n} (pad rows upstream): a "
                         "clamped last block would absorb rows twice")
    eligible = (mode == "rr" and select == "binned"
                and cand_fold_supported(cols.kinds, cols.tensors, nbins, n))
    device = cols.valids[0].device
    if cand_fold is None:
        cand_fold = eligible and device.type == "cuda"
    elif cand_fold and not eligible:
        raise ValueError("cand_fold=True needs the rr shrink, select='binned', block | "
                         "n, and every modality binned-eligible (cand_fold_supported)")
    state = fd.init(ell, n, device)
    if not cand_fold:
        for _, fused in scan_blocks(cols, block, k_basis, select, nbins,
                                    torch.bfloat16 if mode == "rr" else torch.float32,
                                    starts=starts):
            state = fd.update_stream(state, fused, mode=mode)
        return state.sketch, state.sq_frobenius, state.shrink_loss
    for start in (range(0, n, block) if starts is None else starts):
        cand = candidate_rowblock(cols, start, block, k_basis, nbins)
        b, delta, edges = fd.shrink_rr_cands(state.sketch, cand, ell)
        state = fd.FDState(sketch=b, sq_frobenius=state.sq_frobenius + edges,
                           shrink_loss=state.shrink_loss + delta, count=state.count + block)
    return state.sketch, state.sq_frobenius, state.shrink_loss


def randomized_svd_from_products(mul_a, mul_at, generator: torch.Generator | None, *,
                                 n: int, rank: int, oversample: int = 8, n_iter: int = 2,
                                 device=None, omega: torch.Tensor | None = None):
    """Randomized truncated SVD U·S of an implicit (n, n) matrix from its
    products ``mul_a(v) = A @ v`` and ``mul_at(v) = A^T @ v`` (reference
    TruncatedSVD, matrix_operations.py:143-147); ``omega`` (n, r) injects
    the Gaussian test matrix, else it is drawn from ``generator``.
    Returns (n, rank), zero-padded when rank exceeds the sketch."""
    r = min(rank + oversample, n)
    if omega is None:
        omega = torch.randn((n, r), generator=generator, device=device,
                            dtype=torch.float32)
    q = torch.linalg.qr(mul_a(omega))[0]
    for _ in range(n_iter):
        z = torch.linalg.qr(mul_at(q))[0]
        q = torch.linalg.qr(mul_a(z))[0]
    ub, s, _ = torch.linalg.svd(mul_at(q).T, full_matrices=False)
    out = (q @ ub)[:, :rank] * s[None, :rank]
    if rank > out.shape[1]:
        out = torch.cat([out, out.new_zeros((n, rank - out.shape[1]))], dim=1)
    return out


def no_reduce(x: torch.Tensor) -> torch.Tensor:
    """The ``allreduce`` of a sweep that covers every block: nothing to sum."""
    return x


def blocked_svd_reduce(cols: Columns, generator: torch.Generator | None, *, rank: int,
                       block: int, k_basis: int, n_iter: int = 2, oversample: int = 8,
                       select: str = "strip", nbins: int = 0,
                       omega: torch.Tensor | None = None, starts=None,
                       allreduce=no_reduce) -> torch.Tensor:
    """TruncatedSVD.fit_transform of the implicit fused adjacency with
    (2 + 2 * n_iter) rematerialized sweeps over row blocks -> (n, rank).
    ``starts`` sweeps only the row blocks that start there and ``allreduce``
    sums each product over the sweeps that share the blocks (a row-sharded
    sweep, ``parallel/sharded``); the defaults sweep every block."""
    cols = hoist_columns(cols)
    n = cols.n

    def blocks():          # f32 blocks; raises where block does not divide n
        return scan_blocks(cols, block, k_basis, select, nbins, torch.float32, starts=starts)

    def mul_a(v):          # A @ v, one block of rows at a time (others' rows stay 0)
        acc = torch.zeros((n, v.shape[1]), dtype=torch.float32, device=v.device)
        for start, fused in blocks():
            acc[start:start + block] = fused @ v
        return allreduce(acc)

    def mul_at(v):         # A^T @ v, summed over blocks in order
        acc = torch.zeros((n, v.shape[1]), dtype=torch.float32, device=v.device)
        for start, fused in blocks():
            acc += fused.T @ v[start:start + block]
        return allreduce(acc)

    return randomized_svd_from_products(mul_a, mul_at, generator, n=n, rank=rank,
                                        oversample=oversample, n_iter=n_iter,
                                        device=cols.valids[0].device, omega=omega)
