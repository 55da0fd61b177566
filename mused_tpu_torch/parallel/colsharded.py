"""Column-sharded huge-window sweep — port of ``mused_tpu/parallel/colsharded.py``.

The single-device huge-window path (``ops/blocked_affinity``) holds the
window's whole column panels on one device: at n window rows the text panel
alone is n * text_hash_dim bf16 bytes.  Here the FEATURES shard instead:
the window's rows split over the mesh's column axis, so rank q owns rows
[q·n/p, (q+1)·n/p), which are also its adjacency COLUMNS.  Every rank sweeps
every row block against its (block, n/p) column slice:

  per row block (in lockstep on every rank):
    row panel = broadcast of the owner rank's slice          O(block·K) bytes
    stride-binned kNN candidates over the local columns      K3 pairs / K2
      (consecutive modalities paired into one K3 launch on the card: tags
       jaccard + text dot on standard streams, on the postings route with
       each shard's own postings; each modality's plain version on the
       CPU) with the shard-local start and the row panel's own statistics
       (``row_stats``)
    global candidate merge: max of the values, then min of the global group
      among the ranks that reach it (the single-device kernel's rule: the
      lowest group wins a tie)                                O(block·nbins)
    the same exact top-k on every rank -> this rank's candidate-form block
      (local group ids, the rank's global group offset g0): its (block, n/p)
      slice of the fused adjacency written by the union, or K4 / K5
    column-sharded FD absorb: every contraction over the sharded axis is an
      all-reduce of a small (m2, r) product

The shrinks are the single-device shrinks (``ops/fd``) with the column
axis' sum as their ``allreduce``: only the f32 summation order differs
(per-shard partial sums, then the all-reduce).

GRID (the mesh has a "model" axis of pm > 1): the columns shard pm ways over
"model" and the row blocks split pd ways over "data"; each row group folds
its own range of blocks, and the pd column-sharded sketches merge with one
more shrink of the gathered (pd·ell, n/pm) stack (its delta joins the
honest loss).  A (p, 1) mesh is pure column sharding.

SPMD: every rank calls each entry point with the same arguments (the whole
window's host features; each rank moves only its own rows to its device).
What the JAX package keeps replicated comes out identical on every rank:
the gathered sketch, the SVD panel, the Ritz basis.  Random draws come from
the caller's generator or the fixed FD probe (``fd.default_probe``), which
every rank seeds alike.
"""
from __future__ import annotations

import numpy as np
import torch

from mused_tpu_torch.ops import affinity, blocked_affinity as ba, fd
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.ops.kernels import cand_matvec as cm
from mused_tpu_torch.parallel.mesh import Axis, mesh_device, mesh_shape

# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def default_nbins_colsharded(n: int, p: int, target_reduction: int = 64,
                             k_max: int = 0, nbins_cap: int = 4096) -> int:
    """Candidate-bin count for a p-way column-sharded sweep: nbins = n / g
    with p | g, so each shard covers whole groups and its local slot is the
    global one; g / p <= 127 (int8 group ids per shard) and n / g <=
    ``nbins_cap``.  Prefers nbins >= 8 * k_max, then 128 | nbins, then the
    largest reduction within max(target_reduction, the cap's floor).  0 when
    no geometry is admissible."""
    if p < 1 or p > 127 or n % p:
        return 0
    g_floor = max(p, -(-n // nbins_cap))
    g_hi = min(max(target_reduction, g_floor), 127 * p)
    cands = [g for g in range(p, g_hi + 1)
             if g % p == 0 and n % g == 0 and g // p <= 127 and n // g <= nbins_cap]
    if not cands:
        return 0
    ok = [g for g in cands if not k_max or (n // g) >= 8 * k_max] or [min(cands)]
    aligned = [g for g in ok if (n // g) % 128 == 0]
    return n // (max(aligned) if aligned else max(ok))


def _mesh_axes(mesh) -> tuple[str, str | None, int, int]:
    """(col_axis, row_axis, pm, pd): (p, 1) is pure column sharding over
    "data"; (pd, pm > 1) the grid (columns over "model", row groups over
    "data"; pd == 1 has no row groups to merge)."""
    shape = mesh_shape(mesh)
    pm = shape.get("model", 1)
    if pm > 1:
        pd = shape["data"]
        return "model", ("data" if pd > 1 else None), pm, pd
    return "data", None, shape["data"], 1


def _resolve_geometry(n: int, mesh, block: int, k_basis: int, nbins: int | None,
                      check_row_groups: bool = True) -> int:
    """Validate the sweep's geometry (one copy for every entry point) and
    resolve nbins."""
    _, _, pm, pd = _mesh_axes(mesh)
    if n % pm:
        raise ValueError(f"n={n} must split evenly over {pm} column shards")
    n_local = n // pm
    if n_local % block:
        raise ValueError(
            f"block={block} must divide the per-chip column range n/pm="
            f"{n_local} (pad upstream, as the engine does)")
    if check_row_groups and (n // block) % pd:
        raise ValueError(
            f"row blocks ({n // block}, block={block}) must split evenly "
            f"over the {pd} row groups")
    if nbins is None:
        nbins = default_nbins_colsharded(n, pm, k_max=3 * k_basis)
    if not nbins or n_local % nbins:
        raise ValueError(
            f"no column-sharded bin structure for n={n}, pm={pm} "
            f"(need pm | groups; got nbins={nbins})")
    if n_local // nbins > 127:
        raise ValueError(
            f"nbins={nbins} gives {n_local // nbins} per-chip groups — past "
            "the kernel's int8 group-id budget (127); use more bins")
    return nbins


class _Sweep:
    """One rank's view of a column-sharded sweep: its axes, its device, its
    share of the row blocks."""

    def __init__(self, mesh, n: int, block: int):
        col, row, self.pm, self.pd = _mesh_axes(mesh)
        self.col = Axis(mesh, col)
        self.row = Axis(mesh, row) if row is not None else None
        self.device = mesh_device(mesh)
        self.n, self.block = n, block
        self.n_local = n // self.pm
        self.me = self.col.index
        starts = list(range(0, n, block))
        if self.row is not None:        # this row group's contiguous share
            per = len(starts) // self.pd
            starts = starts[self.row.index * per:(self.row.index + 1) * per]
        self.starts = starts

    def place(self, feats: tuple) -> tuple:
        """This rank's rows of each (n, ...) host array, on its device: the
        full panels never exist on one device."""
        lo, hi = self.me * self.n_local, (self.me + 1) * self.n_local
        return tuple(torch.as_tensor(np.ascontiguousarray(np.asarray(x)[lo:hi])).to(self.device)
                     for x in feats)

    def psum_all(self, x):
        """Complete an (n, ...) partial assembled from row blocks."""
        x = self.col.psum(x)
        return self.row.psum(x) if self.row is not None else x

    def gather_cols(self, x):
        """Complete a column-sharded (n/pm, ...) partial to (n, ...)."""
        if self.row is not None:
            x = self.row.psum(x)
        return self.col.all_gather(x).reshape((self.n,) + tuple(x.shape[1:]))


def _bcast_rows(x_local: torch.Tensor, start: int, block: int, axis: Axis) -> torch.Tensor:
    """Rows [start, start+block) of the row-sharded global tensor on every
    rank: each row block lives wholly on one rank (block | n/p), which
    broadcasts its slice."""
    n_local = x_local.shape[0]
    owner = start // n_local
    if axis.index == owner:
        lo = start - owner * n_local
        buf = x_local[lo:lo + block].contiguous().clone()
    else:
        buf = torch.empty((block,) + tuple(x_local.shape[1:]), dtype=x_local.dtype,
                          device=x_local.device)
    return axis.broadcast(buf, owner)


def _merge_candidates(vals: torch.Tensor, grp_i8: torch.Tensor, groups_local: int,
                      axis: Axis):
    """Global (block, nbins) candidates from each rank's: the largest value,
    and the lowest global group among the ranks that reach it (within a
    rank the kernel already kept its lowest group, and global group ids
    grow with the rank)."""
    g_global = grp_i8.to(torch.int32) + axis.index * groups_local
    vmax = axis.pmax(vals)
    cand = torch.where(vals == vmax, g_global, torch.full_like(g_global, 1 << 30))
    return vmax, axis.pmin(cand)


# ---------------------------------------------------------------------------
# per-shard column prep (blocked_affinity.standard_columns / generic_columns
# with the text document frequencies summed over the column shards)
# ---------------------------------------------------------------------------

def _prep_local_modalities(feat_shards: tuple, types: tuple, k_basis: int, tags_dim: int,
                           text_dim: int, axis: Axis) -> list:
    """This rank's modality descriptors [(metric, panel, valid, stats, k,
    postings)]: ``metric`` a K2 metric or "username" (equality, no kNN),
    ``stats`` the (n/p,) row statistic of jaccard / chord, else None,
    ``postings`` the local panel's (tags and text), else None.  The same
    numbers as the single-device column builders; the TF-IDF document
    frequencies are the whole window's (reference
    matrix_operations.py:91-110)."""
    if types[0] == "standard_sparse":
        loc, tim, uid, tags_ids, text_ids, text_cnt, tags_valid = feat_shards
        tags = affinity.counts_from_tokens(tags_ids, None, tags_dim)
        text = affinity.counts_from_tokens(text_ids, text_cnt, text_dim)
    elif tuple(types) == ("standard",):
        loc, tim, uid, tags, text, tags_valid = feat_shards
        tags, text = tags.float(), text.float()
        tags_ids = text_ids = None
    else:
        return _prep_generic(feat_shards, types, k_basis)
    loc, tim, uid = loc.float(), tim.float(), uid.to(torch.int32)
    loc_valid = torch.all(torch.isfinite(loc), dim=1)
    tim_valid = affinity.time_valid(tim)
    text_valid = torch.sum(text, dim=1) > 0
    n_docs = torch.clamp(axis.psum(torch.sum(text_valid.float())), min=1.0)
    df = axis.psum(torch.sum((text > 0) & text_valid[:, None], dim=0).float())
    idf = torch.log((1.0 + n_docs) / (1.0 + df)) + 1.0
    text = text * idf[None, :]
    text = text / torch.clamp(torch.linalg.norm(text, dim=1, keepdim=True), min=1e-12)
    tags_sums = torch.sum(tags, dim=1)           # f32, before the int8 cast
    tags8 = bs.pad_features_128(tags.to(torch.int8))
    text16 = bs.pad_features_128(text.to(torch.bfloat16))
    return [
        ("chord3", ba._unit_xyz(loc, loc_valid), loc_valid, None, k_basis, None),
        ("l1", tim, tim_valid, None, 3 * k_basis, None),
        ("username", uid, uid >= 0, None, 0, None),
        ("jaccard", tags8, tags_valid.to(torch.bool), tags_sums, k_basis,
         bs.build_postings(tags8, tags_ids)),
        ("dot", text16, text_valid, None, k_basis, bs.build_postings(text16, text_ids)),
    ]


def _prep_generic(feat_shards: tuple, types: tuple, k_basis: int) -> list:
    """Generic numeric modalities (embedding / location / time / default),
    as ``blocked_affinity.generic_columns`` builds them."""
    mods = []
    for x, t in zip(feat_shards, types):
        x = x.float()
        if t == "location":
            valid = torch.all(torch.isfinite(x), dim=1)
            mods.append(("chord3", ba._unit_xyz(x, valid), valid, None, k_basis, None))
        elif t == "time":
            valid = affinity.time_valid(x)
            mods.append(("l1", torch.where(valid[:, None], x, 0.0), valid, None,
                         3 * k_basis, None))
        elif t == "embedding":
            unit, valid = affinity.normalized_embedding(x)
            mods.append(("dot", ba.bf16_pack(unit), valid, None, k_basis, None))
        else:       # default euclidean: k counts self (reference :112-119)
            valid = torch.all(torch.isfinite(x), dim=1)
            packed = ba.bf16_pack(torch.where(valid[:, None], x, 0.0))
            pf = packed.float()
            mods.append(("chord", packed, valid, torch.sum(pf * pf, dim=1),
                         max(1, k_basis) - 1, None))
    return mods


# ---------------------------------------------------------------------------
# candidate selection
# ---------------------------------------------------------------------------

def _select_candidates_local(mods: list, start: int, block: int, n: int, nbins: int,
                             axis: Axis):
    """Globally merged kNN candidates of rows [start, start+block):
    [(keep, gwin)] per kNN modality (the same (block, nbins) kept mask and
    winning global groups on every rank), and the username modality's local
    (uid, valid) when present."""
    n_local = mods[0][1].shape[0]
    groups_local = n_local // nbins
    # the self-column test compares (start_adj + row) with the LOCAL column
    start_adj = start - axis.index * n_local
    items, postings, user = [], [], None
    for metric, t, valid, stats, k, post in mods:
        if metric == "username":
            user = (t, valid)
            continue
        k_eff = max(0, min(k, n - 1))
        if k_eff == 0:
            continue
        vr = _bcast_rows(valid, start, block, axis)
        tr = _bcast_rows(t, start, block, axis)
        sr = _bcast_rows(stats, start, block, axis) if stats is not None else None
        items.append((metric, t, valid, stats, k_eff, vr, tr, sr))
        postings.append(post)
    raw = _raw_candidates(items, start_adj, nbins=nbins, block=block, postings=postings)
    cands = []
    for (vals, grp), item in zip(raw, items):
        vmax, gwin = _merge_candidates(vals, grp, groups_local, axis)
        cands.append((bs.budgeted_keep(vmax, item[5], item[4]), gwin))
    return cands, user


def _raw_candidates(items: list, start_adj: int, *, nbins: int, block: int,
                    postings: list | None = None) -> list:
    """Per-modality (vals, grp) of prepared items [(metric, cols, colv, stats,
    k_eff, vr, rows, row_stats)], no collectives: consecutive modalities
    paired into one K3 launch (a leftover single takes K2), on the postings
    route where both halves have ``postings`` (per item, or None) and the
    bin count takes them.  On CPU tensors the wrappers run their plain
    versions."""
    raw = []
    if postings is None or not bs.takes_postings(nbins):
        postings = [None] * len(items)
    for i in range(0, len(items), 2):
        if i + 1 < len(items):
            ma, ta, va, sa, _, _, tra, sra = items[i]
            mb, tb, vb, sb, _, _, trb, srb = items[i + 1]
            pa, pb = postings[i], postings[i + 1]
            if pa is None or pb is None:        # both halves on one route
                pa = pb = None
            vA, gA, vB, gB = bs.binned_candidates_pair(
                ta, tb, tra, trb, va, vb, start_adj, metricA=ma, metricB=mb, nbins=nbins,
                block=block, row_sumsA=sa, row_statsA=sra, row_sumsB=sb, row_statsB=srb,
                postingsA=pa, postingsB=pb)
            raw += [(vA, gA), (vB, gB)]
        else:
            m_, t_, v_, s_, _, _, tr_, sr_ = items[i]
            raw.append(bs.binned_candidates(t_, tr_, v_, start_adj, metric=m_, nbins=nbins,
                                            block=block, row_sums=s_, row_stats=sr_,
                                            postings=postings[i]))
    return raw


def _cand_block_local(mods: list, start: int, block: int, n: int, nbins: int,
                      axis: Axis) -> cm.CandBlock:
    """This rank's candidate-form slice of fused rows [start, start+block):
    the globally merged winners in its column range as LOCAL int8 group ids
    (else -1) and its global group offset g0, so K4 / K5 and the union walk
    only the local groups while the username self test stays global."""
    n_local = mods[0][1].shape[0]
    groups_local = n_local // nbins
    g0 = axis.index * groups_local
    device = mods[0][1].device
    cands, user = _select_candidates_local(mods, start, block, n, nbins, axis)
    slabs = []
    for keep, gwin in cands:
        lg = gwin - g0
        local = keep & (lg >= 0) & (lg < groups_local)
        slabs.append(torch.where(local, lg, -1).to(torch.int8))
    if not slabs:               # username-only (or all k = 0) windows
        slabs = [torch.full((block, nbins), -1, dtype=torch.int8, device=device)]
    if user is not None:        # username connects all same-user rows (ref :55-72)
        uid, valid = user
        urow = _bcast_rows(torch.where(valid, uid, -1).to(torch.int32), start, block, axis)
        uid_rows = urow.reshape(block, 1)
        uid_cols = torch.where(valid, uid, -2).to(torch.int32).reshape(groups_local, nbins)
    else:
        uid_rows = None
        uid_cols = torch.full((groups_local, nbins), -2, dtype=torch.int32, device=device)
    return cm.CandBlock(torch.stack(slabs), uid_rows, uid_cols, int(start), int(g0))


def _fused_block_local(mods: list, start: int, block: int, n: int, nbins: int, axis: Axis,
                       out_dtype=torch.bool) -> torch.Tensor:
    """This rank's (block, n/p) slice of fused adjacency rows
    [start, start+block) in ``out_dtype``: the OR of the per-modality kNN
    adjacencies (reference matrix_operations.py:134-141) and username
    equality, written from its candidate-form slice."""
    return bs.union_rowblock(_cand_block_local(mods, start, block, n, nbins, axis),
                             out_dtype)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _setup(feats: tuple, types: tuple, mesh, block: int, k_basis: int, tags_dim: int,
           text_dim: int):
    """(sweep, this rank's modality descriptors)."""
    sw = _Sweep(mesh, feats[0].shape[0], block)
    mods = _prep_local_modalities(sw.place(feats), tuple(types), k_basis, tags_dim,
                                  text_dim, sw.col)
    return sw, mods


def _fused_blocks(sw: _Sweep, mods: list, nbins: int):
    """(start, this rank's (block, n/p) f32 slice) of each row block of its
    share, in order: the SVD's and spectral's sweeps."""
    for start in sw.starts:
        yield start, _fused_block_local(mods, start, sw.block, sw.n, nbins, sw.col,
                                        torch.float32)


def colsharded_blocked_fd_sketch(feats: tuple, types: tuple, *, ell: int, block: int,
                                 k_basis: int, mesh, mode: str = "subspace",
                                 tags_dim: int = 2048, text_dim: int = 4096,
                                 nbins: int | None = None, cand_fold: bool | None = None):
    """FD sketch (ell, n) of a huge window's implicit fused adjacency with the
    window's features column-sharded over ``mesh`` -> (sketch, sq_frobenius,
    shrink_loss), the same on every rank (the sketch gathered over the
    column shards).  The contract of ``blocked_affinity.blocked_fd_sketch``,
    against which the adjacency is bit-exact (the fold differs only in the
    all-reduce's summation order).

    ``feats`` / ``types``: the whole window's host features in the engine's
    layout (``("standard_sparse",)``, ``("standard",)`` or generic modality
    types); each rank moves only its rows to its device.  ``cand_fold``
    absorbs candidate-form blocks (K4 / K5; needs the rr shrink); None = on
    for a CUDA mesh with the rr shrink.  The grid merges its row groups'
    sketches with one more shrink (its delta joins the loss).
    Requirements: pm | n, block | n/pm, pd | (n/block), a binnable
    structure (``default_nbins_colsharded``)."""
    n = feats[0].shape[0]
    nbins = _resolve_geometry(n, mesh, block, k_basis, nbins)
    mode = fd.resolve_fold_mode(mode)
    if mode not in ("eigh", "rr"):
        raise ValueError(f"colsharded fold supports 'eigh'/'rr' (via "
                         f"'subspace'), got {mode!r}")
    if cand_fold is None:
        cand_fold = mode == "rr" and mesh.device_type == "cuda"
    elif cand_fold and mode != "rr":
        raise ValueError("colsharded cand_fold=True needs the rr shrink "
                         "(mode='subspace'/'rr')")
    sw, mods = _setup(feats, types, mesh, block, k_basis, tags_dim, text_dim)
    psum = sw.col.psum          # the fold's contractions over the sharded columns
    state = fd.init(ell, sw.n_local, sw.device)
    out_dt = torch.bfloat16 if mode == "rr" else torch.float32
    for start in sw.starts:
        if cand_fold:
            cand = _cand_block_local(mods, start, block, n, nbins, sw.col)
            b, delta, edges = fd.shrink_rr_cands(state.sketch, cand, ell, allreduce=psum)
            state = fd.FDState(sketch=b, sq_frobenius=state.sq_frobenius + edges,
                               shrink_loss=state.shrink_loss + delta,
                               count=state.count + block)
        else:
            fused = _fused_block_local(mods, start, block, n, nbins, sw.col, out_dt)
            state = fd.update_stream(state, fused, mode=mode, allreduce=psum)
    sketch, sq, loss = state.sketch, state.sq_frobenius, state.shrink_loss
    if sw.row is not None:
        # merge the pd row groups' sketches: one more shrink of the gathered
        # (pd * ell, n/pm) stack, the same on every rank of the row axis
        stack = sw.row.all_gather(sketch).reshape(-1, sw.n_local)
        if mode == "rr":
            sketch, mdelta = fd.shrink_rr_pair(stack[:ell], stack[ell:], ell, allreduce=psum)
        else:
            sketch, mdelta = fd.shrink(stack, ell, allreduce=psum)
        sq = sw.row.psum(sq)
        loss = sw.row.psum(loss) + mdelta
    sketch = sw.col.all_gather(sketch).permute(1, 0, 2).reshape(ell, n)
    return sketch, sq, loss


def colsharded_blocked_svd_reduce(feats: tuple, types: tuple,
                                  generator: torch.Generator | None, *, rank: int,
                                  block: int, k_basis: int, mesh, n_iter: int = 2,
                                  oversample: int = 8, tags_dim: int = 2048,
                                  text_dim: int = 4096, nbins: int | None = None,
                                  omega: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked randomized SVD U·S (n, rank) of the implicit fused adjacency
    with the features column-sharded (reference TruncatedSVD,
    matrix_operations.py:143-147), the same on every rank.  A·V contracts
    each rank's column slice with its slice of the (n, r) panel and sums;
    Aᵀ·Q partials are column-sharded and gathered once per sweep.
    ``omega`` injects the (n, r) test matrix, else the generator draws it
    (the same on every rank for a generator seeded alike)."""
    n = feats[0].shape[0]
    nbins = _resolve_geometry(n, mesh, block, k_basis, nbins)
    sw, mods = _setup(feats, types, mesh, block, k_basis, tags_dim, text_dim)
    lo = sw.me * sw.n_local

    def mul_a(v):           # A @ v: column-slice contractions, summed
        acc = torch.zeros((n, v.shape[1]), dtype=torch.float32, device=v.device)
        v_loc = v[lo:lo + sw.n_local]
        for start, fused in _fused_blocks(sw, mods, nbins):
            acc[start:start + block] = fused @ v_loc
        return sw.psum_all(acc)

    def mul_at(q):          # A^T @ q: column-sharded partials, gathered
        acc = torch.zeros((sw.n_local, q.shape[1]), dtype=torch.float32, device=q.device)
        for start, fused in _fused_blocks(sw, mods, nbins):
            acc += fused.T @ q[start:start + block]
        return sw.gather_cols(acc)

    return ba.randomized_svd_from_products(mul_a, mul_at, generator, n=n, rank=rank,
                                           oversample=oversample, n_iter=n_iter,
                                           device=sw.device, omega=omega)


def colsharded_spectral_embedding(feats: tuple, types: tuple,
                                  generator: torch.Generator | None, *, k_max: int,
                                  block: int, k_basis: int, mesh, n_iter: int = 6,
                                  oversample: int = 8, tags_dim: int = 2048,
                                  text_dim: int = 4096, nbins: int | None = None,
                                  probe: torch.Tensor | None = None):
    """Normalized-cuts spectral embedding with the features column-sharded:
    the degree and symmetrized M·V sweeps of ``ops/blocked_spectral`` over
    column slices.  Returns (ritz (n, k_max + oversample), eigenvalues),
    descending, the same on every rank; feed
    ``blocked_spectral.labels_from_ritz`` / ``eigengap_k_from_spectrum``.
    ``probe`` injects the (n, m) start, else the generator draws it."""
    from mused_tpu_torch.ops import blocked_spectral as bspec
    n = feats[0].shape[0]
    nbins = _resolve_geometry(n, mesh, block, k_basis, nbins)
    sw, mods = _setup(feats, types, mesh, block, k_basis, tags_dim, text_dim)
    lo = sw.me * sw.n_local

    rp = torch.zeros(n, dtype=torch.float32, device=sw.device)
    cp = torch.zeros(sw.n_local, dtype=torch.float32, device=sw.device)
    for start, fused in _fused_blocks(sw, mods, nbins):
        rp[start:start + block] = torch.sum(fused, dim=1)
        cp += torch.sum(fused, dim=0)
    deg = 0.5 * (sw.psum_all(rp) + sw.gather_cols(cp))
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)), 0.0)

    def sym_matmul(v):      # v (n, m), the same on every rank
        av = torch.zeros_like(v)
        atv = torch.zeros((sw.n_local, v.shape[1]), dtype=v.dtype, device=v.device)
        v_loc = v[lo:lo + sw.n_local]
        for start, fused in _fused_blocks(sw, mods, nbins):
            av[start:start + block] = fused @ v_loc
            atv += fused.T @ v[start:start + block]
        return 0.5 * (sw.psum_all(av) + sw.gather_cols(atv))

    return bspec.ritz_from_products(sym_matmul, inv_sqrt, generator, n=n,
                                    m=min(k_max + oversample, n), n_iter=n_iter, probe=probe)


def colsharded_fused_rows(feats: tuple, types: tuple, *, start: int, block: int,
                          k_basis: int, mesh, tags_dim: int = 2048, text_dim: int = 4096,
                          nbins: int | None = None) -> torch.Tensor:
    """(block, n) bool fused adjacency rows [start, start+block) assembled
    from the column-sharded sweep, the same on every rank: the parity
    surface, bit-equal to ``blocked_affinity.fused_rowblock``'s binned
    route.  ``start`` must be a multiple of ``block``: a row range across a
    shard boundary has no single owner."""
    n = feats[0].shape[0]
    if start % block:
        raise ValueError(
            f"start={start} must be a multiple of block={block}: a row "
            "range straddling a shard boundary has no single owner chip")
    nbins = _resolve_geometry(n, mesh, block, k_basis, nbins, check_row_groups=False)
    sw, mods = _setup(feats, types, mesh, block, k_basis, tags_dim, text_dim)
    fused = _fused_block_local(mods, start, block, n, nbins, sw.col)
    return sw.col.all_gather(fused).permute(1, 0, 2).reshape(block, n)
