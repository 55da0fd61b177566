"""Row-sharded window steps — port of ``mused_tpu/parallel/sharded.py``.

Each of p ranks (one process per device, SPMD over ``torch.distributed``)
owns a contiguous row shard of m = n/p window rows:

  dense windows (:func:`sharded_engine_step`), per rank:
    all-gather the column features (coordinates, times, ids, token panels)
    (m, n) similarity strips -> exact top-k -> the fused adjacency shard
      (``affinity.knn_adjacency_block``: the plain strip, no K1, as the JAX
      package fuses outside its kernel here; location ranks by haversine)
    TF-IDF document frequencies and the document count summed over ranks
    SWFDMC: FD fold of the shard -> sketch merge (allgather | ring) ->
      the replicated SWFD ring absorbs the merged sketch and is queried
    else: the distributed randomized SVD (all-reduced Aᵀ products)
    row-sharded k-means | the replicated mini-batch step | spectral
      clustering of the all-gathered (n, n) matrix | DBSCAN host glue

  huge windows, the ``rows`` layout: every rank holds the whole window's
    column panels (``ops/blocked_affinity.Columns``) and rebuilds only its
    contiguous range of row blocks through the single-device code
    (``fused_rowblock`` / ``candidate_rowblock``, so K2-K5 on the card, on
    1/p of the blocks); the FD sketches merge, the SVD's A·V rows and Aᵀ·Q
    partials and spectral's degrees and products are all-reduced.

Every rank calls an entry point with the same arguments and gets the same
replicated result: the merge keeps position 0's copy (the JAX package
returns chip 0's), and random draws come from the caller's generator, which
every rank seeds alike (or are injected).  The all-reduces sum in another
order than XLA's psum, so f32 results differ at rounding level; the
integer-valued adjacency does not.
"""
from __future__ import annotations

from typing import Sequence

import torch

from mused_tpu_torch.ops import affinity, fd, kmeans, reduction, spectral, swfd
from mused_tpu_torch.ops import blocked_affinity as ba
from mused_tpu_torch.ops import blocked_spectral as bspec
from mused_tpu_torch.parallel import kmeans_sharded as ks
from mused_tpu_torch.parallel import sketch_merge
from mused_tpu_torch.parallel.mesh import Axis

HOST_CLUSTERED = ("DBSCAN_incr", "DBSCAN_centr")


def _gather_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(m, ...) shard -> (n, ...) row concatenation, in rank order."""
    return axis.all_gather(x).reshape((-1,) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# dense windows: the fused (m, n) shard
# ---------------------------------------------------------------------------

def _numeric_strip(kind: str, x_s: torch.Tensor, x_f: torch.Tensor, k_basis: int,
                   row_offset: int) -> torch.Tensor:
    """(m, n) kNN adjacency of a numeric modality's row shard against every
    column: location by haversine (reference matrix_operations.py:23-30),
    time by the summed |dt| with 3·k_basis neighbours (:32-53), any other
    kind by Euclidean distance with self among its k_basis (:112-119)."""
    if kind == "time":
        v_r, v_c = affinity.time_valid(x_s), affinity.time_valid(x_f)
    else:
        v_r, v_c = (torch.all(torch.isfinite(x), dim=1) for x in (x_s, x_f))
    if kind == "location":
        sim, k = affinity.haversine_sim(x_s, x_f, v_r, v_c), k_basis
    elif kind == "time":
        sim, k = affinity.time_sim(x_s, x_f, v_r, v_c), 3 * k_basis
    else:
        sim, k = affinity.euclidean_sim(x_s, x_f, v_r, v_c), max(1, k_basis) - 1
    return affinity.knn_adjacency_block(sim, v_r, v_c, k, row_offset)


def _row_shard_fused_adjacency(loc_s, time_s, uid_s, tags_s, text_s, k_basis: int,
                               axis: Axis, tags_valid_s=None, tags_f=None,
                               text_f=None) -> torch.Tensor:
    """This rank's fused (m, n) adjacency shard of the five standard
    modalities.  Column features are all-gathered; the TF-IDF document
    frequencies sum over the ranks.  Sparse-token callers pass the dense
    column panels built from the gathered tokens (``tags_f`` / ``text_f``)."""
    m = loc_s.shape[0]
    row_offset = axis.index * m
    loc_f, time_f, uid_f = (_gather_rows(x, axis) for x in (loc_s, time_s, uid_s))
    tags_f = _gather_rows(tags_s, axis) if tags_f is None else tags_f
    text_f = _gather_rows(text_s, axis) if text_f is None else text_f

    mats = [_numeric_strip("location", loc_s, loc_f, k_basis, row_offset),
            _numeric_strip("time", time_s, time_f, k_basis, row_offset)]

    # username equality (reference :55-72)
    same = (uid_s[:, None] == uid_f[None, :]) & (uid_s >= 0)[:, None] & (uid_f >= 0)[None, :]
    not_self = ((row_offset + torch.arange(m, device=uid_s.device))[:, None]
                != torch.arange(uid_f.shape[0], device=uid_s.device)[None, :])
    mats.append((same & not_self).float())

    # tags Jaccard (reference :74-89), validity from the raw-cell quirk when given
    if tags_valid_s is not None:
        gv_r = tags_valid_s.to(torch.bool)
        gv_c = _gather_rows(gv_r, axis)
    else:
        gv_r, gv_c = torch.sum(tags_s, dim=1) > 0, torch.sum(tags_f, dim=1) > 0
    inter = tags_s @ tags_f.T
    union = torch.sum(tags_s, dim=1)[:, None] + torch.sum(tags_f, dim=1)[None, :] - inter
    sim = torch.where(union > 0, inter / torch.clamp(union, min=1e-9), 0.0)
    mats.append(affinity.knn_adjacency_block(sim, gv_r, gv_c, k_basis, row_offset))

    # text TF-IDF cosine with the whole window's document frequencies (reference :91-110)
    xv_r = torch.sum(text_s, dim=1) > 0
    n_docs = axis.psum(torch.sum(xv_r.float()))
    df = axis.psum(torch.sum((text_s > 0) & xv_r[:, None], dim=0).float())
    idf = torch.log((1.0 + torch.clamp(n_docs, min=1.0)) / (1.0 + df)) + 1.0

    def unit(x):
        x = x * idf[None, :]
        return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)

    sim = unit(text_s) @ unit(text_f).T
    mats.append(affinity.knn_adjacency_block(sim, xv_r, torch.sum(text_f, dim=1) > 0,
                                             k_basis, row_offset))
    return affinity.fuse(mats)


def _generic_fused_shard(mats_s: Sequence[torch.Tensor], types: Sequence[str], k_basis: int,
                         axis: Axis) -> torch.Tensor:
    """Fused (m, n) shard of numeric modalities, the sharded mirror of the
    engine's plain ``_fuse_generic`` (embedding / location / time / default)."""
    out = []
    for x_s, t in zip(mats_s, types):
        x_s = x_s.float()
        row_offset = axis.index * x_s.shape[0]
        x_f = _gather_rows(x_s, axis)
        if t == "embedding":
            xr, v_r = affinity.normalized_embedding(x_s)
            xc, v_c = affinity.normalized_embedding(x_f)
            out.append(affinity.knn_adjacency_block(xr @ xc.T, v_r, v_c, k_basis, row_offset))
        else:
            out.append(_numeric_strip(t, x_s, x_f, k_basis, row_offset))
    return affinity.fuse(out)


def features_to_fused_shard(feat_shards: tuple, types: tuple, k_basis: int, tags_dim: int,
                            text_dim: int, axis: Axis) -> torch.Tensor:
    """This rank's fused (m, n) shard from its feature shards; ``types`` is
    the engine's layout tag (``("standard_sparse",)``, ``("standard",)`` or
    the generic modality types).  Sparse tokens are gathered as tokens and
    densified on both sides of the gather, never as dense panels."""
    if types[0] == "standard_sparse":
        loc, tim, uid, tags_ids, text_ids, text_cnt, tags_valid = feat_shards
        tags_f = affinity.counts_from_tokens(_gather_rows(tags_ids, axis), None, tags_dim)
        text_f = affinity.counts_from_tokens(_gather_rows(text_ids, axis),
                                             _gather_rows(text_cnt, axis), text_dim)
        return _row_shard_fused_adjacency(
            loc.float(), tim.float(), uid.to(torch.int32),
            affinity.counts_from_tokens(tags_ids, None, tags_dim),
            affinity.counts_from_tokens(text_ids, text_cnt, text_dim), k_basis, axis,
            tags_valid, tags_f=tags_f, text_f=text_f)
    if tuple(types) == ("standard",):
        loc, tim, uid, tags, text, tags_valid = feat_shards
        return _row_shard_fused_adjacency(loc.float(), tim.float(), uid.to(torch.int32),
                                          tags.float(), text.float(), k_basis, axis,
                                          tags_valid)
    return _generic_fused_shard(feat_shards, types, k_basis, axis)


def fused_shard(feats: tuple, types: tuple, *, k_basis: int, mesh, tags_dim: int = 2048,
                text_dim: int = 4096) -> torch.Tensor:
    """This rank's (m, n) fused adjacency shard from the whole window's
    device tensors ``feats`` (every rank passes them whole; each takes its
    contiguous row share): the parity surface of the dense step."""
    axis = Axis(mesh, "data")
    rows = axis.share(feats[0].shape[0])
    return features_to_fused_shard(tuple(f[rows] for f in feats), tuple(types), k_basis,
                                   tags_dim, text_dim, axis)


# ---------------------------------------------------------------------------
# dense windows: distributed SVD and the engine step
# ---------------------------------------------------------------------------

def _dist_svd_reduce(fused_s: torch.Tensor, generator: torch.Generator | None,
                     reduced_dim: int, axis: Axis, *, n_iter: int = 4, oversample: int = 10,
                     omega: torch.Tensor | None = None) -> torch.Tensor:
    """Randomized truncated SVD U·S (n, reduced_dim) of the row-sharded
    (m, n) fused adjacency, the same on every rank.

    It mirrors ``ops/reduction.randomized_svd`` (n_iter 4, oversample 10,
    B = QᵀA ordering), not the blocked SVD's constants, as the JAX package
    does: the replicated (n, k) test matrix ``omega`` (drawn from the
    generator, or injected), Y = A·Omega assembled from the shards' rows for
    the tall-skinny QRs, Aᵀ products all-reduced.  r = min(reduced_dim,
    n - 1) components, zero-padded back."""
    m, n = fused_s.shape
    r = min(reduced_dim, n - 1)
    k = min(r + oversample, n)
    if omega is None:
        omega = torch.randn((n, k), generator=generator, device=fused_s.device,
                            dtype=torch.float32)
    mine = slice(axis.index * m, (axis.index + 1) * m)
    q = torch.linalg.qr(_gather_rows(fused_s @ omega, axis))[0]
    for _ in range(n_iter):
        z = torch.linalg.qr(axis.psum(fused_s.T @ q[mine]))[0]
        q = torch.linalg.qr(_gather_rows(fused_s @ z, axis))[0]
    ub, s, _ = torch.linalg.svd(axis.psum(q[mine].T @ fused_s), full_matrices=False)
    out = (q @ ub)[:, :r] * s[None, :r]
    if r < reduced_dim:
        out = torch.cat([out, out.new_zeros((n, reduced_dim - r))], dim=1)
    return out


def sharded_engine_step(swfd_state, minibatch_state, fused_s: torch.Tensor, n_clusters,
                        generator: torch.Generator | None, *, approach: str,
                        reduced_dim: int, k_max: int, window: int, fd_shrink: str, mesh,
                        topology: str = "allgather", k_source: str = "given",
                        need_reduced: bool = True, eigengap_theta: float = 0.15,
                        background: bool = False):
    """One dense window's device step over the mesh's "data" axis, the
    counterpart of the engine's single-device ``_window_step_impl``, on
    this rank's (m, n) shard of the fused adjacency (:func:`fused_shard`):
    SWFDMC: per-shard FD fold, sketch merge, the replicated SWFD ring's
    absorb + query | else: the distributed randomized SVD -> row-sharded
    k-means | the replicated mini-batch step | spectral clustering of the
    gathered matrix | DBSCAN host glue.

    Returns (new_swfd, new_minibatch, reduced (n, dim), labels (n,), R),
    every one the same on every rank (R: the largest squared row norm of the
    fused matrix, reference main.py:61)."""
    axis = Axis(mesh, "data")
    n = fused_s.shape[1]
    r_norm = sketch_merge.global_max_row_norm(fused_s, axis)
    if approach == "SWFDMC":
        ell = swfd_state.ell
        blk, sq_fro, loss = fd.fold_sketch(fused_s, ell=ell,
                                           mode=fd.resolve_fold_mode(fd_shrink))
        merged = sketch_merge.merge(blk, ell, axis, topology)
        # per-shard losses sum; the merge's own shrink delta is not counted
        # (as in the JAX package): swfd.query caps the error with sq_fro / ell
        aux = axis.psum(torch.stack([sq_fro, loss]))
        swfd_state = swfd.absorb_summary(swfd_state, merged, n, aux[0], aux[1])
        sketch, _, _, _ = swfd.query(swfd_state, window=window, sketch_dim=reduced_dim)
        reduced = sketch.T          # rows index datapoints (reference main.py:73-76)
    elif approach == "sSpectral" and not need_reduced:
        reduced = torch.zeros((n, 0), dtype=torch.float32, device=fused_s.device)
    else:
        reduced = _dist_svd_reduce(fused_s, generator, reduced_dim, axis)

    # the count feeds k-means only; `reduced` is replicated, so the estimate is too
    if k_source == "eigengap" and approach not in ("sSpectral", "sSVDMC_mini",
                                                   *HOST_CLUSTERED):
        n_clusters = reduction.eigengap_k(reduced, k_max=k_max, theta=eigengap_theta)

    if approach == "sSpectral":
        # the count under "eigengap" comes from the normalized-affinity
        # spectrum inside spectral_clustering, as on one device
        labels = spectral.spectral_clustering(_gather_rows(fused_s, axis), n_clusters,
                                              generator, k_max=k_max, k_source=k_source,
                                              background=background)
    elif approach == "sSVDMC_mini":
        minibatch_state, labels = kmeans.minibatch_step(minibatch_state, reduced, generator)
    elif approach in HOST_CLUSTERED:
        labels = torch.zeros((n,), dtype=torch.int32, device=fused_s.device)
    else:
        labels, _ = ks.kmeans_sharded(reduced, n_clusters, generator, k_max=k_max, mesh=mesh)
        if background:
            labels = kmeans.mark_background(reduced, labels, k_max=k_max)
    return swfd_state, minibatch_state, reduced, labels, r_norm


def sharded_scanned_steps(swfd_state, minibatch_state, feats_batch: tuple, n_clusters,
                          generators, *, approach: str, k_basis: int, reduced_dim: int,
                          k_max: int, window: int, fd_shrink: str, types: tuple,
                          tags_dim: int, text_dim: int, mesh, topology: str = "allgather",
                          k_source: str = "given", eigengap_theta: float = 0.15,
                          background: bool = False):
    """W tumbling windows' sharded steps enqueued back to back, SPMD (the
    mirror of the engine's ``scanned_window_steps``, composing
    ``windows_per_batch`` with ``data_shards``): window j of the stacked
    (W, n, ...) ``feats_batch`` goes through :func:`fused_shard` and
    :func:`sharded_engine_step` with ``n_clusters[j]`` and the j-th
    generator, the SWFD ring and mini-batch state threading through, as W
    per-window sharded dispatches run them.  Returns (new_swfd,
    new_minibatch, labels (W, n), r_norms (W,)), the same on every rank."""
    labels, r_norms = [], []
    for j, (k, gen) in enumerate(zip(n_clusters, generators)):
        fused_s = fused_shard(tuple(f[j] for f in feats_batch), types, k_basis=k_basis,
                              mesh=mesh, tags_dim=tags_dim, text_dim=text_dim)
        swfd_state, minibatch_state, _, lab, r_norm = sharded_engine_step(
            swfd_state, minibatch_state, fused_s, k, gen, approach=approach,
            reduced_dim=reduced_dim, k_max=k_max, window=window, fd_shrink=fd_shrink,
            mesh=mesh, topology=topology, k_source=k_source,
            need_reduced=approach != "sSpectral", eigengap_theta=eigengap_theta,
            background=background)
        labels.append(lab)
        r_norms.append(r_norm)
    return swfd_state, minibatch_state, torch.stack(labels), torch.stack(r_norms)


def sharded_window_step(location, times, user_ids, tags, text, n_clusters,
                        generator: torch.Generator | None, *, k_basis: int,
                        reduced_dim: int, k_max: int, mesh):
    """The demonstration window step over the mesh: sharded affinity ->
    fused shard -> local FD (eigh) -> allgather merge -> row-sharded
    k-means.  Inputs are the whole window's (n, ...) tensors on every rank.
    Returns (labels (n,), reduced (n, reduced_dim))."""
    axis = Axis(mesh, "data")
    rows = axis.share(location.shape[0])
    fused_s = _row_shard_fused_adjacency(location[rows].float(), times[rows].float(),
                                         user_ids[rows], tags[rows].float(),
                                         text[rows].float(), k_basis, axis)
    st = fd.update_stream(fd.init(reduced_dim, fused_s.shape[1], fused_s.device), fused_s)
    reduced = sketch_merge.allgather_merge(st.sketch, reduced_dim, axis).T
    labels, _ = ks.kmeans_sharded(reduced, n_clusters, generator, k_max=k_max, mesh=mesh)
    return labels, reduced


# ---------------------------------------------------------------------------
# huge windows, the "rows" layout: each rank rebuilds its range of row blocks
# ---------------------------------------------------------------------------

def _check_row_blocks(n: int, block: int, p: int) -> None:
    """Row-sharded sweep geometry, one copy for the FD / SVD / spectral entry
    points (each rank takes a contiguous range of row blocks)."""
    if n % block:
        raise ValueError(f"block={block} must divide n={n} (pad upstream)")
    if (n // block) % p:
        raise ValueError(f"row blocks ({n // block}) must split evenly over data_shards={p}")


def row_share(n: int, block: int, mesh) -> dict:
    """The ``starts`` (this rank's contiguous range of row blocks) and
    ``allreduce`` (the sum over the ranks) that turn a single-device sweep
    of ``ops/blocked_affinity`` / ``ops/blocked_spectral`` into this rank's
    share of the row-sharded one; {} without a mesh (every block, nothing
    summed)."""
    if mesh is None:
        return {}
    axis = Axis(mesh, "data")
    _check_row_blocks(n, block, axis.size)
    return {"starts": list(range(0, n, block))[axis.share(n // block)],
            "allreduce": axis.psum}


def sharded_blocked_fd_sketch(cols: ba.Columns, *, ell: int, block: int, mesh,
                              topology: str = "allgather", **sweep):
    """FD sketch (ell, n) of a huge window's implicit fused adjacency, row
    blocks sharded: each rank folds its contiguous range of blocks with
    ``blocked_affinity.blocked_fd_sketch`` (its keywords ``sweep``, and its
    ``cand_fold`` gating: None = the candidate-native fold through K4 / K5
    when eligible on a CUDA device), sums ``sq_frobenius`` and
    ``shrink_loss`` over the ranks, and merges the sketches by ``topology``.
    Returns (sketch, sq_frobenius, shrink_loss), the same on every rank; the
    merge's own delta is not in the loss (as in the JAX package;
    ``swfd.query`` caps with sq_fro / ell).  ``mesh=None`` is the
    single-device fold.  Requires block | n and p | (n / block)."""
    share = row_share(cols.n, block, mesh)
    sketch, sq, loss = ba.blocked_fd_sketch(cols, ell=ell, block=block,
                                            starts=share.get("starts"), **sweep)
    if mesh is None:
        return sketch, sq, loss
    axis = Axis(mesh, "data")
    return sketch_merge.merge(sketch, ell, axis, topology), axis.psum(sq), axis.psum(loss)


def sharded_blocked_svd_reduce(cols: ba.Columns, generator: torch.Generator | None, *,
                               block: int, mesh, **sweep) -> torch.Tensor:
    """Blocked randomized SVD U·S (n, rank) of the implicit fused adjacency,
    row blocks sharded: ``blocked_affinity.blocked_svd_reduce`` (its
    keywords ``sweep``; reference TruncatedSVD, matrix_operations.py:143-147)
    over this rank's blocks, its A·V rows assembled and Aᵀ·Q partials summed
    by one all-reduce each, the QRs replicated; the same on every rank."""
    return ba.blocked_svd_reduce(cols, generator, block=block,
                                 **row_share(cols.n, block, mesh), **sweep)


def sharded_spectral_embedding(cols: ba.Columns, generator: torch.Generator | None, *,
                               block: int, mesh, **sweep):
    """Normalized-cuts spectral embedding of the implicit fused adjacency,
    row blocks sharded: ``blocked_spectral.spectral_embedding_blocked`` (its
    keywords ``sweep``) with the degree and symmetrized M·V sweeps over this
    rank's blocks, all-reduced.  Returns (ritz (n, k_max + oversample),
    eigenvalues), descending and the same on every rank; feed
    ``blocked_spectral.labels_from_ritz`` / ``eigengap_k_from_spectrum``."""
    return bspec.spectral_embedding_blocked(cols, generator, block=block,
                                            **row_share(cols.n, block, mesh), **sweep)
