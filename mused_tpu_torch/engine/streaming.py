"""Streaming engine: the tumbling/sliding-window pipeline — port of the
single-device path of ``mused_tpu/engine/streaming.py`` (reference
main.py:13-130).

Per window:

    featurize (host thread) -> fuse (4 kNN graphs + username, OR) ->
    reduce (SWFD fold + query | randomized SVD) -> cluster (k-means,
    mini-batch k-means, spectral, or DBSCAN on the host side) ->
    cross-window matching (host) -> metric accumulation (host)

Window semantics kept from the reference: a window fires at
``len(window) == window_size and (i+1)*step_window_ratio % window_size == 0``;
the per-window cluster count is the number of distinct ground-truth labels
in it (``k_estimate="labels"``, a reference quirk), ``n_clusters_total``
(``"fixed"``) or a label-free spectral estimate (``"eigengap"``); the SWFD
sketch persists across the stream and SWFDMC's reduced matrix is the
transposed sketch; a failed matching falls back to an all-noise window.
Approaches: SWFDMC, the sSVDMC family, sSpectral (spectral clustering of the
fused graph, no SVD), DBSCAN_incr / DBSCAN_centr (DBSCAN on the reduced
window, host glue); any other name runs the SVD and k-means, as the
reference does.  ``background_bucket`` re-labels the far mode of the
clustering's residuals -1 (``kmeans.mark_background``).

A window is dispatched (:meth:`StreamingEngine.dispatch_window`: fuse and
device step, state advanced) and then finalized
(:meth:`StreamingEngine.finalize_window`: the host label pull, host
clustering glue and matching), so a caller may keep windows in flight; the
pending record holds the post-window state that a checkpoint saves.
``process_streaming_data`` keeps up to two windows dispatched ahead unless
it checkpoints, prints or runs huge windows.

The scanned multi-window dispatch (``windows_per_batch`` = W > 1, on
dense tumbling windows of the batchable approaches; see
:func:`resolve_windows_per_batch`) enqueues a group of W windows' device
steps with no host read between them (:func:`scanned_group_dispatch`) and
pulls their labels in one transfer; it threads the same state and draws
the same numbers as per-window dispatch, so its labels are the same.  The
offline loop keeps one group dispatched ahead unless it checkpoints, and
checkpoints only at full-group boundaries.

The fused graph's kNN modalities go through the hand-written kernel
(``ops/kernels/affinity_kernel``) when ``use_pallas_affinity`` is None or
True on a CUDA device; on the CPU, None takes the plain dense path (as the
JAX engine does off the TPU) and True runs the kernel entry point, whose
wrapper takes its plain version for CPU tensors.

Randomness: window w of a stream seeded s draws from a ``torch.Generator``
on the engine's device seeded ``window_seed(s, w) = s * 2**32 + w`` (mod
2**63): randomized-SVD test matrix first, then the k-means++ draws.

Huge windows (over ``LARGE_WINDOW_ROWS`` rows, or ``force_blocked_window``)
never build the (n, n) fused adjacency: featurized rows pad to a multiple of
the 2048-row block, ``ops/blocked_affinity`` builds the window's column
panels once, and row blocks are rebuilt inside the reductions.  SWFDMC folds
them into an FD sketch (the candidate-native fold through K2-K5 when
eligible, else the dense fold) and clusters the transposed sketch, without
the sliding ring; the sSVDMC family runs the blocked randomized SVD (K2 / K3
per block) and then k-means or the mini-batch step; sSpectral runs blocked
spectral clustering on the columns (``ops/blocked_spectral``, no SVD);
DBSCAN_centr runs the blocked SVD, blocked DBSCAN (``ops/blocked_dbscan``)
and its own centroid matching.  A huge window runs to completion inside its
dispatch.

Spans (``utils/profiling``, while they record): each window's ``featurize``,
keyed by its index, in whichever thread featurizes it (the ingest thread
offline), and per huge window the counter ``memory.device_allocs``: the
caching allocator's device allocations and frees across the window.  The
engine's own ``timer`` spans are recorded too.

Multi-device layouts (``data_shards=p``): every rank of a torch.distributed
process group of p ranks (one per device, set up by the caller, e.g.
``torchrun``) runs the engine on the same stream and returns the same
clusters.  ``huge_window_layout="rows"`` (the default) shards window rows
over a (p, 1) mesh: a dense window's step runs SPMD (``parallel/sharded``:
fused row shards, the FD sketch merge by ``merge_topology`` or the
distributed SVD, row-sharded k-means), and a huge window's blocked
reductions split its row blocks over the ranks, each holding the whole
window's column panels.  ``"columns"`` / ``"grid"`` shard a huge window's
features instead: each rank moves only its share of the rows to its
device, and ``parallel/colsharded`` runs the fold, the blocked SVD or
blocked spectral over the mesh.  Only rank 0 writes checkpoints
(``parallel/mesh.write_once``; every rank goes on once the write is done),
and the checkpointed state is replicated, so a stream resumes on any number
of ranks.

``matching="centroid"`` keeps cluster ids stable by nearest-centroid
assignment in the input feature space (``ops/matching.CentroidMatcher``),
on numeric streams and dense windows only, as in the JAX package.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

from mused_tpu_torch.data import features as feat
from mused_tpu_torch.data.ingest import WindowPrefetcher, pad_window_features, to_device
from mused_tpu_torch.ops import affinity, blocked_affinity as ba, blocked_spectral as bspec
from mused_tpu_torch.ops import dbscan, fd, kmeans, matching, reduction, spectral, swfd
from mused_tpu_torch.ops.blocked_dbscan import dbscan_blocked
from mused_tpu_torch.ops.kernels import affinity_kernel as ak
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.parallel import mesh as mesh_mod, sharded
from mused_tpu_torch.utils import metrics as metrics_mod
from mused_tpu_torch.utils import profiling
from mused_tpu_torch.utils.config import PipelineConfig

LARGE_WINDOW_ROWS = 32_768   # beyond this, windows take the blocked path
LARGE_BLOCK = 2_048          # rows per rebuilt block of a huge window
STANDARD_TYPES = ["location", "time", "username", "tags", "text"]
HOST_CLUSTERED = ("DBSCAN_incr", "DBSCAN_centr")   # DBSCAN on the host side


class StreamState(NamedTuple):
    """Cross-window device state."""

    swfd: swfd.SWFDState
    minibatch: kmeans.MiniBatchState


class _PendingWindow(NamedTuple):
    """A dispatched window whose results are not yet pulled.

    ``state`` is the post-window state: by finalize time ``engine.state``
    may already hold a later window's, and a checkpoint must save the state
    of the last finalized window.  ``clusters`` holds the result of a path
    that completes inside its dispatch (huge windows)."""

    window_index: int
    reduced: torch.Tensor | None = None
    labels: torch.Tensor | None = None
    r_norm: torch.Tensor | None = None
    verbose: bool = False
    state: StreamState | None = None
    clusters: np.ndarray | None = None
    stable_feats: np.ndarray | None = None    # centroid matching's (n, d) rows


def _auto_col_shards(p: int) -> int:
    """Balanced grid factor: the largest divisor of p <= sqrt(p)."""
    best, d = 1, 1
    while d * d <= p:
        if p % d == 0:
            best = d
        d += 1
    return best


def _layout_mesh(cfg: PipelineConfig, huge: bool, device: torch.device):
    """The mesh of a multi-device layout ((p, 1) for "rows" and "columns",
    the grid's (p / col_shards, col_shards)), or None on one device; the JAX
    engine's checks, with its messages (the layout's coherence first, then
    the process group)."""
    if cfg.huge_window_layout not in ("rows", "columns", "grid"):
        raise ValueError(
            f"huge_window_layout={cfg.huge_window_layout!r}: expected "
            "'rows' (replicated features, row blocks sharded), "
            "'columns' (features column-sharded — the capacity layout) "
            "or 'grid' (row groups x column shards)")
    col_layout = cfg.huge_window_layout in ("columns", "grid")
    if col_layout and cfg.huge_window_fused_select is False:
        raise ValueError(
            "huge_window_layout='columns'/'grid' IS the fused "
            "stride-binned selection sharded over the mesh (a full sim "
            "strip cannot exist on one chip there); "
            "huge_window_fused_select=False is contradictory")
    if cfg.data_shards <= 1:
        if col_layout:
            raise ValueError(
                f"huge_window_layout={cfg.huge_window_layout!r} needs "
                "data_shards > 1 (there is nothing to shard the features "
                "over on one chip)")
        return None
    if cfg.window_size % cfg.data_shards:
        raise ValueError(
            f"window_size={cfg.window_size} must be divisible by "
            f"data_shards={cfg.data_shards} (rows shard evenly)")
    if col_layout and not huge:
        raise ValueError(
            f"huge_window_layout={cfg.huge_window_layout!r} shards "
            "the rematerialized huge-window sweep; dense windows "
            "(<= 32k rows, no force_blocked_window) replicate "
            "nothing worth sharding — use 'rows'")
    n_model = 1
    if cfg.huge_window_layout == "grid":
        if cfg.huge_window_col_shards:
            n_model = cfg.huge_window_col_shards
            if n_model < 2 or cfg.data_shards % n_model:
                raise ValueError(
                    f"huge_window_col_shards={n_model} must be >= 2 and "
                    f"divide data_shards={cfg.data_shards} (use "
                    "layout='columns' for all-column sharding)")
        else:
            n_model = _auto_col_shards(cfg.data_shards)
            if n_model < 2:
                raise ValueError(
                    f"data_shards={cfg.data_shards} has no balanced "
                    "grid factorization (it is prime or 2); pass "
                    "huge_window_col_shards explicitly or use "
                    "layout='columns'")
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if world != cfg.data_shards:
        raise ValueError(
            f"data_shards={cfg.data_shards} needs a torch.distributed process group "
            f"of {cfg.data_shards} ranks, one per device, and this process "
            + (f"is one of {world}" if world else "has none")
            + " (start the ranks with torchrun --nproc-per-node "
            f"{cfg.data_shards}, or call init_process_group)")
    return mesh_mod.make_mesh(cfg.data_shards // n_model, n_model, device.type)


def window_seed(seed: int, window_index: int) -> int:
    """Seed of window ``window_index``'s generator (see module docstring)."""
    return (int(seed) * 2**32 + int(window_index)) % 2**63


def window_generator(seed: int, window_index: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(window_seed(seed, window_index))
    return gen


def configure_precision() -> None:
    """fp32 products stay true fp32 on the card (the JAX package's
    ``Precision.HIGHEST``): no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------

def standard_kernel_graphs(location, times, user_ids, tags_raw, text_raw, text_cnt,
                           tags_valid, *, k_basis: int, tags_dim: int, text_dim: int,
                           sparse: bool) -> list[torch.Tensor]:
    """The five modality graphs of a standard window, every kNN graph built
    by the hand-written kernel (counterpart of ``_fuse_standard_pallas``):

      location  chord3 on unit xyz (keeps city-scale resolution)
      time      l1 on window-centred timestamps, 3*k_basis neighbours
      username  equality broadcast (no kernel)
      tags      in-kernel Jaccard on the multi-hot
      text      TF-IDF scale + L2-normalize outside, dot inside
    """
    if sparse:
        tags = affinity.counts_from_tokens(tags_raw, None, tags_dim)
        text = affinity.counts_from_tokens(text_raw, text_cnt, text_dim)
    else:
        tags, text = tags_raw.float(), text_raw.float()
    xt, xv = affinity.tfidf_rows(text)
    return [kernel_graph(location, "location", k_basis), kernel_graph(times, "time", k_basis),
            affinity.username_adjacency(user_ids.to(torch.int32)),
            ak.knn_adjacency(tags.contiguous(), tags_valid.to(torch.bool), k_basis,
                             metric="jaccard"),
            ak.knn_adjacency(xt.contiguous(), xv, k_basis, metric="dot")]


def _fuse_standard_kernel(*feats, **kw) -> torch.Tensor:
    return affinity.fuse(standard_kernel_graphs(*feats, **kw))


def _fuse_standard_plain(location, times, user_ids, tags_raw, text_raw, text_cnt,
                         tags_valid, *, k_basis: int, tags_dim: int, text_dim: int,
                         sparse: bool) -> torch.Tensor:
    """The same fusion on the plain dense path (haversine location,
    ``affinity.multimodal_fused_adjacency``); counterpart of
    ``_fuse_standard`` and ``_fuse_standard_sparse``."""
    if sparse:
        tags = affinity.counts_from_tokens(tags_raw, None, tags_dim)
        text = affinity.counts_from_tokens(text_raw, text_cnt, text_dim)
    else:
        tags, text = tags_raw.float(), text_raw.float()
    return affinity.multimodal_fused_adjacency(
        location.float(), times.float(), user_ids.to(torch.int32), tags, text,
        k_basis=k_basis, tags_valid=tags_valid.to(torch.bool))


def kernel_graph(m: torch.Tensor, t: str, k_basis: int) -> torch.Tensor:
    """One numeric modality's kNN graph through the kernel: "embedding"
    cosine (dot on unit rows), "location" chord3 on unit xyz, "time" l1 with
    3*k_basis neighbours, anything else Euclidean with k_basis-1."""
    m = m.float()
    if t == "embedding":
        x, valid = affinity.normalized_embedding(m)
        return ak.knn_adjacency(x.contiguous(), valid, k_basis, metric="dot")
    if t == "location":
        valid = torch.all(torch.isfinite(m), dim=1)
        xyz = ak.location_to_unit_xyz(torch.where(valid[:, None], m, 0.0))
        return ak.knn_adjacency(xyz.contiguous(), valid, k_basis, metric="chord3")
    if t == "time":
        valid = affinity.time_valid(m)
        return ak.knn_adjacency(torch.where(valid[:, None], m, 0.0).contiguous(), valid,
                                3 * k_basis, metric="l1")
    valid = torch.all(torch.isfinite(m), dim=1)
    return ak.knn_adjacency(torch.where(valid[:, None], m, 0.0).contiguous(), valid,
                            max(1, k_basis) - 1, metric="euclidean")


def plain_graph(m: torch.Tensor, t: str, k_basis: int) -> torch.Tensor:
    """:func:`kernel_graph`'s modality on the plain dense path (haversine
    location)."""
    mk = {"embedding": affinity.embedding_adjacency,
          "location": affinity.location_adjacency,
          "time": affinity.time_adjacency}
    return mk.get(t, affinity.euclidean_adjacency)(m.float(), k_basis)


def _fuse_generic(mats: Sequence[torch.Tensor], *, k_basis: int, types: Sequence[str],
                  use_kernel: bool = False) -> torch.Tensor:
    """Numeric-modality path: per-type kNN + OR fusion."""
    graph = kernel_graph if use_kernel else plain_graph
    return affinity.fuse([graph(m, t, k_basis) for m, t in zip(mats, types)])


def types_for(features, modality_types) -> tuple:
    """Feature-layout tag: ("standard_sparse",) | ("standard",) | generic."""
    if isinstance(features, feat.SparseWindowFeatures):
        return ("standard_sparse",)
    if isinstance(features, feat.WindowFeatures):
        return ("standard",)
    return tuple(modality_types)


def fuse_dispatch(feats: tuple, *, types: tuple, use_kernel: bool, k_basis: int,
                  tags_dim: int, text_dim: int) -> torch.Tensor:
    """Fused adjacency of one window's device tensors for either layout."""
    if types[0] in ("standard_sparse", "standard"):
        sparse = types[0] == "standard_sparse"
        if sparse:
            loc, tim, uid, tags, text, text_cnt, tags_valid = feats
        else:
            loc, tim, uid, tags, text, tags_valid = feats
            text_cnt = None
        fn = _fuse_standard_kernel if use_kernel else _fuse_standard_plain
        return fn(loc, tim, uid, tags, text, text_cnt, tags_valid, k_basis=k_basis,
                  tags_dim=tags_dim, text_dim=text_dim, sparse=sparse)
    return _fuse_generic(feats, k_basis=k_basis, types=types, use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# window step
# ---------------------------------------------------------------------------

def _window_step_impl(state: StreamState, fused: torch.Tensor, n_clusters,
                      generator: torch.Generator, *, approach: str, k_basis: int,
                      reduced_dim: int, k_max: int, window: int,
                      fd_shrink: str = "subspace", k_source: str = "given",
                      need_reduced: bool = True, eigengap_theta: float = 0.15,
                      background: bool = False):
    """Device portion of one window given its fused adjacency.

    Returns (new_state, reduced (n, reduced_dim), labels (n,)); the labels
    are zeros for the host-clustered DBSCAN approaches.  ``need_reduced`` is
    False when nothing reads sSpectral's reduction, which is then skipped.
    Under ``k_source="eigengap"`` the count comes from the reduced window's
    energies, or for sSpectral from the normalized-affinity spectrum."""
    n = fused.shape[0]
    if approach == "SWFDMC":
        # one whole-window fold sealed into the sliding ring; the reference
        # feeds all n fused rows at every trigger, so with N = window the
        # sketch covers exactly this trigger's rows
        blk, sq_fro, loss = fd.fold_sketch(fused, ell=state.swfd.ell,
                                           mode=fd.resolve_fold_mode(fd_shrink))
        new_swfd = swfd.absorb_summary(state.swfd, blk, n, sq_fro, loss)
        sketch, _, _, _ = swfd.query(new_swfd, window=window, sketch_dim=reduced_dim)
        reduced = sketch.T          # rows index datapoints (reference main.py:73-76)
        state = state._replace(swfd=new_swfd)
    elif approach == "sSpectral" and not need_reduced:
        reduced = torch.zeros((n, 0), dtype=torch.float32, device=fused.device)
    else:
        reduced = reduction.svd_reduce(fused, reduced_dim, generator)

    # the count feeds k-means only (the JAX package drops it elsewhere)
    if k_source == "eigengap" and approach not in ("sSpectral", "sSVDMC_mini",
                                                   *HOST_CLUSTERED):
        n_clusters = reduction.eigengap_k(reduced, k_max=k_max, theta=eigengap_theta)

    if approach == "sSpectral":
        labels = spectral.spectral_clustering(fused, n_clusters, generator, k_max=k_max,
                                              k_source=k_source, background=background)
    elif approach == "sSVDMC_mini":
        # no background bucket: the centroids are cross-window running means
        new_mb, labels = kmeans.minibatch_step(state.minibatch, reduced, generator)
        state = state._replace(minibatch=new_mb)
    elif approach in HOST_CLUSTERED:
        labels = torch.zeros((n,), dtype=torch.int32, device=fused.device)
    else:
        labels, _ = kmeans.kmeans(reduced, n_clusters, generator, k_max=k_max)
        if background:
            labels = kmeans.mark_background(reduced, labels, k_max=k_max)
    return state, reduced, labels


def effective_verbose(cfg: PipelineConfig) -> bool:
    """The reference's debug prints run only on small windows (reference
    main.py:35-37); the dispatch-ahead loop keys off this."""
    return cfg.verbose and cfg.window_size <= 1000


def match_window_labels(prev_clusters, labels, cfg: PipelineConfig, *, method: str,
                        centroid_matcher=None, stable_feats=None) -> np.ndarray:
    """Cross-window matching (min_overlap=3), or the centroid registry under
    ``matching="centroid"``, + the all-noise fallback for a failed window
    (reference main.py:105-116)."""
    if centroid_matcher is not None:
        clusters = centroid_matcher.match(stable_feats, np.asarray(labels))
    else:
        clusters = matching.match_clusters(
            prev_clusters, np.asarray(labels), method=method, min_overlap=3,
            sinkhorn_reg=cfg.sinkhorn_reg, sinkhorn_iters=cfg.sinkhorn_iters)
    if clusters is None or len(clusters) == 0:
        clusters = np.full(cfg.window_size, 0)
    return np.asarray(clusters)


# approaches whose per-window host glue is only the label matching (no host
# clustering, unlike the DBSCAN family): eligible for the scanned dispatch
BATCHABLE_APPROACHES = ("SWFDMC", "sSVDMC", "sSVDMC_hung", "sSVDMC_pot",
                        "sSVDMC_mini", "sSpectral")


def resolve_windows_per_batch(cfg: PipelineConfig, *, standard_types: bool,
                              step_window_ratio: int | None = None,
                              checkpoint_dir: str | None = None,
                              backend: str | None = None,
                              n_windows: int | None = None) -> int:
    """``cfg.windows_per_batch`` (None = auto) as a concrete W: the JAX
    package's rule, which the offline loop and serving share.

    ``backend`` is the device type the run is on.  Auto gives W > 1 only on
    ``"tpu"`` (where it hid a link's round trip), so on the card or the CPU
    auto resolves to per-window dispatch, as the JAX package resolves it on
    any backend but the TPU; there, auto is 4, widened to 8 for a stream of
    known length (``n_windows``) when the padded tail group costs no extra
    window steps, and checkpointing or verbose keep it per-window.  An
    explicit W > 1 is clamped to 1 when the config cannot run scanned at
    all: a non-batchable approach (the group has no host clustering glue),
    a sliding ratio, huge windows, or centroid matching on standard
    streams."""
    ratio = cfg.step_window_ratio if step_window_ratio is None else step_window_ratio
    hard_eligible = (cfg.approach in BATCHABLE_APPROACHES and ratio == 1
                     and not cfg.force_blocked_window
                     and cfg.window_size <= LARGE_WINDOW_ROWS
                     and not (cfg.matching == "centroid" and standard_types))
    batch_w, auto_w = cfg.windows_per_batch, 4
    if batch_w is None:
        if n_windows is not None and n_windows >= 2 * auto_w:
            wide = 2 * auto_w
            if -(-n_windows // wide) * wide <= -(-n_windows // auto_w) * auto_w:
                auto_w = wide
        batch_w = auto_w if (backend == "tpu" and hard_eligible and not checkpoint_dir
                             and not effective_verbose(cfg)) else 1
    batch_w = max(int(batch_w), 1)
    return batch_w if hard_eligible else 1


def stack_window_features(feats_list: list[tuple]) -> tuple:
    """A group's per-window featurized tuples stacked into one (W, n, ...)
    numpy array per component.  Trimmed token arrays differ in width across
    windows and pad to the group's widest (ids with the -1 invalid id,
    uint8 counts with 0), which the fusion reads as no token."""
    def stack(j):
        parts = [np.asarray(f[j]) for f in feats_list]
        widths = {p.shape[1] for p in parts if p.ndim == 2}
        if len(widths) > 1:
            w = max(widths)
            fill = -1 if np.issubdtype(parts[0].dtype, np.signedinteger) else 0
            parts = [np.pad(p, ((0, 0), (0, w - p.shape[1])), constant_values=fill)
                     for p in parts]
        return np.stack(parts)

    return tuple(stack(j) for j in range(len(feats_list[0])))


def scanned_types_for(modality_types, features_cfg) -> tuple:
    """The layout tag of :func:`types_for` from the modality types and the
    feature config (a stacked group has no feature objects to read it from)."""
    if list(modality_types) == STANDARD_TYPES:
        return ("standard_sparse",) if features_cfg.sparse else ("standard",)
    return tuple(modality_types)


def scanned_window_steps(state: StreamState, feats_batch: tuple, n_clusters: Sequence,
                         generators: Iterable[torch.Generator], *, approach: str,
                         k_basis: int, reduced_dim: int, k_max: int, window: int,
                         fd_shrink: str, types: tuple, use_kernel: bool, tags_dim: int,
                         text_dim: int, k_source: str = "given",
                         eigengap_theta: float = 0.15, background: bool = False):
    """W tumbling windows' device steps, enqueued back to back: window j of
    the stacked (W, n, ...) ``feats_batch`` is fused (``fuse_dispatch``) and
    stepped (``_window_step_impl``) with ``n_clusters[j]`` and the j-th
    generator, the state threading through, exactly as W per-window
    dispatches run them.  The loop pulls nothing to the host.  Returns
    (state, labels (W, n), r_norms (W,)) on the device, r_norm being a
    window's largest squared fused row norm (reference main.py:61)."""
    labels, r_norms = [], []
    for j, (k, gen) in enumerate(zip(n_clusters, generators)):
        fused = fuse_dispatch(tuple(f[j] for f in feats_batch), types=types,
                              use_kernel=use_kernel, k_basis=k_basis, tags_dim=tags_dim,
                              text_dim=text_dim)
        r_norms.append(torch.max(torch.sum(fused * fused, dim=1)))
        state, _, lab = _window_step_impl(
            state, fused, k, gen, approach=approach, k_basis=k_basis,
            reduced_dim=reduced_dim, k_max=k_max, window=window, fd_shrink=fd_shrink,
            k_source=k_source, need_reduced=approach != "sSpectral",
            eigengap_theta=eigengap_theta, background=background)
        labels.append(lab)
    return state, torch.stack(labels), torch.stack(r_norms)


class StreamingEngine:
    """Host orchestration of the streaming pipeline for one approach on one
    device, the card unless the caller asks for the CPU (``device="cpu"``).
    ``"cuda"`` without a card raises; nothing moves to the CPU behind the
    caller's back."""

    def __init__(self, cfg: PipelineConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        configure_precision()
        n = cfg.window_size
        self.huge = n > LARGE_WINDOW_ROWS or cfg.force_blocked_window
        # data_shards > 1: the rows ("rows") or the features ("columns" /
        # "grid") shard over this mesh's ranks
        self.mesh = _layout_mesh(cfg, self.huge, self.device)
        # a sharded sweep gives each rank an equal share of row blocks: blocks
        # from the per-rank range, rows padded to block * p
        p = 1 if self.mesh is None else cfg.data_shards
        self.block = min(LARGE_BLOCK, max(n // p, 1))
        self.pad = (-n) % (self.block * p) if self.huge else 0
        if self.huge and cfg.approach == "DBSCAN_incr":
            raise ValueError(
                "DBSCAN_incr accumulates every inserted point (exact incremental "
                "semantics) and runs dense-window-only; huge windows need "
                f"window_size <= {LARGE_WINDOW_ROWS} or DBSCAN_centr")
        if cfg.matching == "centroid" and self.huge:
            raise ValueError(
                "matching='centroid' runs on the dense-window path (it needs "
                "the window's numeric feature matrix); huge windows use the "
                "reference positional matching or DBSCAN_centr")
        if cfg.k_estimate not in ("labels", "fixed", "eigengap"):
            raise ValueError(
                f"k_estimate={cfg.k_estimate!r}: expected 'labels', 'fixed' or "
                "'eigengap'")
        self.k_max = max(cfg.n_clusters_total, 2)
        self.use_kernel = (cfg.use_pallas_affinity if cfg.use_pallas_affinity is not None
                           else self.device.type == "cuda")
        ell = min(cfg.reduced_dim, n)
        # summary blocks are whole windows: block_rows = n (2 ring slots); the
        # huge path clusters its sketch directly and needs no ring
        swfd_state = (swfd.init(n, n, ell, block_rows=n, device=self.device)
                      if cfg.approach == "SWFDMC" and not self.huge
                      else swfd.init(1, 1, 1, block_rows=1, device=self.device))
        self.state = StreamState(
            swfd=swfd_state,
            minibatch=kmeans.minibatch_init(self.k_max, cfg.reduced_dim, self.device))
        self.incr_clusterer: dbscan.IncrementalDBSCAN | None = None
        self.prev_centroids = None
        self.prev_centroid_labels = None
        # matching="centroid": the stable-id registry in input feature space
        self.centroid_matcher = (matching.CentroidMatcher(cfg.centroid_max_dist)
                                 if cfg.matching == "centroid" else None)
        self.swfd_R: float | None = None   # recorded like reference main.py:61
        self.timer = profiling.SpanTimer(self.device)

    # ------------------------------------------------------------------
    def host_snapshot(self) -> dict:
        """Picklable host-side cross-window state (the JAX package's keys)."""
        inc, cm = self.incr_clusterer, self.centroid_matcher
        return {"swfd_R": self.swfd_R,
                "prev_centroids": self.prev_centroids,
                "prev_centroid_labels": self.prev_centroid_labels,
                "incr_state": None if inc is None else inc.snapshot(),
                "centroid_matcher": None if cm is None else cm.snapshot()}

    def restore(self, device_state: StreamState, host: dict) -> None:
        """Inverse of (state, host_snapshot()): resume from a checkpoint."""
        self.state = device_state
        self.swfd_R = host.get("swfd_R")
        self.prev_centroids = host.get("prev_centroids")
        self.prev_centroid_labels = host.get("prev_centroid_labels")
        if host.get("incr_state") is not None:
            self.incr_clusterer = dbscan.IncrementalDBSCAN.from_snapshot(
                host["incr_state"], device=self.device)
        if host.get("centroid_matcher") is not None:
            self.centroid_matcher = matching.CentroidMatcher.from_snapshot(
                host["centroid_matcher"])

    def _match_method(self) -> str:
        if self.cfg.matching == "auto":
            return "pot" if self.cfg.approach == "sSVDMC_pot" else "hungarian"
        return self.cfg.matching

    def _k_plan(self, window_true_labels) -> tuple[int, str]:
        """Per-window cluster count -> (host value, ``k_source``): "labels"
        is the reference's ground-truth count, "fixed" n_clusters_total,
        "eigengap" the device estimate (host value = the cap)."""
        if self.cfg.k_estimate == "fixed":
            return self.k_max, "given"
        if self.cfg.k_estimate == "eigengap":
            return self.k_max, "eigengap"
        return int(len(np.unique(window_true_labels))), "given"

    def _stable_feats(self, feats_host) -> np.ndarray | None:
        """Centroid matching's per-row matrix in the input feature space
        (which, unlike the window's embedding, does not rotate between
        windows), from the host features; None unless matching="centroid"."""
        if self.centroid_matcher is None:
            return None
        if isinstance(feats_host, (feat.WindowFeatures, feat.SparseWindowFeatures)):
            raise ValueError(
                "matching='centroid' supports numeric-modality streams "
                "(embeddings etc.); standard SED2012 streams use the "
                "reference positional matching or the DBSCAN_centr approach")
        return stable_feature_matrix(feats_host)

    def featurize(self, window_modalities, modality_types, *, key=None,
                  parent: str | None = None):
        """Host featurization only (runs in the ingest thread); a huge
        window's rows are padded here with invalid rows to a block multiple.
        Recorded as the span ``featurize`` under ``key`` (the window index)
        and ``parent``."""
        with profiling.span("featurize", key=key, parent=parent):
            if list(modality_types) == STANDARD_TYPES:
                wf = feat.featurize_window(*window_modalities, self.cfg.features)
                return pad_window_features(wf, self.pad) if self.pad else wf
            mats = tuple(np.asarray(m, np.float32) for m in window_modalities)
            if self.pad:
                mats = tuple(np.pad(m, ((0, self.pad), (0, 0)), constant_values=np.nan)
                             for m in mats)
            return mats

    def fuse_from_features(self, feats_host, feats_dev: tuple, modality_types,
                           use_kernel: bool | None = None) -> torch.Tensor:
        """Fused adjacency of one window from its device tensors."""
        fc = self.cfg.features
        return fuse_dispatch(feats_dev, types=types_for(feats_host, modality_types),
                             use_kernel=self.use_kernel if use_kernel is None else use_kernel,
                             k_basis=self.cfg.k_basis, tags_dim=fc.tags_hash_dim,
                             text_dim=fc.text_hash_dim)

    def fused_adjacency(self, window_modalities, modality_types) -> torch.Tensor:
        """Host featurization + device fusion of one window (the batch
        engine's dense path fuses its whole subset through it)."""
        host = self.featurize(window_modalities, modality_types)
        return self.fuse_from_features(host, to_device(host, self.device), modality_types)

    def process_window(self, feats_host, feats_dev: tuple, modality_types,
                       window_true_labels, window_index: int, prev_clusters) -> np.ndarray:
        """One full window: dispatch, then finalize."""
        pending = self.dispatch_window(feats_host, feats_dev, modality_types,
                                       window_true_labels, window_index, prev_clusters)
        return self.finalize_window(pending, prev_clusters)

    def dispatch_window(self, feats_host, feats_dev: tuple, modality_types,
                        window_true_labels, window_index: int,
                        prev_clusters) -> _PendingWindow:
        """Fuse and run window ``window_index``'s device step without pulling
        its results; ``self.state`` advances.  Matching is host-only and feeds
        nothing back to the device, so finalizing later changes no numerics.
        A huge window runs to completion here (its matching needs
        ``prev_clusters``)."""
        if self.huge:
            allocs = self._device_allocs()
            clusters = self.process_window_large(feats_host, feats_dev, modality_types,
                                                 window_true_labels, window_index,
                                                 prev_clusters)
            after = self._device_allocs()
            if allocs is not None and after is not None:
                profiling.counter("memory.device_allocs", after - allocs, key=window_index)
            return _PendingWindow(window_index=window_index, clusters=clusters,
                                  state=self.state)
        cfg = self.cfg
        verbose = effective_verbose(cfg)
        if verbose:   # small-window debug prints (reference main.py:35-37)
            print(f"[window {window_index}] true labels: "
                  f"{np.asarray(window_true_labels)}")
        n_clusters, k_source = self._k_plan(window_true_labels)
        gen = window_generator(cfg.seed, window_index, self.device)
        stable_feats = self._stable_feats(feats_host)
        if self.mesh is not None:
            return self._dispatch_sharded(feats_host, feats_dev, modality_types, n_clusters,
                                          k_source, gen, window_index, verbose, stable_feats)
        with self.timer.span("fuse"):
            fused = self.fuse_from_features(feats_host, feats_dev, modality_types)
        if verbose:
            print(f"[window {window_index}] fused adjacency "
                  f"(sum={float(fused.sum()):.0f}):\n{fused.cpu().numpy()}")
        # the reference's sketch bound R: the first window's largest squared
        # row norm (reference main.py:61), pulled at finalize
        r_norm = (torch.max(torch.sum(fused * fused, dim=1))
                  if cfg.approach == "SWFDMC" and self.swfd_R is None else None)
        with self.timer.span("device_step"):
            self.state, reduced, labels = _window_step_impl(
                self.state, fused, n_clusters, gen, approach=cfg.approach,
                k_basis=cfg.k_basis, reduced_dim=cfg.reduced_dim, k_max=self.k_max,
                window=cfg.window_size, fd_shrink=cfg.fd_shrink, k_source=k_source,
                need_reduced=cfg.approach != "sSpectral" or verbose,
                eigengap_theta=cfg.eigengap_theta, background=cfg.background_bucket)
        return _PendingWindow(window_index=window_index, reduced=reduced, labels=labels,
                              r_norm=r_norm, verbose=verbose, state=self.state,
                              stable_feats=stable_feats)

    def _dispatch_sharded(self, feats_host, feats_dev: tuple, modality_types, n_clusters,
                          k_source: str, gen, window_index: int, verbose: bool,
                          stable_feats) -> _PendingWindow:
        """A dense window's step SPMD over ``self.mesh``'s rows
        (``parallel/sharded.sharded_engine_step``): every rank holds the whole
        window and ends with the same state, reduction and labels."""
        cfg = self.cfg
        with self.timer.span("fuse"):
            fused_s = sharded.fused_shard(
                tuple(feats_dev), types_for(feats_host, modality_types), k_basis=cfg.k_basis,
                mesh=self.mesh, tags_dim=cfg.features.tags_hash_dim,
                text_dim=cfg.features.text_hash_dim)
        with self.timer.span("device_step"):
            new_swfd, new_mb, reduced, labels, r_norm = sharded.sharded_engine_step(
                self.state.swfd, self.state.minibatch, fused_s, n_clusters, gen,
                approach=cfg.approach, reduced_dim=cfg.reduced_dim, k_max=self.k_max,
                window=cfg.window_size, fd_shrink=cfg.fd_shrink,
                mesh=self.mesh, topology=cfg.merge_topology, k_source=k_source,
                need_reduced=cfg.approach != "sSpectral" or verbose,
                eigengap_theta=cfg.eigengap_theta, background=cfg.background_bucket)
            self.state = StreamState(swfd=new_swfd, minibatch=new_mb)
        return _PendingWindow(window_index=window_index, reduced=reduced, labels=labels,
                              r_norm=r_norm if cfg.approach == "SWFDMC" else None,
                              verbose=verbose, state=self.state, stable_feats=stable_feats)

    def finalize_window(self, pending: _PendingWindow, prev_clusters) -> np.ndarray:
        """Pull a dispatched window's results and run the host half (DBSCAN
        glue, matching, fallback).  Call in window order; ``prev_clusters``
        is the previous window's matched labels."""
        if pending.clusters is not None:      # huge window: already done
            return pending.clusters
        cfg = self.cfg
        if self.swfd_R is None and pending.r_norm is not None:
            self.swfd_R = float(pending.r_norm)
        if pending.verbose:   # reference main.py:99-103
            print(f"[window {pending.window_index}] reduced:\n"
                  f"{pending.reduced.cpu().numpy()}")
        with self.timer.span("device_sync"):
            if cfg.approach in HOST_CLUSTERED:
                reduced, labels = pending.reduced.cpu().numpy(), None
            else:
                reduced, labels = None, pending.labels.cpu().numpy()
        return self._cluster_and_match(reduced, labels, pending.window_index,
                                       prev_clusters, pending.verbose, pending.stable_feats)

    def _cluster_and_match(self, reduced, labels, window_index: int, prev_clusters,
                           verbose: bool = False,
                           stable_feats: np.ndarray | None = None) -> np.ndarray:
        """Host clustering glue (DBSCAN_incr / DBSCAN_centr) + cross-window
        matching (the centroid registry reads ``stable_feats``) + the failure
        fallback."""
        cfg = self.cfg
        if cfg.approach == "DBSCAN_incr":
            with self.timer.span("dbscan"):
                if self.incr_clusterer is None:
                    self.incr_clusterer = dbscan.IncrementalDBSCAN(
                        eps=cfg.eps, min_pts=cfg.min_samples, device=self.device)
                clusters = self.incr_clusterer.insert(reduced).get_cluster_labels(reduced)
        elif cfg.approach == "DBSCAN_centr":
            with self.timer.span("dbscan"):
                clusters, self.prev_centroids, self.prev_centroid_labels = \
                    dbscan.dbscan_centroid_incremental(
                        reduced, self.prev_centroids, self.prev_centroid_labels,
                        eps=cfg.eps, min_samples=cfg.min_samples, device=self.device)
        else:
            clusters = labels
        if cfg.approach != "DBSCAN_centr":    # centr's re-map is its matching
            with self.timer.span("matching"):
                clusters = match_window_labels(prev_clusters, clusters, cfg,
                                               method=self._match_method(),
                                               centroid_matcher=self.centroid_matcher,
                                               stable_feats=stable_feats)
        elif clusters is None or len(clusters) == 0:
            clusters = np.full(cfg.window_size, 0)
        if verbose:   # reference main.py:107-112 (matched labels)
            print(f"[window {window_index}] matched clusters: {np.asarray(clusters)}")
        return np.asarray(clusters)

    def _device_allocs(self) -> int | None:
        """The caching allocator's device allocations and frees so far
        (cudaMalloc, cudaFree), read only while spans record on a CUDA
        device, else None.  Its peak statistics are never reset here."""
        if self.device.type != "cuda" or not profiling.on():
            return None
        stats = torch.cuda.memory_stats(self.device)
        return stats["num_device_alloc"] + stats["num_device_free"]

    @property
    def col_layout(self) -> bool:
        """Whether a huge window's features shard over the mesh ("columns" /
        "grid")."""
        return self.mesh is not None and self.cfg.huge_window_layout in ("columns", "grid")

    @property
    def ingest_device(self) -> torch.device:
        """Where the prefetcher puts a window: the CPU for the column-sharded
        layouts (each rank moves only its own rows to its device), else this
        rank's device ("rows": every rank holds the whole window)."""
        return torch.device("cpu") if self.col_layout else self.device

    def columns(self, feats_host, feats_dev: tuple, modality_types) -> ba.Columns:
        """A huge window's column panels from its (padded) device tensors."""
        if types_for(feats_host, modality_types)[0] in ("standard_sparse", "standard"):
            return ba.standard_columns(type(feats_host)._make(feats_dev),
                                       self.cfg.features)
        return ba.generic_columns(feats_dev, tuple(modality_types), self.device)

    def _reduce_blocked(self, feats_host, feats_dev: tuple, modality_types, gen):
        """(ritz, eigenvalues, None) for sSpectral, else (None, None, reduced
        (n, reduced_dim)) of a huge window: on one device, or with its row
        blocks sharded over ``self.mesh`` (the "rows" layout,
        ``parallel/sharded``; every rank holds the columns and gets the same
        result)."""
        cfg = self.cfg
        n = cfg.window_size
        with self.timer.span("columns"):
            cols = self.columns(feats_host, feats_dev, modality_types)
        select, nbins = bs.resolve_select(cfg, cols.n, self.device)
        sweep = dict(block=self.block, k_basis=cfg.k_basis, mesh=self.mesh, select=select,
                     nbins=nbins)
        with self.timer.span("reduce"):
            if cfg.approach == "SWFDMC":
                sketch, _, _ = sharded.sharded_blocked_fd_sketch(
                    cols, ell=min(cfg.reduced_dim, n), mode=cfg.fd_shrink,
                    cand_fold=cfg.huge_window_cand_fold, topology=cfg.merge_topology, **sweep)
                return None, None, sketch.T[:n]      # the padded columns are all zero
            if cfg.approach == "sSpectral":
                # blocked spectral reads the columns, not an SVD: its sweeps
                # are the reduction here
                ritz, lam = sharded.sharded_spectral_embedding(cols, gen, k_max=self.k_max,
                                                               **sweep)
                return ritz, lam, None
            return None, None, sharded.sharded_blocked_svd_reduce(
                cols, gen, rank=cfg.reduced_dim, **sweep)[:n]

    def _reduce_colsharded(self, feats_host, modality_types, gen):
        """:meth:`_reduce_blocked` with the window's features column-sharded
        over ``self.mesh`` (``parallel/colsharded``); the result is the same
        on every rank."""
        from mused_tpu_torch.parallel import colsharded as cs
        cfg = self.cfg
        n = cfg.window_size
        types = types_for(feats_host, modality_types)
        feats = tuple(feats_host)
        kw = dict(block=self.block, k_basis=cfg.k_basis, mesh=self.mesh,
                  tags_dim=cfg.features.tags_hash_dim, text_dim=cfg.features.text_hash_dim)
        with self.timer.span("reduce"):
            if cfg.approach == "SWFDMC":
                sketch, _, _ = cs.colsharded_blocked_fd_sketch(
                    feats, types, ell=min(cfg.reduced_dim, n), mode=cfg.fd_shrink,
                    cand_fold=cfg.huge_window_cand_fold, **kw)
                return None, None, sketch.T[:n]
            if cfg.approach == "sSpectral":
                ritz, lam = cs.colsharded_spectral_embedding(feats, types, gen,
                                                             k_max=self.k_max, **kw)
                return ritz, lam, None
            return None, None, cs.colsharded_blocked_svd_reduce(
                feats, types, gen, rank=cfg.reduced_dim, **kw)[:n]

    def process_window_large(self, feats_host, feats_dev: tuple, modality_types,
                             window_true_labels, window_index: int,
                             prev_clusters) -> np.ndarray:
        """One huge window (counterpart of ``_process_window_large``): column
        panels (or the column-sharded sweep over ``self.mesh``), blocked
        reduction, clustering, matching."""
        cfg = self.cfg
        n = cfg.window_size
        n_clusters, k_source = self._k_plan(window_true_labels)
        gen = window_generator(cfg.seed, window_index, self.device)
        if self.col_layout:
            ritz, lam, reduced = self._reduce_colsharded(feats_host, modality_types, gen)
        else:
            ritz, lam, reduced = self._reduce_blocked(feats_host, feats_dev, modality_types,
                                                      gen)
        with self.timer.span("cluster"):
            if cfg.approach == "sSVDMC_mini":
                new_mb, labels = kmeans.minibatch_step(self.state.minibatch, reduced, gen)
                self.state = self.state._replace(minibatch=new_mb)
            elif cfg.approach == "sSpectral":
                if k_source == "eigengap":   # the count from the Ritz values
                    n_clusters = bspec.eigengap_k_from_spectrum(lam, k_max=self.k_max)
                labels = bspec.labels_from_ritz(ritz, n_clusters, gen, k_max=self.k_max,
                                                n_real=n, background=cfg.background_bucket)
            elif cfg.approach == "DBSCAN_centr":
                labels = dbscan_blocked(reduced, eps=cfg.eps, min_samples=cfg.min_samples,
                                        block=self.block)
                reduced = reduced.cpu().numpy()
            else:
                if k_source == "eigengap":
                    n_clusters = reduction.eigengap_k(reduced, k_max=self.k_max,
                                                      theta=cfg.eigengap_theta)
                labels, _ = kmeans.kmeans(reduced, n_clusters, gen, k_max=self.k_max)
                if cfg.background_bucket:
                    labels = kmeans.mark_background(reduced, labels, k_max=self.k_max)
            if isinstance(labels, torch.Tensor):
                labels = labels.cpu().numpy()
        if cfg.approach == "DBSCAN_centr":    # centr's re-map is its matching
            with self.timer.span("matching"):
                clusters, self.prev_centroids, self.prev_centroid_labels = \
                    dbscan.match_centroids(reduced, labels, self.prev_centroids,
                                           self.prev_centroid_labels)
            return np.asarray(clusters)
        with self.timer.span("matching"):
            return match_window_labels(prev_clusters, labels, cfg,
                                       method=self._match_method())


def scanned_group_dispatch(engine: StreamingEngine, feats_batch: tuple, n_clusters: Sequence,
                           window_indices: Sequence[int], *, types: tuple,
                           k_source: str):
    """One group's device steps through the engine's path (SPMD over
    ``engine.mesh``'s rows when it has one, else one device): the one place
    the group call is written, shared by the offline loop and serving.
    Advances ``engine.state``; returns (labels (W, n), r_norms (W,)) on the
    device."""
    cfg = engine.cfg
    # each window's generator is made as its step starts, in window order,
    # as per-window dispatch makes it
    gens = (window_generator(cfg.seed, w, engine.device) for w in window_indices)
    kw = dict(approach=cfg.approach, k_basis=cfg.k_basis, reduced_dim=cfg.reduced_dim,
              k_max=engine.k_max, window=cfg.window_size, fd_shrink=cfg.fd_shrink,
              types=types, tags_dim=cfg.features.tags_hash_dim,
              text_dim=cfg.features.text_hash_dim, k_source=k_source,
              eigengap_theta=cfg.eigengap_theta, background=cfg.background_bucket)
    if engine.mesh is not None:
        new_swfd, new_mb, labels, r_norms = sharded.sharded_scanned_steps(
            engine.state.swfd, engine.state.minibatch, feats_batch, n_clusters, gens,
            mesh=engine.mesh, topology=cfg.merge_topology, **kw)
        engine.state = StreamState(swfd=new_swfd, minibatch=new_mb)
    else:
        engine.state, labels, r_norms = scanned_window_steps(
            engine.state, feats_batch, n_clusters, gens, use_kernel=engine.use_kernel, **kw)
    return labels, r_norms


def _run_batched(engine: StreamingEngine, todo: list, data_modalities, modality_types,
                 complete_true_labels, batch_w: int, prev_clusters, all_clusters: list,
                 all_true_labels: list, checkpoint_dir: str | None,
                 checkpoint_every: int) -> None:
    """The offline stream in groups of ``batch_w`` windows: whole groups
    featurized, stacked and moved ahead by the prefetcher; the tail group
    padded by repeating its last window (the extra outputs dropped); one
    label pull per group, then the host matching; one group dispatched
    ahead of the pull unless checkpointing, which saves at full-group
    boundaries.  Appends to ``all_clusters`` / ``all_true_labels``."""
    cfg = engine.cfg
    n = cfg.window_size
    types = scanned_types_for(modality_types, cfg.features)

    def group_of(gpos: int) -> list:
        group = todo[gpos * batch_w:(gpos + 1) * batch_w]
        return group + group[-1:] * (batch_w - len(group))

    def group_at(gpos: int) -> tuple:
        return stack_window_features([
            tuple(engine.featurize([m[i - n + 1:i + 1] for m in data_modalities],
                                   modality_types, key=w)) for w, i in group_of(gpos)])

    def finalize(group: list, n_real: int, labels, r_norms) -> None:
        nonlocal prev_clusters
        with engine.timer.span("batched_pull"):
            labels = labels.cpu().numpy()
        if cfg.approach == "SWFDMC" and engine.swfd_R is None:
            engine.swfd_R = float(r_norms[0])      # the first window's (main.py:61)
        for (_, i), window_labels in zip(group[:n_real], labels):
            stable = (None if engine.centroid_matcher is None else
                      stable_feature_matrix([m[i - n + 1:i + 1] for m in data_modalities]))
            with engine.timer.span("matching"):
                prev_clusters = match_window_labels(
                    prev_clusters, window_labels, cfg, method=engine._match_method(),
                    centroid_matcher=engine.centroid_matcher, stable_feats=stable)
            all_clusters.append(prev_clusters)
            all_true_labels.append(complete_true_labels[i - n + 1:i + 1])
        # engine.state is window-consistent only between groups; a padded
        # tail group is the stream's end, where a save adds nothing
        done = group[n_real - 1][0] + 1
        if (checkpoint_dir and n_real == batch_w
                and any((w + 1) % max(checkpoint_every, 1) == 0 for w, _ in group)):
            from mused_tpu_torch.utils import checkpoint as ckpt
            mesh_mod.write_once(lambda: ckpt.save_checkpoint(
                ckpt.checkpoint_name(checkpoint_dir, done), engine.state,
                {"next_window": done, "prev_clusters": prev_clusters,
                 "all_clusters": list(all_clusters),
                 "all_true_labels": list(all_true_labels), **engine.host_snapshot()}),
                spmd=engine.mesh is not None)

    pending = None
    prefetcher = WindowPrefetcher(group_at, -(-len(todo) // batch_w), engine.ingest_device,
                                  depth=2)
    try:
        for gpos, (_, feats_batch) in enumerate(prefetcher):
            group = group_of(gpos)
            plans = [engine._k_plan(complete_true_labels[i - n + 1:i + 1]) for _, i in group]
            with engine.timer.span("batched_device_step"):
                labels, r_norms = scanned_group_dispatch(
                    engine, feats_batch, [k for k, _ in plans], [w for w, _ in group],
                    types=types, k_source=plans[0][1])
            rec = (group, min(batch_w, len(todo) - gpos * batch_w), labels, r_norms)
            if checkpoint_dir:
                finalize(*rec)
                continue
            if pending is not None:
                finalize(*pending)
            pending = rec
        if pending is not None:
            finalize(*pending)
    finally:
        prefetcher.close()


def stable_feature_matrix(window_modalities) -> np.ndarray:
    """(n, d) input-feature-space matrix of a numeric window for centroid
    matching: its modalities side by side, float32."""
    return np.concatenate([np.asarray(m, np.float32).reshape(len(m), -1)
                           for m in window_modalities], axis=1)


def window_triggers(subset_size: int, window_size: int,
                    step_window_ratio: int) -> list[int]:
    """Stream indices i at which a window fires (reference main.py:32)."""
    return [i for i in range(subset_size)
            if i + 1 >= window_size and ((i + 1) * step_window_ratio) % window_size == 0]


def process_streaming_data(results, data_modalities, modality_types, window_size,
                           reduced_dim, k_basis, n_clusters_total, seed, approach,
                           complete_true_labels, step_window_ratio, noise_rate,
                           label_mode, sorting, eps, min_samples,
                           cfg: PipelineConfig | None = None,
                           checkpoint_dir: str | None = None, checkpoint_every: int = 1,
                           data_shards: int = 1, merge_topology: str = "allgather",
                           verbose: bool = False, matching: str = "auto",
                           windows_per_batch: int | None = None,
                           k_estimate: str = "labels", eigengap_theta: float = 0.15,
                           background_bucket: bool = False,
                           huge_window_layout: str = "rows",
                           huge_window_col_shards: int = 0,
                           huge_window_cand_fold: bool | None = None, *,
                           device="cuda", engine: StreamingEngine | None = None):
    """Drop-in equivalent of reference main.py:13-130 on ``device`` (the
    card unless the caller passes ``device="cpu"``), with the JAX package's
    keywords.

    Appends one sweep point's metrics to ``results`` and returns it.
    ``checkpoint_dir`` saves the stream's state every ``checkpoint_every``
    windows and resumes from the newest checkpoint found there; ``engine``
    keeps a handle on its timer and state after the run.
    ``data_shards=p`` runs the stream SPMD over a torch.distributed process
    group of p ranks, which every rank enters with the same arguments (the
    caller initialises the group, e.g. under ``torchrun --nproc-per-node
    p``): window rows sharded (``huge_window_layout="rows"``, the sketches
    merged by ``merge_topology``: "allgather" or "ring"), or huge windows'
    features ("columns" / "grid").  Rank 0 alone writes the checkpoints;
    the others wait for each write and read the same files.
    ``windows_per_batch`` = W > 1 dispatches W windows per group, with the
    same labels as per-window dispatch (None resolves by
    :func:`resolve_windows_per_batch`: per-window off the TPU)."""
    total_start = metrics_mod.now_ns()
    subset_size = len(data_modalities[0])
    if cfg is None:
        cfg = PipelineConfig(
            seed=seed, subset_size=subset_size, noise_rate=noise_rate,
            label_mode={2: "binary", 4: "types"}.get(n_clusters_total, "all"),
            sorting=sorting, window_size=window_size, reduced_dim=reduced_dim,
            k_basis=k_basis, step_window_ratio=step_window_ratio, approach=approach,
            eps=eps, min_samples=min_samples, n_clusters_override=int(n_clusters_total),
            data_shards=data_shards, merge_topology=merge_topology, verbose=verbose,
            matching=matching,
            windows_per_batch=windows_per_batch, k_estimate=k_estimate,
            eigengap_theta=eigengap_theta, background_bucket=background_bucket,
            huge_window_layout=huge_window_layout,
            huge_window_col_shards=huge_window_col_shards,
            huge_window_cand_fold=huge_window_cand_fold)
    engine = engine or StreamingEngine(cfg, device)
    if cfg.matching == "centroid" and list(modality_types) == STANDARD_TYPES:
        raise ValueError(
            "matching='centroid' supports numeric-modality streams "
            "(embeddings etc.); standard SED2012 streams use the reference "
            "positional matching or the DBSCAN_centr approach")
    complete_true_labels = np.asarray(complete_true_labels)
    all_clusters: list[np.ndarray] = []
    all_true_labels: list[np.ndarray] = []
    prev_clusters = None
    start_w = 0
    if checkpoint_dir:
        from mused_tpu_torch.utils import checkpoint as ckpt
        latest = ckpt.latest_checkpoint(checkpoint_dir)
        if latest is not None:
            state, host = ckpt.load_checkpoint(latest, like=engine.state)
            engine.restore(state, host)
            start_w = host["next_window"]
            all_clusters = [np.asarray(c) for c in host["all_clusters"]]
            all_true_labels = [np.asarray(t) for t in host["all_true_labels"]]
            prev_clusters = host["prev_clusters"]
            print(f"resumed from {latest} at window {start_w}")
    todo = list(enumerate(window_triggers(subset_size, window_size,
                                          step_window_ratio)))[start_w:]
    batch_w = resolve_windows_per_batch(
        cfg, standard_types=list(modality_types) == STANDARD_TYPES,
        step_window_ratio=step_window_ratio, checkpoint_dir=checkpoint_dir,
        backend=engine.device.type, n_windows=len(todo))
    if batch_w > 1:
        _run_batched(engine, todo, data_modalities, modality_types, complete_true_labels,
                     batch_w, prev_clusters, all_clusters, all_true_labels, checkpoint_dir,
                     checkpoint_every)
    else:
        _run_per_window(engine, todo, data_modalities, modality_types, complete_true_labels,
                        prev_clusters, all_clusters, all_true_labels, checkpoint_dir,
                        checkpoint_every)
    total_end = metrics_mod.now_ns()
    all_true = np.concatenate(all_true_labels) if all_true_labels else np.empty(0, int)
    all_clus = np.concatenate(all_clusters) if all_clusters else np.empty(0, int)
    return metrics_mod.compute_all_metrics(
        results, subset_size, noise_rate, label_mode, sorting, reduced_dim, k_basis,
        window_size, all_clus, all_true, total_end, total_start)


def _run_per_window(engine: StreamingEngine, todo: list, data_modalities, modality_types,
                    complete_true_labels, prev_clusters, all_clusters: list,
                    all_true_labels: list, checkpoint_dir: str | None,
                    checkpoint_every: int) -> None:
    """The offline stream one window per dispatch.  Appends to
    ``all_clusters`` / ``all_true_labels``."""
    cfg = engine.cfg
    window_size = cfg.window_size

    def featurize_at(pos: int):
        w, i = todo[pos]
        return engine.featurize([m[i - window_size + 1:i + 1] for m in data_modalities],
                                modality_types, key=w)

    def finish(pending: _PendingWindow) -> None:
        """Pull + match one dispatched window; checkpoint its post-state."""
        nonlocal prev_clusters
        prev_clusters = engine.finalize_window(pending, prev_clusters)
        all_clusters.append(prev_clusters)
        done = pending.window_index + 1
        if checkpoint_dir and done % max(checkpoint_every, 1) == 0:
            from mused_tpu_torch.utils import checkpoint as ckpt
            # SPMD ranks hold the same state: one writer, then everyone waits
            mesh_mod.write_once(lambda: ckpt.save_checkpoint(
                ckpt.checkpoint_name(checkpoint_dir, done), pending.state,
                {"next_window": done, "prev_clusters": prev_clusters,
                 "all_clusters": list(all_clusters),
                 "all_true_labels": list(all_true_labels), **engine.host_snapshot()}),
                spmd=engine.mesh is not None)

    # up to two windows dispatched ahead of the oldest unpulled one (numerics
    # unchanged: matching feeds nothing back to the device); checkpoints,
    # debug prints and huge windows (whose matching runs inside dispatch)
    # keep the sequential order
    ahead = 0 if (effective_verbose(cfg) or checkpoint_dir or engine.huge) else 2
    in_flight: list[_PendingWindow] = []
    prefetcher = WindowPrefetcher(featurize_at, len(todo), engine.ingest_device, depth=2)
    try:
        for (w_idx, i), (host, dev) in zip(todo, prefetcher):
            true_labels = complete_true_labels[i - window_size + 1:i + 1]
            all_true_labels.append(true_labels)
            in_flight.append(engine.dispatch_window(host, dev, modality_types,
                                                    true_labels, w_idx, prev_clusters))
            if len(in_flight) > ahead:
                finish(in_flight.pop(0))
        while in_flight:
            finish(in_flight.pop(0))
    finally:
        prefetcher.close()
