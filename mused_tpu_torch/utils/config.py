"""Typed configuration layer: the port's copy of ``mused_tpu/utils/config.py``.

Copied, not imported, so the port runs where the JAX package is absent:
``APPROACHES``, ``FeatureConfig`` and ``PipelineConfig`` with the original's
code, names and defaults (the sweep helpers are not copied; the port does
not call them).  Field comments are the original's and describe the JAX
package's options, and the port runs every one (``windows_per_batch`` > 1
as a group of per-window steps enqueued back to back, with no host read
between them, instead of one ``lax.scan``: ``engine/streaming.py``).

The original's note: the reference hard-codes every knob in module-level
dicts (reference main.py:262-313: ``experiments``, ``approaches``,
``default_params``; DBSCAN constants at main.py:200).  Here those become
frozen dataclasses so configs hash and print cleanly.  Defaults reproduce
the reference's ``default_params`` exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Approach identifiers — the reference's "model zoo" (reference main.py:290-301;
# dispatch semantics at main.py:58-97, 105-112, 149-154). See SURVEY.md §2.2.
APPROACHES: Tuple[str, ...] = (
    "SVDMC_batch",
    "SWFDMC",
    "sSVDMC",
    "sSVDMC_hung",
    "sSVDMC_pot",
    "sSVDMC_mini",
    "DBSCAN_batch",
    "HDBSCAN_batch",
    "DBSCAN_incr",
    "DBSCAN_centr",
    # new in the TPU build (not in the reference approach list): spectral
    # clustering on the fused affinity graph (BASELINE.md config #2)
    "sSpectral",
    "Spectral_batch",
)



@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Static featurization widths (host hashing → fixed-width device tensors).

    The reference fits a per-window ``TfidfVectorizer`` with a data-dependent
    vocabulary (reference matrix_operations.py:104-105) — a dynamic shape XLA
    can't compile.  We use the hashing trick at fixed width instead; parity is
    at the metric level (F1 ±0.5), see SURVEY.md §7.3.
    """

    tags_hash_dim: int = 2048
    text_hash_dim: int = 4096
    # sparse token layout: ship (ids, counts) and scatter to dense on device
    # (~16x smaller transfers; ~100x smaller host memory at 150k scale).
    # Caps bound DISTINCT hashed tokens per record; overflow drops extras.
    sparse: bool = True
    tags_token_cap: int = 24
    text_token_cap: int = 96
    trim_token_cols: bool = True   # slice each window's (n, T) id/count
                                   # tensors down to the max occupied width
                                   # (multiple of 8): same results, far fewer
                                   # bytes over the interconnect


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """One experiment point.  Field defaults == reference ``default_params``
    (reference main.py:303-313) + clustering constants (main.py:198-200)."""

    seed: int = 0
    subset_size: int = 150_000
    noise_rate: float = 0.95
    label_mode: str = "binary"          # binary | types | all
    sorting: bool = False
    window_size: int = 2000
    reduced_dim: int = 50
    k_basis: int = 50
    step_window_ratio: int = 1
    approach: str = "sSVDMC"

    # clustering constants (reference main.py:200)
    eps: float = 1.5
    min_samples: int = 2
    min_cluster_size: int = 3

    # device-side knobs (new in the TPU build)
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    kmeans_iters: int = 100
    n_clusters_override: int | None = None   # honor an explicit caller value
    force_blocked_batch: bool = False  # use the rematerialized blocked batch
                                       # path regardless of subset size
    force_blocked_window: bool = False  # rematerialized huge-window streaming
                                        # path regardless of window size
    windows_per_batch: int | None = None
    # W>1: dispatch W tumbling windows per device call via one lax.scan —
    # numerically identical to per-window dispatch (tested), ~3x e2e on
    # remote TPU links.  None = auto: 4 on TPU backends when eligible
    # (approach in BATCHABLE_APPROACHES, step_window_ratio==1, dense
    # windows, no checkpoint_dir/verbose), else per-window.  Explicit 1
    # opts out of batching everywhere; explicit W>1 is clamped back to
    # per-window when the config can't run scanned at all (non-batchable
    # approach, sliding ratio, huge windows, centroid-on-standard) — see
    # engine.resolve_windows_per_batch.
    huge_window_approx_knn: bool = True
    # kept for the JAX package's config, where it selects lax.approx_max_k
    # (a TPU partial reduction) for the huge-window kNN selections; the port
    # runs exact top-k whatever the value.
    huge_window_fused_select: bool | None = None
    # huge-window blocked path: route the MXU modalities (text/tags) through
    # the fused stride-binned candidate kernel (ops/pallas/blocked_select.py)
    # — the (block, n) f32 sim strip never round-trips HBM; selection becomes
    # exact top-k over ~n/32 stride-binned candidates (residue classes, so
    # contiguous neighbor runs in near-sorted streams never collide).
    # None = auto: ON on TPU, OFF elsewhere (the XLA emulation is bit-equal
    # but saves nothing on CPU).  Explicit True/False wins.
    huge_window_cand_fold: bool | None = None
    # huge-window SWFDMC (single-chip AND row-sharded): absorb
    # CANDIDATE-form blocks —
    # the FD fold's G-applications run straight off the int8 candidate slabs
    # (ops/pallas/cand_matvec) and the dense (block, n) adjacency block
    # never reaches HBM.  Same edges as the dense binned path by
    # construction.  Needs fd_shrink subspace/rr + fused select + every
    # modality binned-eligible (blocked_affinity.cand_fold_supported);
    # None = auto (ON on TPU when eligible), False = dense fold, True =
    # force (CPU runs the per-group XLA reference products — test oracle).
    fd_shrink: str = "subspace"  # "subspace": matmul-only adaptive shrink
                                 # (gated eigh fallback; ~4.5x faster sketch
                                 # streams) | "eigh": guaranteed classic FD.
                                 # Huge-window blocked folds route "subspace"
                                 # to the Rayleigh-Ritz shrink (fd.shrink_rr
                                 # — exact small-eigh orthonormalization; at
                                 # fold scale the Gram dominates and rr is
                                 # both faster and more accurate)
    use_pallas_affinity: bool | None = None
    # fused Pallas kNN kernel for the affinity graphs (all five standard
    # modalities + numeric/embedding types; threshold ties may add edges).
    # None = auto: ON when running on TPU (measured 2.1x the XLA
    # sim+top_k+scatter path at n=2048/d=4096), OFF elsewhere (interpret
    # mode is emulation, only useful for tests).  Explicit True/False wins.
    sinkhorn_reg: float = 0.1
    sinkhorn_iters: int = 200
    matching: str = "auto"   # cross-window ID matching: "auto" = reference
                             # behavior (pot for sSVDMC_pot, else hungarian,
                             # both positional-overlap); "hungarian"/"pot"
                             # force a method; "centroid" = nearest-centroid
                             # matching in input feature space (framework
                             # extension — stabilizes IDs on temporally
                             # UNSORTED streams where positional overlap is
                             # random; numeric-modality streams only)
    centroid_max_dist: float | None = None   # centroid matching: reject
                             # matches farther than this (None = always match)
    k_estimate: str = "labels"   # per-window cluster-count source:
                             # "labels" = reference quirk (count of unique
                             # ground-truth labels in the window, main.py:41
                             # — truth leaks into k; kept for comparability);
                             # "fixed" = n_clusters_total every window;
                             # "eigengap" = unsupervised device estimate from
                             # the reduced window's singular-value profile
                             # (ops/reduction.eigengap_k) — the production/
                             # serving mode, no labels consulted
    eigengap_theta: float = 0.15
                             # eigengap_k's strong-secondary-gap veto
                             # threshold (ADVICE r4 #3): the i=1 Perron gap
                             # competes only when no later relative gap
                             # exceeds this.  0.15 was calibrated on
                             # planted-event windows (noise 0.3-0.65, 1-12
                             # events, 3 seeds — ops/reduction.eigengap_k);
                             # a stream family where that default regresses
                             # tunes it here without a code change.
    background_bucket: bool = False
                             # label-free background/outlier bucket
                             # (serving extension, no reference analog):
                             # after the in-graph clustering (sSpectral and
                             # the kmeans approaches), rows whose embedding
                             # distance to their assigned centroid falls in
                             # the far mode of a bimodal distance
                             # distribution (1-d Otsu split with a
                             # separation guard) are re-labeled -1 — "no
                             # event".  The affinity graph structurally
                             # contains only the event communities (the
                             # eigengap count is right to exclude scattered
                             # noise) while noise rows sit far from every
                             # centroid in embedding space (measured AUC
                             # 0.98 on crisis windows).  Dense windows
                             # only; matching passes -1 through unchanged.
    swfd_target_blocks: int = 8
                             # SeqBasedSWFD-style row-granular streaming
                             # only (ops/swfd.choose_block_rows default);
                             # the engine's whole-window fold made it a
                             # no-op there (round 5 removed the dead
                             # threading).  Kept for cfg-dict
                             # compatibility with saved checkpoints.
    # multi-chip: shard window rows over a ("data","model") mesh of this many
    # devices; every window step then runs SPMD (sharded affinity, ICI sketch
    # merge / distributed SVD, psum'd KMeans — parallel/sharded.py).
    # 1 = single-chip. window_size must be divisible by data_shards.
    data_shards: int = 1
    merge_topology: str = "allgather"   # SWFD sketch merge: allgather | ring
    huge_window_layout: str = "rows"
    # multi-chip HUGE-window (rematerialized blocked) sweep layout:
    # "rows" = column features replicated, each chip sweeps its own range of
    # adjacency row blocks (throughput-optimal; parallel/sharded); "columns"
    # = the features themselves shard over the mesh — each chip holds 1/p of
    # the window's feature/column panels and sweeps every row block over its
    # column slice (parallel/colsharded) — the capacity layout for windows
    # whose replicated panels would not fit one chip's HBM; "grid" = the
    # DPxTP composition — huge_window_col_shards chips shard the columns
    # (memory) and data_shards/col_shards row groups split the block sweep
    # (throughput), per-group sketches merging with one more FD shrink.
    # SWFDMC only; "columns"/"grid" always use stride-binned fused selection.
    huge_window_col_shards: int = 0
    # "grid" layout only: how many of data_shards shard the feature columns.
    # Must divide data_shards and be >= 2.  0 = auto (largest divisor of
    # data_shards <= sqrt(data_shards) — balanced grid).
    verbose: bool = False    # small-subset debug oracles (ref main.py:35-37,
                             # 51-53, 99-103: eyeball-verification prints)

    @property
    def n_clusters_total(self) -> int:
        # reference main.py:198 (overridable by API callers that pass their
        # own n_clusters_total, like reference process_streaming_data)
        if self.n_clusters_override is not None:
            return self.n_clusters_override
        return {"binary": 2, "types": 4}.get(self.label_mode, 150)

    @property
    def is_batch(self) -> bool:
        return self.approach.endswith("_batch")

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
