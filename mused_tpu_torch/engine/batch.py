"""Batch engine: the whole-subset pipeline — port of
``mused_tpu/engine/batch.py`` (reference main.py:132-167).

Adjacency over the whole subset -> OR-fuse -> SVD reduce -> one clustering
pass (k-means, DBSCAN, HDBSCAN or spectral).  Subsets of up to
``MAX_DENSE_ROWS`` rows build the dense (n, n) fused graph through the
streaming engine's fusion (K1 on a card); larger ones, or
``cfg.force_blocked_batch``, never build it: the subset's rows pad to a
multiple of ``BLOCK_ROWS`` and the blocked sweeps rebuild row blocks
(``ops/blocked_affinity``, K2 / K3 on a card) for the randomized SVD or
spectral clustering, then blocked DBSCAN or the device Borůvka HDBSCAN
cluster the reduced rows.  The reference's own default subset (150,000
rows) takes the blocked path; its dense path would need the subset's
(n, n) float64 matrix (180 GB).

Randomness: one ``torch.Generator`` on the device seeded with ``seed``
(:func:`batch_generator`; the JAX package draws from ``key(seed)``): the
randomized SVD's test matrix or blocked spectral's probe first, then the
k-means++ draws.  Spectral_batch runs no SVD on either path (the JAX
package's dense path computes one that nothing reads).

Spans (``utils/profiling``, while they record): the root ``batch.call``,
keyed by the process's call number, with ``featurize`` (featurization and
padding), ``engine.columns`` (copy, column panels and postings; device
extent too), ``engine.reduce`` (the SVD; device extent too),
``engine.cluster`` (clustering through the label pull) and
``match.metrics`` (the metrics).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from mused_tpu_torch.data import features as feat
from mused_tpu_torch.data.ingest import pad_window_features, to_device
from mused_tpu_torch.engine.streaming import (STANDARD_TYPES, StreamingEngine,
                                              configure_precision)
from mused_tpu_torch.ops import blocked_affinity as ba, blocked_spectral as bspec
from mused_tpu_torch.ops import dbscan, kmeans, reduction, spectral
from mused_tpu_torch.ops.blocked_dbscan import dbscan_blocked
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.utils import metrics as metrics_mod
from mused_tpu_torch.utils import profiling
from mused_tpu_torch.utils.config import PipelineConfig

MAX_DENSE_ROWS = 32_768  # dense (n, n) cap on one device (4.3 GB f32 at the cap)
BLOCK_ROWS = 2_048       # rows per rebuilt block on the blocked path

_calls = itertools.count()   # the key of each call's spans


def batch_generator(seed: int, device) -> torch.Generator:
    """The batch run's generator (see the module docstring)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _blocked_columns(data_modalities, modality_types, cfg: PipelineConfig, device):
    """Featurize the whole subset, pad rows to a block multiple (padding rows
    are invalid: zero adjacency rows) and build the column panels on
    ``device``.  Returns (Columns, block)."""
    n = len(data_modalities[0])
    block = min(BLOCK_ROWS, n)
    pad = (-n) % block
    standard = list(modality_types) == STANDARD_TYPES
    with profiling.span("featurize"):
        if standard:
            wf = feat.featurize_window(*data_modalities, cfg.features)
            if pad:
                wf = pad_window_features(wf, pad)
        else:
            mats = [np.asarray(m, np.float32) for m in data_modalities]
            if pad:
                mats = [np.pad(m, ((0, pad), (0, 0)), constant_values=np.nan) for m in mats]
    with profiling.span("engine.columns", device=torch.device(device).type == "cuda"):
        if standard:
            return ba.standard_columns(type(wf)._make(to_device(wf, device)),
                                       cfg.features), block
        return ba.generic_columns(mats, tuple(modality_types), device), block


def _blocked_reduce(data_modalities, modality_types, cfg: PipelineConfig,
                    generator: torch.Generator, device) -> torch.Tensor:
    """(n, reduced_dim) blocked randomized SVD of the subset's fused graph."""
    n = len(data_modalities[0])
    cols, block = _blocked_columns(data_modalities, modality_types, cfg, device)
    select, nbins = bs.resolve_select(cfg, cols.n, device)
    with profiling.span("engine.reduce", device=torch.device(device).type == "cuda"):
        return ba.blocked_svd_reduce(cols, generator, rank=cfg.reduced_dim, block=block,
                                     k_basis=cfg.k_basis, select=select, nbins=nbins)[:n]


def process_batch_data(results, data_modalities, modality_types, reduced_dim, k_basis,
                       n_clusters, seed, approach, complete_true_labels, noise_rate,
                       label_mode, sorting, eps, min_samples, min_cluster_size,
                       window_size, cfg: PipelineConfig | None = None, *, device="cuda"):
    """Drop-in equivalent of reference main.py:132-167 on ``device`` (the
    card unless the caller passes ``device="cpu"``).  SVDMC_batch (and any
    unknown name, as in the reference) clusters with k-means,
    DBSCAN_batch / HDBSCAN_batch with DBSCAN / HDBSCAN on the reduced rows,
    Spectral_batch with spectral clustering of the fused graph.  Appends
    the metrics to ``results`` and returns it."""
    with profiling.span("batch.call", key=next(_calls)):
        total_start = metrics_mod.now_ns()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        configure_precision()      # the blocked sweeps' products stay true fp32
        subset_size = len(data_modalities[0])
        if cfg is None:
            cfg = PipelineConfig(
                seed=seed, subset_size=subset_size, noise_rate=noise_rate,
                label_mode=label_mode, sorting=sorting, window_size=window_size,
                reduced_dim=reduced_dim, k_basis=k_basis, approach=approach, eps=eps,
                min_samples=min_samples, min_cluster_size=min_cluster_size)
        # cfg is the single source of truth past this point, on both paths
        reduced_dim, k_basis = cfg.reduced_dim, cfg.k_basis
        k_max = max(int(n_clusters), 2)
        gen = batch_generator(seed, device)

        blocked = subset_size > MAX_DENSE_ROWS or cfg.force_blocked_batch
        if blocked and approach == "Spectral_batch":     # the columns, no SVD
            cols, block = _blocked_columns(data_modalities, modality_types, cfg, device)
            select, nbins = bs.resolve_select(cfg, cols.n, device)
            with profiling.span("engine.cluster"):
                labels = _host(bspec.spectral_clustering_blocked(
                    cols, int(n_clusters), gen, k_max=k_max, block=block, k_basis=k_basis,
                    n_real=subset_size, select=select, nbins=nbins))
        elif blocked:
            reduced = _blocked_reduce(data_modalities, modality_types, cfg, gen, device)
            with profiling.span("engine.cluster"):
                labels = _host(_cluster_reduced(reduced, approach, n_clusters, gen, k_max,
                                                cfg, blocked=True))
        else:
            # the streaming engine's featurize + fuse on the whole subset
            helper = StreamingEngine(cfg.replace(window_size=max(subset_size, 2),
                                                 force_blocked_window=False), device)
            fused = helper.fused_adjacency(data_modalities, modality_types)
            if approach == "Spectral_batch":     # the fused graph, no SVD
                with profiling.span("engine.cluster"):
                    labels = _host(spectral.spectral_clustering(fused, int(n_clusters), gen,
                                                                k_max=k_max))
            else:
                with profiling.span("engine.reduce", device=device.type == "cuda"):
                    reduced = reduction.svd_reduce(fused, reduced_dim, gen)
                del fused
                with profiling.span("engine.cluster"):
                    labels = _host(_cluster_reduced(reduced, approach, n_clusters, gen,
                                                    k_max, cfg, blocked=False))
        total_end = metrics_mod.now_ns()
        with profiling.span("match.metrics"):
            return metrics_mod.compute_all_metrics(
                results, subset_size, noise_rate, label_mode, sorting, reduced_dim, k_basis,
                window_size, np.asarray(labels), np.asarray(complete_true_labels),
                total_end, total_start)


def _cluster_reduced(reduced, approach, n_clusters, gen, k_max: int, cfg: PipelineConfig,
                     *, blocked: bool):
    """Labels of the reduced rows: DBSCAN (blocked on the blocked path),
    HDBSCAN (Borůvka on a card, host Prim off it) or k-means."""
    if approach == "DBSCAN_batch":
        return (dbscan_blocked if blocked else dbscan.dbscan)(
            reduced, eps=cfg.eps, min_samples=cfg.min_samples)
    if approach == "HDBSCAN_batch":
        return dbscan.hdbscan(reduced, min_cluster_size=cfg.min_cluster_size,
                              min_samples=cfg.min_samples)
    labels, _ = kmeans.kmeans(reduced, int(n_clusters), gen, k_max=k_max)
    return labels


def _host(labels):
    """Labels on the host (the pull waits for the device)."""
    return labels.cpu().numpy() if isinstance(labels, torch.Tensor) else labels
