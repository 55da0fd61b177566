"""Reference-compatible public API of the port.

    from mused_tpu_torch import api as mused

Every public name of ``mused_tpu/api.py``, with its signature, plus a
keyword ``device`` (default ``"cuda"``; pass ``"cpu"`` to run the plain
versions on the CPU) where a function runs on the card (the two
``perform_*dbscan_clustering`` keep the reference's exact signature and run
on the card; their ``*_fn`` forms take ``device``):

  * data: ``load_sed2012_dataset`` and ``prepare_modalities`` (the column
    table of ``data/sed2012``, no pandas), ``load_synthetic_dataset``
    (reference data_loader.py:9, 52, 190);
  * the engines: ``process_streaming_data`` and ``process_batch_data``
    (reference main.py:13, 132), ``get_initial_results`` and
    ``compute_all_metrics`` (metrics_evaluation.py:3, 36);
  * ``SeqBasedSWFD``, the reference's sketch (main.py:60-76);
  * the reference's matrix operations (matrix_operations.py):
    ``create_adjacency_matrix``, ``fuse_matrices``,
    ``perform_svd_reduction``, ``perform_clustering``, ``match_clusters``,
    ``perform_dbscan_clustering`` / ``perform_hdbscan_clustering`` (and
    their ``*_fn`` aliases) and ``IncrementalDBSCAN``.

``StreamDetector`` is the label-free serving detector (``serving``).
"""
from __future__ import annotations

import numpy as np
import torch

from mused_tpu_torch.data.sed2012 import load_sed2012_dataset, prepare_modalities  # noqa: F401
from mused_tpu_torch.data.synthetic import load_synthetic_dataset  # noqa: F401
from mused_tpu_torch.engine.batch import process_batch_data  # noqa: F401
from mused_tpu_torch.engine.streaming import process_streaming_data  # noqa: F401
from mused_tpu_torch.ops.dbscan import (  # noqa: F401
    IncrementalDBSCAN,
    dbscan as perform_dbscan_clustering_fn,
    hdbscan as perform_hdbscan_clustering_fn,
)
from mused_tpu_torch.ops.matching import match_clusters  # noqa: F401
from mused_tpu_torch.ops.swfd import SeqBasedSWFD  # noqa: F401
from mused_tpu_torch.serving import StreamDetector  # noqa: F401
from mused_tpu_torch.utils.metrics import compute_all_metrics, get_initial_results  # noqa: F401


def perform_dbscan_clustering(data, eps=0.5, min_samples=5):
    """reference matrix_operations.py:235-238, on the card (a tensor's own
    device when ``data`` is one; ``perform_dbscan_clustering_fn`` takes
    ``device``)"""
    return perform_dbscan_clustering_fn(data, eps=eps, min_samples=min_samples)


def perform_hdbscan_clustering(data, min_cluster_size=5, min_samples=2):
    """reference matrix_operations.py:240-243, on the card (as above)"""
    return perform_hdbscan_clustering_fn(data, min_cluster_size=min_cluster_size,
                                         min_samples=min_samples)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def _tensor(matrix, device) -> torch.Tensor:
    return torch.from_numpy(np.array(matrix, np.float32)).to(device)


def create_adjacency_matrix(data, modality_type, k_basis=50, *, device="cuda"):
    """reference matrix_operations.py:14-132: the dense (n, n) 0/1 kNN graph
    of one modality's raw per-row array (floats or object strings), as a
    numpy array, with the reference's validity rules.

    On a CUDA device the kNN modalities run the hand-written kernel K1 with
    the streaming engine's metrics (location chord3 on unit xyz, time l1
    with 3 k_basis neighbours, tags Jaccard, text dot on TF-IDF rows, other
    types Euclidean with k_basis-1), so a graph equals the engine's for the
    same operands; username is an equality broadcast.  On the CPU they take
    ``ops/affinity``'s plain graphs, as the engine does there (haversine
    location).  Time is the raw float32 timestamps, as in the JAX package
    (the engine centres each window's timestamps first)."""
    from mused_tpu_torch.data import features as feat
    from mused_tpu_torch.engine import streaming
    from mused_tpu_torch.ops import affinity
    from mused_tpu_torch.ops.kernels import affinity_kernel as ak
    from mused_tpu_torch.utils.config import FeatureConfig

    device = _device(device)
    use_kernel = device.type == "cuda"
    data = np.asarray(data)
    fc = FeatureConfig()
    if modality_type == "username":
        # only the empty string is invalid (ref :59); a non-str cell (a
        # pandas NaN) is valid, and all such rows share one username
        def _uid(cell):
            if isinstance(cell, str):
                return -1 if cell == "" else feat.stable_hash(cell)
            return feat.stable_hash("\x00nan")
        ids = np.array([_uid(row[0]) for row in data], np.int64)
        ids = np.where(ids < 0, ids, ids % np.int64(2**31 - 1))
        adj = affinity.username_adjacency(torch.from_numpy(ids.astype(np.int32)).to(device))
    elif modality_type == "tags":
        # only the empty STRING cell is invalid (ref :79): an empty tag list
        # participates with Jaccard 0
        cells = [row[0] for row in data]
        valid = torch.tensor([not (isinstance(c, str) and c == "") for c in cells],
                             device=device)
        mh = _tensor(feat.multihot_tags(cells, fc.tags_hash_dim), device)
        adj = (ak.knn_adjacency(mh, valid, k_basis, metric="jaccard") if use_kernel
               else affinity.tags_adjacency(mh, k_basis, valid=valid))
    elif modality_type == "text":
        # a row where either raw cell is a non-empty string participates
        # (ref :97), even when its text yields no tokens
        valid = torch.tensor([any(isinstance(c, str) and c != "" for c in row)
                              for row in data], dtype=torch.bool, device=device)
        joined = [((row[0] if isinstance(row[0], str) else "") + " " +
                   (row[1] if isinstance(row[1], str) else "")).strip() for row in data]
        counts = _tensor(feat.hash_text_counts(joined, fc.text_hash_dim), device)
        if use_kernel:
            adj = ak.knn_adjacency(affinity.tfidf_rows(counts)[0].contiguous(), valid,
                                   k_basis, metric="dot")
        else:
            adj = affinity.text_adjacency(counts, k_basis, valid=valid)
    else:
        kind = modality_type if modality_type in ("location", "time") else "default"
        graph = streaming.kernel_graph if use_kernel else streaming.plain_graph
        adj = graph(_tensor(data, device), kind, k_basis)
    return adj.cpu().numpy()


def fuse_matrices(matrices):
    """reference matrix_operations.py:134-141"""
    fused = np.asarray(matrices[0]).copy()
    for m in matrices[1:]:
        fused = np.logical_or(fused, m).astype(int)
    return fused


def perform_svd_reduction(matrix, reduced_dim, seed, *, device="cuda"):
    """reference matrix_operations.py:143-147 (TruncatedSVD.fit_transform),
    the randomized SVD drawing from a generator seeded ``seed``."""
    from mused_tpu_torch.ops import reduction
    device = _device(device)
    x = _tensor(matrix, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = reduction.svd_reduce(x, int(reduced_dim), gen)
    return out[:, :min(int(reduced_dim), x.shape[1] - 1)].cpu().numpy()


def perform_clustering(matrix, n_clusters, seed, *, device="cuda"):
    """reference matrix_operations.py:149-153 (KMeans labels), k-means++
    drawing from a generator seeded ``seed``."""
    from mused_tpu_torch.ops import kmeans
    device = _device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    labels, _ = kmeans.kmeans(_tensor(matrix, device), int(n_clusters), gen,
                              k_max=max(int(n_clusters), 2))
    return labels.cpu().numpy()
