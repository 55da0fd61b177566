"""Reference-compatible public API of the port.

    from mused_tpu_torch import api as mused

``process_streaming_data`` and ``process_batch_data`` keep the reference
signatures (reference main.py:13, 132) and the JAX package's keywords, and
add a keyword ``device`` (default ``"cuda"``; pass ``"cpu"`` to run the
plain versions on the CPU);
``perform_dbscan_clustering``, ``perform_hdbscan_clustering`` and
``IncrementalDBSCAN`` keep the reference names and signatures (reference
matrix_operations.py:235-243, main.py:87-91) and run on the card;
``get_initial_results``, ``compute_all_metrics`` and ``match_clusters`` come
from the port's copies of the host tier (``utils/metrics``,
``ops/matching``).  ``StreamDetector`` is the label-free serving detector
(``serving``).  Data preparation that needs no pandas is in
``mused_tpu_torch.data.synthetic``.
"""
from __future__ import annotations

from mused_tpu_torch.engine.batch import process_batch_data  # noqa: F401
from mused_tpu_torch.engine.streaming import process_streaming_data  # noqa: F401
from mused_tpu_torch.ops.dbscan import IncrementalDBSCAN  # noqa: F401
from mused_tpu_torch.ops.dbscan import dbscan as _dbscan, hdbscan as _hdbscan
from mused_tpu_torch.ops.matching import match_clusters  # noqa: F401
from mused_tpu_torch.serving import StreamDetector  # noqa: F401
from mused_tpu_torch.utils.metrics import compute_all_metrics, get_initial_results  # noqa: F401


def perform_dbscan_clustering(data, eps=0.5, min_samples=5):
    """reference matrix_operations.py:235-238"""
    return _dbscan(data, eps=eps, min_samples=min_samples)


def perform_hdbscan_clustering(data, min_cluster_size=5, min_samples=2):
    """reference matrix_operations.py:240-243"""
    return _hdbscan(data, min_cluster_size=min_cluster_size, min_samples=min_samples)
