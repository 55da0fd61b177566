"""Reference-compatible public API of the port.

    from mused_tpu_torch import api as mused

``process_streaming_data`` keeps the reference signature (reference
main.py:13) and adds a keyword ``device`` (default ``"cuda"``; pass
``"cpu"`` to run the plain versions on the CPU); ``get_initial_results``,
``compute_all_metrics`` and ``match_clusters`` come from the port's copies
of the host tier (``utils/metrics``, ``ops/matching``).  Data preparation
that needs no pandas is in ``mused_tpu_torch.data.synthetic``.
"""
from __future__ import annotations

from mused_tpu_torch.engine.streaming import process_streaming_data  # noqa: F401
from mused_tpu_torch.ops.matching import match_clusters  # noqa: F401
from mused_tpu_torch.utils.metrics import compute_all_metrics, get_initial_results  # noqa: F401
