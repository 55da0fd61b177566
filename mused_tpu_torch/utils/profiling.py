"""Named wall-clock spans — port of ``mused_tpu/utils/profiling.py``.

CUDA work is asynchronous, so a span that ends without waiting measures
only the enqueue.  ``SpanTimer(device)`` synchronizes a CUDA device at
every span end: each span then covers the device work issued inside it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch


class SpanTimer:
    """spans: {"fuse": [secs...], "device_step": [...], ...}"""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, xs in self.spans.items():
            arr = np.asarray(xs)
            out[name] = {"count": len(xs), "total_s": float(arr.sum()),
                         "mean_ms": float(arr.mean() * 1e3),
                         "p50_ms": float(np.percentile(arr, 50) * 1e3),
                         "p95_ms": float(np.percentile(arr, 95) * 1e3)}
        return out
