"""Named wall-clock spans — port of ``mused_tpu/utils/profiling.py``.

CUDA work is asynchronous, so a span that ends without waiting measures the
host's time in it: the enqueue, plus whatever the host waited for inside.
As in the JAX package, a span waits at its end only for what it is handed
(``sync=``); the engine's ``fuse`` and ``device_step`` spans hand nothing,
so they never stop the card, and only ``device_sync`` (the label pull)
waits.  A timer built with ``sync_all=True`` synchronizes the device at
every span end instead, so each span covers the device work issued inside
it: measurement code opts in to compare such spans (it serializes the
dispatch-ahead loop).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch


def _cuda_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_cuda else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _cuda_leaves(x)]
    return []


def materialize(tree) -> None:
    """Wait until the device work feeding ``tree``'s CUDA tensors is done: an
    event recorded on each one's device's current stream (a tensor has no
    readiness of its own; stream order puts its producer before the event)."""
    for device in {t.device for t in _cuda_leaves(tree)}:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        event.synchronize()


class SpanTimer:
    """spans: {"fuse": [secs...], "device_step": [...], ...}"""

    def __init__(self, device=None, sync_all: bool = False):
        self.device = None if device is None else torch.device(device)
        self.sync_all = sync_all
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """``sync`` may be a tensor or a tree of tensors to wait for at span
        exit, or a zero-argument callable returning one (for outputs made
        inside the span)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync_all and self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            elif sync is not None:
                materialize(sync() if callable(sync) else sync)
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
