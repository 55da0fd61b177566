"""Double-buffered host -> device ingest — port of ``mused_tpu/data/ingest.py``.

A worker thread featurizes window w+1 (tokenize / hash,
``mused_tpu_torch.data.features`` and its native hasher, which releases the
GIL) while the device computes window w.  Each featurized numpy array
becomes a torch tensor, pinned when the target is a CUDA device, and is
copied with ``non_blocking=True``: the copy is enqueued on the device's
stream and overlaps compute, and stream order makes it complete before any
later kernel reads it.  While spans record (``utils/profiling``), the
consumer's wait for a window is the span ``ingest.wait``, keyed by the
window's position in the prefetcher's order.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Iterator

import numpy as np
import torch

from mused_tpu_torch.data import features as feat
from mused_tpu_torch.utils import profiling


def to_device(arrays, device: torch.device) -> tuple:
    """numpy arrays -> tensors on ``device`` (pinned, non-blocking for CUDA)."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        elif t.device != device:
            t = t.to(device)
        out.append(t)
    return tuple(out)


def pad_window_features(wf, pad: int):
    """Append ``pad`` invalid rows to featurized rows (NaN coordinates, zero
    times, -1 ids, no tokens), so a huge window divides into row blocks;
    port of ``mused_tpu/engine/batch._pad_window_features``."""
    rows = ((0, pad), (0, 0))
    common = dict(location=np.pad(wf.location, rows, constant_values=np.nan),
                  times=np.pad(wf.times, rows),
                  user_ids=np.pad(wf.user_ids, (0, pad), constant_values=-1),
                  tags_valid=np.pad(wf.tags_valid, (0, pad), constant_values=False))
    if isinstance(wf, feat.SparseWindowFeatures):
        return feat.SparseWindowFeatures(
            tags_ids=np.pad(wf.tags_ids, rows, constant_values=-1),
            text_ids=np.pad(wf.text_ids, rows, constant_values=-1),
            text_cnt=np.pad(wf.text_cnt, rows), **common)
    return feat.WindowFeatures(tags=np.pad(wf.tags, rows), text=np.pad(wf.text, rows),
                               **common)


class WindowPrefetcher:
    """Iterate featurized windows with ``depth`` windows prepared ahead.

    ``featurize(window_index) -> tuple of numpy arrays`` runs in a worker
    thread; the results arrive as tensors on ``device``."""

    def __init__(self, featurize: Callable[[int], tuple], n_windows: int,
                 device, depth: int = 2):
        self._featurize = featurize
        self._n = n_windows
        self._depth = max(1, depth)
        self._device = torch.device(device)
        self._pool = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ingest")

    def _task(self, idx: int):
        feats = self._featurize(idx)
        return feats, to_device(feats, self._device)

    def __iter__(self) -> Iterator:
        """Yields (host features, device tensors) per window, in order."""
        pending: list[cf.Future] = []
        nxt = 0
        while nxt < min(self._depth, self._n):
            pending.append(self._pool.submit(self._task, nxt))
            nxt += 1
        for pos in range(self._n):
            fut = pending.pop(0)
            if nxt < self._n:
                pending.append(self._pool.submit(self._task, nxt))
                nxt += 1
            with profiling.span("ingest.wait", key=pos):
                out = fut.result()
            yield out

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)
