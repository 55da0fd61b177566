"""Named spans on the profiler's clock, and the per-engine ``SpanTimer``.

The recorder.  :func:`span`, :func:`interval` and :func:`counter` write
:class:`Record` s into one process-wide ring of the newest
:data:`RING_SIZE`, read by :func:`recorded` and emptied by :func:`clear`.
They record only while a torch profiler runs (the process-wide flag, so a
worker thread records too) or inside :func:`recording`; otherwise a span is
one flag read and a return, and makes no event, no range in the trace and
no record.  Timestamps are ``time.time_ns()``, the clock of the profiler's
own events, so a span lies beside the device trace.  A span opened on the
thread that started the profiler also enters a function-scope
``RecordFunction`` of its name (``torch._C._profiler._RecordFunctionFast``)
and shows in the trace as a host operator.  It is not
``torch.profiler.record_function``: that one's user-scope range is also
projected onto the device as a ``gpu_user_annotation`` event, which a
reader that takes every CUDA event for device work counts as busy time.  A
span opened with ``device=True`` records two timing-enabled CUDA events on
the current stream; its ``device_ms`` is their device extent, resolved when
read after the work completed (never by waiting for it).

A record's ``key`` is the stream window index or the batch call number, so
the spans of one window share it; ``parent`` names the enclosing span on
the recording thread, or the one given.  A span with no key takes its
enclosing span's.

``SpanTimer``: CUDA work is asynchronous, so a span that ends without
waiting measures the host's time in it: the enqueue, plus whatever the host
waited for inside.  The engine's ``fuse`` and ``device_step`` spans never
stop the card, and only ``device_sync`` (the label pull) waits.  A timer
built with ``sync_all=True`` synchronizes the device at every span end
instead, so each span covers the device work issued inside it: measurement
code opts in to compare such spans (it serializes the dispatch-ahead loop).
Each of its spans is also a recorder span.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

RING_SIZE = 65_536

_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_forced = 0                   # depth of open recording() contexts
_forced_lock = threading.Lock()
_local = threading.local()    # .stack: the thread's open spans
# a host-only range in the profiler's trace (see the module docstring)
_HostRange = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class Record:
    """One span or counter.  ``counters`` is None for a span."""

    __slots__ = ("name", "parent", "key", "thread", "start_ns", "end_ns", "counters",
                 "_events", "_device_ms")

    def __init__(self, name, parent, key, thread, start_ns, end_ns, counters=None,
                 events=None):
        self.name, self.parent, self.key, self.thread = name, parent, key, thread
        self.start_ns, self.end_ns, self.counters = start_ns, end_ns, counters
        self._events, self._device_ms = events, None

    @property
    def ms(self) -> float:
        """Host duration in milliseconds."""
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> float | None:
        """Device extent of a ``device=True`` span in milliseconds, once its
        end event has completed; None before that, or for other records."""
        if self._events is not None and self._events[1].query():
            start, end = self._events
            self._device_ms, self._events = start.elapsed_time(end), None
        return self._device_ms

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, key={self.key!r}, parent={self.parent!r}, "
                f"thread={self.thread!r}, ms={self.ms:.3f}, counters={self.counters!r})")


def on() -> bool:
    """Whether spans record now: a torch profiler runs, or :func:`recording`."""
    return bool(_forced or _autograd_profiler._is_profiler_enabled)


@contextlib.contextmanager
def recording():
    """Record spans inside this context without a profiler."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced -= 1


def recorded() -> list:
    """The ring's records, oldest first."""
    return list(_ring)


def clear() -> None:
    _ring.clear()


def _enclosing():
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class _Span:
    __slots__ = ("name", "key", "parent", "device", "start_ns", "_rf", "_events")

    def __init__(self, name, key, parent, device):
        self.name, self.key, self.parent, self.device = name, key, parent, device

    def __enter__(self):
        outer = _enclosing()
        if outer is not None:
            self.parent = self.parent if self.parent is not None else outer.name
            self.key = self.key if self.key is not None else outer.key
        else:
            _local.stack = []
        _local.stack.append(self)
        self.start_ns = time.time_ns()
        # only the thread that started the profiler has it on in the C flag
        self._rf = (_HostRange(self.name) if _HostRange is not None
                    and torch._C._autograd._profiler_enabled() else None)
        if self._rf is not None:
            self._rf.__enter__()
        self._events = None
        if self.device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.time_ns()
        _local.stack.pop()
        _ring.append(Record(self.name, self.parent, self.key,
                            threading.current_thread().name, self.start_ns, end,
                            events=self._events))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, *, key=None, parent: str | None = None, device: bool = False):
    """A context that records ``name`` from entry to exit while :func:`on`."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, key, parent, device)


def interval(name: str, start_ns: int, end_ns: int, *, key=None,
             parent: str | None = None) -> None:
    """Record a span whose ends were stamped elsewhere (``time.time_ns()``),
    such as one that crosses threads."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    outer = _enclosing()
    if outer is not None:
        parent = parent if parent is not None else outer.name
        key = key if key is not None else outer.key
    _ring.append(Record(name, parent, key, threading.current_thread().name,
                        start_ns, end_ns))


def counter(name: str, value, *, key=None) -> None:
    """Record a count (``counters`` = {name: value}) at this moment."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    outer = _enclosing()
    parent = None if outer is None else outer.name
    key = key if key is not None or outer is None else outer.key
    now = time.time_ns()
    _ring.append(Record(name, parent, key, threading.current_thread().name, now, now,
                        counters={name: value}))


class SpanTimer:
    """spans: {"fuse": [secs...], "device_step": [...], ...}"""

    def __init__(self, device=None, sync_all: bool = False):
        self.device = None if device is None else torch.device(device)
        self.sync_all = sync_all
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                try:
                    yield
                finally:
                    if (self.sync_all and self.device is not None
                            and self.device.type == "cuda"):
                        torch.cuda.synchronize(self.device)
        finally:
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
