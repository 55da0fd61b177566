"""The device trace of a window, read in memory.

``torch.profiler`` records the window's host operators and device
activity (kernels, copies, sets).  :func:`summarize` reduces it to what the
per-layer metrics and the result line need: the seconds in which the device
ran anything (the union of its intervals), the device seconds and launches
of every kernel name, the device operations that took most time, and the idle gaps
between device intervals, each named by the innermost host operator that
was running where the gap began.  Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import collections
import re
import time
from typing import NamedTuple

import torch


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    kernel_s: dict          # device operation name -> seconds
    kernel_n: dict          # device operation name -> launches
    device_ops: list        # [[name, seconds]] the 10 largest
    idle_gaps: list         # [[host operator, seconds]] the 10 largest

    def seconds_of(self, patterns) -> float:
        """Device seconds of the operations whose names hold any pattern."""
        return sum(s for name, s in self.kernel_s.items() if any(p in name for p in patterns))

    def launches_of(self, patterns) -> int:
        """Launches of the device operations whose names hold any pattern."""
        return sum(c for name, c in self.kernel_n.items() if any(p in name for p in patterns))


class Tracer:
    """Profiles the device while entered when ``enabled``; a no-op otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.window_s = 0.0

    def __enter__(self) -> "Tracer":
        if self.enabled:
            act = torch.profiler.ProfilerActivity
            self.prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
            self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.enabled:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        if self.enabled:
            self.prof.__exit__(*exc)


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.]+", "_", name)[:64]


def _union(intervals: list) -> tuple[float, list]:
    """(covered length, merged intervals) of (start, end) pairs."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _events(prof) -> tuple[list, list]:
    """(device, host) lists of (start us, end us, name): from the profiler's
    raw records, or through its event list where those are not exposed."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    try:
        for ev in prof.profiler.kineto_results.events():
            item = (ev.start_ns() * 1e-3, ev.end_ns() * 1e-3, ev.name())
            (device if ev.device_type() == cuda else host).append(item)
    except AttributeError:
        device, host = [], []
        for ev in prof.events():
            item = (ev.time_range.start, ev.time_range.end, ev.name)
            (device if ev.device_type == cuda else host).append(item)
    return device, host


def summarize(tracer: Tracer, lookback: int = 64) -> TraceSummary | None:
    """The trace's summary, or None when the trace holds no device activity."""
    if tracer.prof is None:
        return None
    device, host = _events(tracer.prof)
    if not device:
        return None
    kernel_us: dict = collections.defaultdict(float)
    kernel_n: collections.Counter = collections.Counter()
    for s, e, name in device:
        kernel_us[name] += e - s
        kernel_n[name] += 1
    busy_us, merged = _union([(s, e) for s, e, _ in device])

    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1]) for i in range(len(merged) - 1)]
    host.sort()
    starts = [h[0] for h in host]
    by_host: dict = collections.defaultdict(float)
    for length, at in gaps:
        j = bisect.bisect_right(starts, at) - 1
        best = None
        for h in host[max(0, j - lookback):j + 1][::-1]:
            if h[1] > at:
                best = h
                break
        by_host[best[2] if best else "no host operator"] += length

    def top(d: dict) -> list:
        return [[_short(k), v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:10]]

    return TraceSummary(window_s=tracer.window_s, busy_s=busy_us * 1e-6,
                        kernel_s={k: v * 1e-6 for k, v in kernel_us.items()},
                        kernel_n=dict(kernel_n),
                        device_ops=top(kernel_us), idle_gaps=top(by_host))
