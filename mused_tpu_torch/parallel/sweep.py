"""Sweep-level scale-out: independent experiment points across devices —
port of ``mused_tpu/parallel/sweep.py``.

The reference's sweep loop (main.py:176-240) is embarrassingly parallel
across (approach, variable value) points.  Here one thread per device runs
one point at a time, the device named explicitly: ``fn(point, device)``
(the JAX package enters ``jax.default_device``; torch has no such context,
so the device is an argument, and each worker thread also makes it the
current CUDA device).

``main.run_experiment(parallel=True)`` keeps the sweep quirk-exact with its
two-phase design: a sequential data-only pass chains the reference's
measured noise rates through the sweep order first (main.py:196), then the
points run here with their phase-1 parameter snapshots.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import queue
from typing import Callable, Sequence

import torch


def sweep_devices(device="cuda") -> list[torch.device]:
    """The devices a sweep on ``device`` fans out over: every visible card
    for a bare ``"cuda"``, else the one device named (the CPU only when the
    caller asks for it).  ``"cuda"`` without a card raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if device.index is not None:
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def parallel_sweep(fn: Callable, points: Sequence, devices: Sequence | None = None) -> list:
    """``[fn(point, device) for point in points]`` with one device per
    in-flight point.  A point checks a device out of a queue and returns it
    when done, so a device never runs two points at once while another
    idles.  ``devices`` defaults to every visible card
    (:func:`sweep_devices`).  Results come back in point order; an
    exception propagates after every point has finished."""
    devices = [torch.device(d) for d in (sweep_devices() if devices is None else devices)]
    if not devices:
        raise ValueError("parallel_sweep needs at least one device")
    free: queue.Queue = queue.Queue()
    for d in devices:
        free.put(d)

    def run_one(point):
        dev = free.get()
        try:
            ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            with ctx:
                return fn(point, dev)
        finally:
            free.put(dev)

    with cf.ThreadPoolExecutor(max_workers=len(devices)) as pool:
        futures = [pool.submit(run_one, p) for p in points]
        cf.wait(futures)
    return [f.result() for f in futures]
