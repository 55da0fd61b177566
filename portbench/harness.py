"""One run of one cell: set-up, the measured window, the check, the result.

Everything is found by name.  ``BENCHMARK.json`` names the cell's
configuration (``portbench/configs/<name>.json``) and traffic mix
(``portbench/traffic/<name>.json``); the traffic file names its generator
(``portbench/drivers/<generator>.py``) and the limits of the numbers its
check compares; each per-layer metric is ``portbench/metrics/<name>.py``,
whose ``read(run)`` returns a number or None.  A new cell is a new entry
in ``BENCHMARK.json`` with its files; nothing here changes.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
BANNED = {"jax", "jaxlib", "flax", "mused_tpu"}


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(*parts) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def resolve(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json("configs", os.path.basename(cfg_entry["file"]))
    traffic = _load_json("traffic", w["traffic"] + ".json")

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in reported]
    return Cell(name, config, traffic, int(w["chips"]), e2e, layer)


def driver_of(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['generator']}")


def metric_reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def device_info(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count)),
            "power_limit": power_limit()}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number at or under its limit; a missing or non-finite one fails."""
    compared, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        compared[name] = {"value": v, "limit": limit}
    return ok, compared


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, t_start: float,
             device="cuda", faults: tuple = (), overrides: dict | None = None) -> dict:
    """The result line of one run (see the module docstring)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
                             f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.cuda.reset_peak_memory_stats()
    drv = driver_of(cell).Driver(cell, seed, device, trace=trace, faults=faults,
                                 overrides=overrides or {})
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    win = drv.window(seconds)
    dev = device_info(device, cell.chips)
    if trace:
        dev.update(busy_s=win.trace.busy_s if win.trace else 0.0,
                   window_s=win.trace.window_s if win.trace else win.window_s)
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.check()
    correct, compared = judge(numbers, cell.traffic["limits"])

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": win.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    out = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if trace and win.trace:
        out["breakdown"] = {"device_ops": win.trace.device_ops,
                            "idle_gaps": win.trace.idle_gaps}
    out["compared"] = compared
    return out
