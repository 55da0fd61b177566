"""Sweep the serving cell's offered rate on the card, to find the highest
rate at which no run's backlog grows.

    python -m portbench.sweep --workload w2000-serve --seed <n> --seconds <s> \
        --rates 30000 40000 ...

For each rate (records/s) it runs the cell's window at that rate and
prints one JSON line: the window latency's p50 / p95 / max, the mean
latency of the last quarter of windows less that of the first quarter (a
backlog that grows makes it large), and how late the generator ran.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="w2000-serve")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    for rate in args.rates:
        over = {"traffic": {"rate_records_per_s": rate}}
        drv = harness.driver_of(cell).Driver(cell, args.seed, torch.device("cuda"),
                                             trace=False, overrides=over)
        t0 = time.perf_counter()
        drv.setup()
        win = drv.window(args.seconds)
        drv.release()
        lat = np.asarray(win.latencies_ms)
        q = max(1, len(lat) // 4)
        print(json.dumps({"rate": rate, "windows": len(lat), "setup_s": time.perf_counter() - t0,
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p95_ms": float(np.percentile(lat, 95)), "max_ms": float(lat.max()),
                          "growth_ms": float(lat[-q:].mean() - lat[:q].mean()),
                          "generator_late_s": drv.generator_late_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
