"""Readings that set the limits of a cell's check, on the card.

    python -m portbench.control --workload <name> --seeds <n> ... \
        --control-seeds <n> ... --seconds <s> [--fault <name>] [--min-calls <n>]

For each of ``--seeds`` it makes a short run of the cell (set-up, a window
of ``--seconds``, the check) and prints the numbers compared: the sound
program's readings, or with ``--fault`` those of the program with that
fault planted in its timed path (``portbench.tap.FAULTS``); ``--min-calls``
lowers a closed-loop cell's least number of calls in the window (each call
is the cell's own size).  For each of
``--control-seeds`` it puts the reference in the program's place, computed
one precision below the configuration's float32 (TF32 products), on the
same records and the same draw of what the check compares, and prints the
numbers that control reaches: the dense
cell's kNN graphs, a blocked cell's graph and its randomized SVD (the
program's algorithm: a Gaussian test matrix from the seed, 2 power
iterations, 8 extra columns).  Each line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness
from portbench.drivers import common
from portbench.reference import graphs, judge


class tf32:
    """TF32 products while entered."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def control_dense(cell, seed: int, seconds: float, device) -> dict:
    """The serving cell: the control's kNN graphs of the windows the check
    would draw."""
    c, t = cell.config, cell.traffic
    mods, _ = common.make_records(c, t["pool_records"], seed)
    win, p, rate = c["window_size"], t["push_records"], float(t["rate_records_per_s"])
    per_window = win // p
    n_windows = max(per_window, int(rate * seconds) // p // per_window * per_window) // per_window
    start = seed % (t["pool_records"] // win) * win + t["warmup_windows"] * win
    out: dict = {}
    for w in common.draw(seed, n_windows, t["check_windows"], 1):
        lo = (start + w * win) % t["pool_records"]
        rec = common.featurize(c, common.slice_rows(mods, lo, lo + win))
        ref = graphs.dense_graphs(common.panels(c, rec, device), c["k_basis"])
        with tf32():
            ctl = graphs.dense_graphs(common.panels(c, rec, device, dtype=torch.float32),
                                      c["k_basis"])
        for m in ref:
            diff = int((ref[m] ^ ctl[m]).sum())
            key = f"knn_mismatch.{m}"
            out[key] = max(out.get(key, 0.0), judge.graph_mismatch(diff, int(ref[m].sum())))
    return out


def control_blocked(cell, seed: int, device) -> dict:
    """A blocked cell: the control's graph and its randomized SVD of one
    window or subset of the cell's records."""
    c, t = cell.config, cell.traffic
    block, nbins = c["block_rows"], c["nbins"]
    if t["generator"] == "batch":
        mods, _ = common.make_records(c, c["subset_size"], seed * 8)
        n = len(mods[0])
        rec = common.featurize(c, mods, pad_to=n + (-n) % block)
    else:
        mods, _ = common.make_records(c, t["pool_windows"] * c["window_size"], seed)
        rec = common.featurize(c, common.slice_rows(mods, 0, c["window_size"]))
    n = len(rec.latlon)
    ref = common.panels(c, rec, device, text_bf16=True)
    ctl = common.panels(c, rec, device, dtype=torch.float32, text_bf16=True)
    blocks, diff, edges = {}, 0, 0
    exact, refs = common.Sparse(n, device), common.Sparse(n, device)
    with tf32():
        for lo in range(0, n, block):
            mine = graphs.binned_block(ref, lo, lo + block, c["k_basis"], nbins)
            theirs = graphs.binned_block(ctl, lo, lo + block, c["k_basis"], nbins)
            diff += int((mine ^ theirs).sum())
            edges += int(mine.sum())
            blocks[lo] = graphs.packbits(theirs)
            exact.add(lo, theirs)
            refs.add(lo, mine)
            del mine, theirs
    del ref, ctl
    exact.done()

    def mul_a(v):
        acc = torch.zeros((n, v.shape[1]), dtype=torch.float32, device=device)
        for lo, b in blocks.items():
            acc[lo:lo + block] = graphs.unpackbits(b).float() @ v
        return acc

    def mul_at(v):
        acc = torch.zeros((n, v.shape[1]), dtype=torch.float32, device=device)
        for lo, b in blocks.items():
            acc += graphs.unpackbits(b).float().T @ v[lo:lo + block]
        return acc

    rank = c["reduced_dim"]
    r = min(rank + 8, n)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    with tf32():
        omega = torch.randn((n, r), generator=gen, device=device)
        q = torch.linalg.qr(mul_a(omega))[0]
        for _ in range(2):
            q = torch.linalg.qr(mul_a(torch.linalg.qr(mul_at(q))[0]))[0]
        ub, s, _ = torch.linalg.svd(mul_at(q).T, full_matrices=False)
        u = (q @ ub)[:, :rank] * s[None, :rank]
    identity = judge.svd_identity(u, exact.tmul)
    del exact
    refs.done(both=True)
    energy = judge.top_energy(refs.mul, refs.tmul, n, rank, device=device)
    return {"graph_mismatch": judge.graph_mismatch(diff, edges),
            "svd_identity": identity,
            "svd_energy_gap": judge.svd_energy_gap(u.double(), energy)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--min-calls", type=int, default=None)
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    device = torch.device("cuda")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    over = {"traffic": {"min_calls": args.min_calls}} if args.min_calls else {}
    for seed in args.seeds:
        out = harness.run_cell(cell, seed, args.seconds, False, t_start=time.perf_counter(),
                               faults=(args.fault,) if args.fault else (), overrides=over)
        print(json.dumps({"side": args.fault or "program", "seed": seed,
                          "correct": out["correct"],
                          "numbers": {k: v["value"] for k, v in out["compared"].items()},
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()}}),
              flush=True)
    for seed in args.control_seeds:
        if cell.traffic["generator"] == "serve":
            nums = control_dense(cell, seed, args.seconds, device)
        else:
            nums = control_blocked(cell, seed, device)
        print(json.dumps({"side": "control", "seed": seed, "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
