"""Open-loop serving: records arrive at a fixed rate and are pushed to one
``StreamDetector`` in chunks as soon as each chunk is due.

The generator never waits for the detector: chunk j is due at
t0 + (j + 1) * push_records / rate, and a chunk pushed late is pushed at
once.  A window's latency runs from the time its last record was due to
the time a ``push`` (or the closing ``flush``) returned its events.  The
window pushes every chunk due within ``--seconds`` (a fixed amount of work
per run), then flushes.  Records come from a pool of ``pool_records``
records made from ``--seed``, taken in order and round again from a window
that the seed also picks.
"""
from __future__ import annotations

import time

import numpy as np

from portbench import tap as tap_mod
from portbench import trace as trace_mod
from portbench.drivers import common
from portbench.reference import graphs, judge
from portbench.roofline import counts


class Driver:
    def __init__(self, cell, seed: int, device, *, trace: bool, faults=(), overrides=None):
        self.cfg, self.traffic = common.merged(cell, overrides or {})
        self.seed, self.device, self.trace = seed, device, trace
        self.tap = tap_mod.Tap({}, faults)
        self.det = None

    # ------------------------------------------------------------------
    def _chunk(self, j: int) -> list:
        p, pool = self.traffic["push_records"], self.traffic["pool_records"]
        lo = (self.offset + j * p) % pool
        return common.slice_rows(self.mods, lo, lo + p)

    def _window_start(self, w: int) -> int:
        """Pool position of measured window w's first record."""
        return (self.offset + self.warm_records + w * self.cfg["window_size"]) \
            % self.traffic["pool_records"]

    def _window_rows(self, w: int) -> list:
        lo = self._window_start(w)
        return common.slice_rows(self.mods, lo, lo + self.cfg["window_size"])

    def setup(self) -> None:
        from mused_tpu_torch import api
        from mused_tpu_torch.engine.streaming import STANDARD_TYPES
        from mused_tpu_torch.utils.config import PipelineConfig
        c, t = self.cfg, self.traffic
        if t["pool_records"] % c["window_size"] or c["window_size"] % t["push_records"]:
            raise ValueError("the pool must hold whole windows of whole pushes")
        self.mods, _ = common.make_records(c, t["pool_records"], self.seed)
        self.offset = self.seed % (t["pool_records"] // c["window_size"]) * c["window_size"]
        self.tap.__enter__()
        # StreamDetector's own configuration of these arguments; off the card
        # the kernels' plain versions stand in for them
        pcfg = PipelineConfig(
            window_size=c["window_size"], reduced_dim=c["reduced_dim"], k_basis=c["k_basis"],
            approach=t["approach"], seed=self.seed, label_mode="all",
            n_clusters_override=t["max_events"], matching="auto", k_estimate=t["k_estimate"],
            step_window_ratio=c["step_window_ratio"], background_bucket=t["background"],
            use_pallas_affinity=None if self.device.type == "cuda" else True)
        self.det = api.StreamDetector(
            STANDARD_TYPES, c["window_size"], cfg=pcfg, max_lag=t["max_lag"],
            dispatch_ahead=t["dispatch_ahead"], device=self.device)
        per_window = c["window_size"] // t["push_records"]
        self.warm_chunks = t["warmup_windows"] * per_window
        self.warm_records = self.warm_chunks * t["push_records"]
        for j in range(self.warm_chunks):
            self.det.push(self._chunk(j))
        self.det.flush()

    def window(self, seconds: float) -> common.WindowRecord:
        c, t = self.cfg, self.traffic
        p, rate, win = t["push_records"], float(t["rate_records_per_s"]), c["window_size"]
        per_window = win // p
        n_chunks = max(per_window, int(rate * seconds) // p // per_window * per_window)
        n_windows = n_chunks // per_window
        self.check_windows = common.draw(self.seed, n_windows, t["check_windows"], 1)
        self.tap.keep["graphs"] = self.tap.keep["step"] = set(self.check_windows)
        self.tap.arm()
        returned: dict = {}
        late = 0.0
        syncs = tap_mod.SyncCounter() if self.trace else None
        with trace_mod.Tracer(self.trace) as tracer:
            if syncs:
                syncs.__enter__()
            t0 = time.perf_counter()
            for j in range(n_chunks):
                due = t0 + (j + 1) * p / rate
                now = time.perf_counter()
                if now < due:
                    time.sleep(due - now)
                else:
                    late = max(late, now - due)
                for r in self.det.push(self._chunk(self.warm_chunks + j)):
                    returned[r.window_index] = (time.perf_counter(), r)
            for r in self.det.flush():
                returned[r.window_index] = (time.perf_counter(), r)
            if syncs:
                syncs.__exit__(None, None, None)
        window_s = tracer.window_s
        base = t["warmup_windows"]       # the detector counts the warm-up's windows too
        self.results = {}
        lat = []
        for idx, (at, r) in returned.items():
            w = idx - base
            if 0 <= w < n_windows:
                self.results[w] = r
                lat.append((at - (t0 + (w + 1) * win / rate)) * 1e3)
        rec = common.WindowRecord(
            window_s=window_s, attempted=n_windows, failed=n_windows - len(self.results),
            end_to_end={"window_latency_p95_ms": float(np.percentile(lat, 95))},
            windows=len(self.results), latencies_ms=lat,
            syncs=syncs.count if syncs else None)
        self.generator_late_s = late
        if self.trace:
            rec.trace = trace_mod.summarize(tracer)
            rec.k1_bound_s = self._k1_bound(n_windows)
        return rec

    def _k1_bound(self, n_windows: int) -> float:
        """K1's bound summed over every measured window (each pool window
        featurized once)."""
        cache: dict = {}
        total = 0.0
        for w in range(n_windows):
            lo = self._window_start(w)
            if lo not in cache:
                rec = common.featurize(self.cfg, self._window_rows(w))
                cache[lo] = counts.k1_window_s(rec, self.cfg["k_basis"])
            total += cache[lo]
        return total

    def release(self) -> None:
        self.tap.__exit__(None, None, None)
        self.det = None

    # ------------------------------------------------------------------
    def check(self) -> dict:
        c = self.cfg
        out: dict = {}
        for w in self.check_windows:
            rec = common.featurize(c, self._window_rows(w))
            p = common.panels(c, rec, self.device)
            ref = graphs.dense_graphs(p, c["k_basis"])
            prog = self.tap.graphs.get(w)
            fused_prog = fused_ref = None
            for m, g in ref.items():
                fused_ref = g if fused_ref is None else fused_ref | g
                if prog is None:
                    v = float("inf")
                else:
                    diff = graphs.popcount(graphs.packbits(g) ^ prog[m])
                    v = judge.graph_mismatch(diff, int(g.sum()))
                    pm = graphs.unpackbits(prog[m])
                    fused_prog = pm if fused_prog is None else fused_prog | pm
                key = f"knn_mismatch.{m}"
                out[key] = max(out.get(key, 0.0), v)
            del p, ref
            reduced, labels = self.tap.reduced.get(w), self.tap.labels.get(w)
            ok = reduced is not None and fused_prog is not None
            fd = judge.fd_excess(reduced, fused_prog) if ok else float("inf")
            out["fd_excess"] = max(out.get("fd_excess", -float("inf")), fd)
            deficit = (judge.fd_deficit(reduced, fused_ref, c["reduced_dim"])
                       if reduced is not None else float("inf"))
            out["fd_deficit"] = max(out.get("fd_deficit", -float("inf")), deficit)
            del fused_ref
            cost = (judge.label_cost_excess(labels.cpu().numpy(), reduced)
                    if reduced is not None and labels is not None else float("inf"))
            out["label_cost_excess"] = max(out.get("label_cost_excess", -float("inf")), cost)
        return out
