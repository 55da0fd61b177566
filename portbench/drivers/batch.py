"""Closed-loop batch passes: ``process_batch_data`` over a fresh subset per
call, one call after another, featurization and metrics inside each call
(reference main.py:132-167).

The subsets are a pool of ``pool_subsets`` seeded subsets, taken in turn.
The window ends with the last call started within ``--seconds``, so every
call counts whole: batch seconds are the window's wall time over its calls.
"""
from __future__ import annotations

from portbench import tap as tap_mod
from portbench import trace as trace_mod
from portbench.drivers import common
from portbench.drivers.stream import pipeline_config
from portbench.roofline import counts


class Driver:
    def __init__(self, cell, seed: int, device, *, trace: bool, faults=(), overrides=None):
        self.cfg, self.traffic = common.merged(cell, overrides or {})
        self.seed, self.device, self.trace = seed, device, trace
        self.tap = tap_mod.Tap({}, faults)

    def setup(self) -> None:
        from mused_tpu_torch import api
        c, t = self.cfg, self.traffic
        n = c["subset_size"]
        self.pool = [common.make_records(c, n, self.seed * 8 + k)
                     for k in range(t["pool_subsets"])]
        self.pcfg = pipeline_config(c, t, self.seed, n, self.device)
        self.api = api
        self.tap.__enter__()
        self._call(0)            # builds and warms every kernel of the path

    def _call(self, i: int) -> None:
        c, t = self.cfg, self.traffic
        mods, labels = self.pool[i % len(self.pool)]
        self.api.process_batch_data(
            self.api.get_initial_results()[0], mods,
            ["location", "time", "username", "tags", "text"], c["reduced_dim"], c["k_basis"],
            2, self.seed, t["approach"], labels, c["noise_rate"], c["label_mode"],
            c["sort_by_uploaded"], 1.5, 2, 3, c["window_size"], cfg=self.pcfg,
            device=self.device)

    def window(self, seconds: float) -> common.WindowRecord:
        t = self.traffic
        self.check_call = common.draw(self.seed, t["min_calls"], 1, 4)[0]
        self.tap.keep["svd"] = self.tap.keep["kmeans"] = {self.check_call}
        self.tap.arm()
        calls, tracer, syncs = common.closed_loop(self._call, seconds, t["min_calls"],
                                                  self.trace)
        rec = common.WindowRecord(window_s=tracer.window_s, attempted=calls, failed=0,
                                  end_to_end={"batch_s": tracer.window_s / calls},
                                  syncs=syncs.count if syncs else None)
        if self.trace:
            rec.trace = trace_mod.summarize(tracer)
            rec.k23_bound_s = self._k23_bound(calls)
        return rec

    def _padded(self, mods):
        block = self.cfg["block_rows"]
        n = len(mods[0])
        return common.featurize(self.cfg, mods, pad_to=n + (-n) % block)

    def _k23_bound(self, calls: int) -> float:
        c = self.cfg
        per = [counts.k23_window_s(self._padded(mods), block=c["block_rows"], nbins=c["nbins"])
               for mods, _ in self.pool]
        return sum(per[i % len(per)] for i in range(calls))

    def release(self) -> None:
        self.tap.__exit__(None, None, None)

    def check(self) -> dict:
        c = self.cfg
        i = self.check_call
        mods, _ = self.pool[i % len(self.pool)]
        rec = self._padded(mods)
        return common.blocked_check(c, rec, self.tap.blocks.get(i, {}), self.tap.reduced[i],
                                    self.tap.labels[i].cpu().numpy(), block=c["block_rows"],
                                    nbins=c["nbins"], device=self.device)
