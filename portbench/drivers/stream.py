"""Closed-loop offline streaming: ``process_streaming_data`` over calls of
``windows_per_call`` tumbling windows, one call after another.

The records are a pool of ``pool_windows`` seeded windows; call i takes
the pool's calls in turn.  One engine serves every call, so its timer can
be read.  The window ends with the last call started within ``--seconds``,
so every call counts whole: records/s is the records of those calls over
the window's wall time.
"""
from __future__ import annotations

import dataclasses

from portbench import tap as tap_mod
from portbench import trace as trace_mod
from portbench.drivers import common
from portbench.roofline import counts


def pipeline_config(c: dict, t: dict, seed: int, n_records: int, device):
    """The configuration ``process_streaming_data`` builds from its
    arguments, with the route the card takes also where it runs elsewhere."""
    from mused_tpu_torch.utils.config import PipelineConfig
    cfg = PipelineConfig(
        seed=seed, subset_size=n_records, noise_rate=c["noise_rate"],
        label_mode=c["label_mode"], sorting=c["sort_by_uploaded"],
        window_size=c["window_size"], reduced_dim=c["reduced_dim"], k_basis=c["k_basis"],
        step_window_ratio=c["step_window_ratio"], approach=t["approach"],
        n_clusters_override=2 if c["label_mode"] == "binary" else None)
    if device.type != "cuda":     # the binned route, which is the card's
        cfg = dataclasses.replace(cfg, huge_window_fused_select=True,
                                  force_blocked_window=True, force_blocked_batch=True)
    return cfg


class Driver:
    def __init__(self, cell, seed: int, device, *, trace: bool, faults=(), overrides=None):
        self.cfg, self.traffic = common.merged(cell, overrides or {})
        self.seed, self.device, self.trace = seed, device, trace
        self.tap = tap_mod.Tap({}, faults)

    def setup(self) -> None:
        from mused_tpu_torch import api
        from mused_tpu_torch.engine.streaming import StreamingEngine
        from mused_tpu_torch.utils.profiling import SpanTimer
        c, t = self.cfg, self.traffic
        win, per = c["window_size"], t["windows_per_call"]
        self.mods, self.labels = common.make_records(c, t["pool_windows"] * win, self.seed)
        self.n_calls = t["pool_windows"] // per
        self.call_records = per * win
        self.pcfg = pipeline_config(c, t, self.seed, self.call_records, self.device)
        self.engine = StreamingEngine(self.pcfg, self.device)
        if self.trace:   # spans that cover the device work they issue
            self.engine.timer = SpanTimer(self.device, sync_all=True)
        self.api = api
        self.tap.__enter__()
        self._call(0)            # builds and warms every kernel of the path
        self.engine.timer.spans.clear()

    def _call(self, i: int) -> None:
        c, t = self.cfg, self.traffic
        lo = (i % self.n_calls) * self.call_records
        hi = lo + self.call_records
        self.api.process_streaming_data(
            self.api.get_initial_results()[0], common.slice_rows(self.mods, lo, hi),
            ["location", "time", "username", "tags", "text"], c["window_size"],
            c["reduced_dim"], c["k_basis"], 2, self.seed, t["approach"], self.labels[lo:hi],
            c["step_window_ratio"], c["noise_rate"], c["label_mode"], c["sort_by_uploaded"],
            1.5, 2, cfg=self.pcfg, engine=self.engine, device=self.device)

    def window(self, seconds: float) -> common.WindowRecord:
        t = self.traffic
        per = t["windows_per_call"]
        # the check's call: drawn from those that surely run (the first few)
        self.check_call = common.draw(self.seed, t["min_calls"], 1, 2)[0]
        self.check_window = self.check_call * per + common.draw(self.seed, per, 1, 3)[0]
        self.tap.keep["svd"] = self.tap.keep["kmeans"] = {self.check_window}
        self.tap.arm()
        calls, tracer, syncs = common.closed_loop(self._call, seconds, t["min_calls"],
                                                  self.trace)
        windows = calls * per
        rec = common.WindowRecord(
            window_s=tracer.window_s, attempted=windows, failed=0,
            end_to_end={"records_per_s": windows * self.cfg["window_size"] / tracer.window_s},
            windows=windows, spans={k: list(v) for k, v in self.engine.timer.spans.items()})
        if self.trace:
            rec.trace = trace_mod.summarize(tracer)
            # the timer's own waits are not the program's
            rec.syncs = syncs.count - sum(len(v) for v in rec.spans.values())
            rec.k23_bound_s = self._k23_bound(calls)
        return rec

    def _k23_bound(self, calls: int) -> float:
        c, t = self.cfg, self.traffic
        win = c["window_size"]
        per_window = {}
        for w in range(t["pool_windows"]):
            rec = common.featurize(c, common.slice_rows(self.mods, w * win, (w + 1) * win))
            per_window[w] = counts.k23_window_s(rec, block=c["block_rows"], nbins=c["nbins"])
        total = 0.0
        for i in range(calls):
            first = (i % self.n_calls) * t["windows_per_call"]
            total += sum(per_window[first + k] for k in range(t["windows_per_call"]))
        return total

    def release(self) -> None:
        self.tap.__exit__(None, None, None)
        self.engine = None

    def check(self) -> dict:
        c, t = self.cfg, self.traffic
        win, w = c["window_size"], self.check_window
        pos = w % t["pool_windows"]
        rows = common.slice_rows(self.mods, pos * win, (pos + 1) * win)
        rec = common.featurize(c, rows)
        return common.blocked_check(c, rec, self.tap.blocks.get(w, {}), self.tap.reduced[w],
                                    self.tap.labels[w].cpu().numpy(), block=c["block_rows"],
                                    nbins=c["nbins"],
                                    device=self.device)
