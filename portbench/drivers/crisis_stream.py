"""Closed-loop offline streaming of CrisisMMD-style embedding records
through blocked spectral clustering: ``process_streaming_data`` with
approach sSpectral, the eigengap count capped at the configuration's
``n_clusters_cap`` and the background bucket, over calls of
``windows_per_call`` tumbling windows, one call after another.

As in ``drivers/stream``: the records are a pool of ``pool_windows``
seeded windows (``portbench/gen/crisis_synth``), call i takes the pool's
calls in turn, one engine serves every call, and records/s is the records
of the calls started within ``--seconds`` over the window's wall time.

What the check reads comes from two taps.  ``portbench/tap.Tap`` keeps
the drawn window's k-means labels and plants its own faults.
:class:`SpectralTap` wraps ``ops/blocked_spectral`` for the length of a
run: for the drawn window it keeps the returned Ritz vectors and values,
the cluster count the labels took, and the row blocks of the degree sweep
(the graph every sweep rebuilds).  Its faults (:data:`FAULTS`) are taken
out of the list before ``Tap`` sees the rest: ``ritz_tf32`` computes the
product sweeps in TF32 (their operands and results rounded to 10 mantissa
bits, and on a card TF32 matrix products through the embedding);
``ritz_half_rows`` drops the second half of every row block from each
product sweep, after the degree sweep.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench import tap as tap_mod
from portbench import trace as trace_mod
from portbench.drivers import common
from portbench.gen import crisis_synth
from portbench.reference import graphs, judge
from portbench.reference import spectral as ref_spectral
from portbench.roofline import mma_counts

FAULTS = ("ritz_tf32", "ritz_half_rows")
OVERSAMPLE = 8      # blocked spectral's extra Ritz columns over the cap
MODALITY_TYPES = ["embedding", "embedding"]


@dataclasses.dataclass
class CrisisWindowRecord(common.WindowRecord):
    mma_plane_bound_s: float | None = None   # one tensor-core plane's bound


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class SpectralTap:
    """Copies of what blocked spectral clustering returned for the window
    ``keep`` (counted from :meth:`arm`), and the faults above planted."""

    def __init__(self, faults: tuple = ()):
        self.faults = tuple(faults)
        self.keep = None
        self.ritz = self.lam = self.n_clusters = None
        self.blocks: dict = {}           # start -> packed (block, n / 8) of the degree sweep
        self.armed = False
        self._count = 0
        self._pending = self._capture = self._drop = False
        self._undo: list = []

    def arm(self) -> None:
        self._count, self.armed = 0, True

    def _patch(self, module, name: str, make) -> None:
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        self._undo.append((module, name, orig))

    def __enter__(self) -> "SpectralTap":
        from mused_tpu_torch.ops import blocked_affinity as ba
        from mused_tpu_torch.ops import blocked_spectral as bspec
        tf32 = "ritz_tf32" in self.faults

        def embedding(orig):
            def wrapped(*a, **kw):
                i = None
                if self.armed:
                    i, self._count = self._count, self._count + 1
                self._pending = i is not None and i == self.keep
                saved = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = saved or tf32
                try:
                    ritz, lam = orig(*a, **kw)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = saved
                if self._pending:
                    self.ritz, self.lam = ritz.detach().clone(), lam.detach().clone()
                return ritz, lam
            return wrapped

        def degrees(orig):
            def wrapped(*a, **kw):
                self._capture = self._pending
                try:
                    return orig(*a, **kw)
                finally:
                    self._capture = False
            return wrapped

        def sym_matmul(orig):
            def wrapped(cols, v, *a, **kw):
                self._drop = "ritz_half_rows" in self.faults
                try:
                    out = orig(cols, tf32_round(v) if tf32 else v, *a, **kw)
                finally:
                    self._drop = False
                return tf32_round(out) if tf32 else out
            return wrapped

        def scan(orig):
            def wrapped(cols, block, *a, **kw):
                for start, fused in orig(cols, block, *a, **kw):
                    if self._capture and start not in self.blocks:
                        self.blocks[start] = graphs.packbits(fused != 0)
                    if self._drop:
                        fused = fused.clone()
                        fused[block // 2:] = 0
                    yield start, fused
            return wrapped

        def labels(orig):
            def wrapped(ritz, n_clusters, *a, **kw):
                if self._pending:
                    self.n_clusters = torch.as_tensor(n_clusters).clone()
                    self._pending = False
                return orig(ritz, n_clusters, *a, **kw)
            return wrapped

        self._patch(bspec, "spectral_embedding_blocked", embedding)
        self._patch(bspec, "_degrees", degrees)
        self._patch(bspec, "_sym_matmul", sym_matmul)
        self._patch(bspec, "labels_from_ritz", labels)
        self._patch(ba, "scan_blocks", scan)
        return self

    def __exit__(self, *exc) -> None:
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()


def pipeline_config(c: dict, t: dict, seed: int, n_records: int, device):
    """The configuration of the cell's ``process_streaming_data`` calls,
    with the card's route also where it runs elsewhere."""
    from mused_tpu_torch.utils.config import PipelineConfig
    cfg = PipelineConfig(
        seed=seed, subset_size=n_records, noise_rate=c["noise_rate"],
        label_mode=c["label_mode"], sorting=False, window_size=c["window_size"],
        reduced_dim=c["n_clusters_cap"] + OVERSAMPLE, k_basis=c["k_basis"],
        step_window_ratio=c["step_window_ratio"], approach=t["approach"],
        n_clusters_override=c["n_clusters_cap"], k_estimate="eigengap",
        background_bucket=True)
    if device.type != "cuda":     # the binned route, which is the card's
        cfg = dataclasses.replace(cfg, huge_window_fused_select=True,
                                  force_blocked_window=True)
    return cfg


class Driver:
    def __init__(self, cell, seed: int, device, *, trace: bool, faults=(), overrides=None):
        self.cfg, self.traffic = common.merged(cell, overrides or {})
        self.seed, self.device, self.trace = seed, device, trace
        self.stap = SpectralTap(tuple(f for f in faults if f in FAULTS))
        self.tap = tap_mod.Tap({}, tuple(f for f in faults if f not in FAULTS))

    def setup(self) -> None:
        from mused_tpu_torch import api
        from mused_tpu_torch.engine.streaming import StreamingEngine
        from mused_tpu_torch.utils.profiling import SpanTimer
        c, t = self.cfg, self.traffic
        win, per = c["window_size"], t["windows_per_call"]
        self.mods, self.labels = crisis_synth.make_stream(
            t["pool_windows"] * win, n_events=c["n_events"], noise_rate=c["noise_rate"],
            d_text=c["text_dim"], d_image=c["image_dim"],
            noise_scale=c["embedding_noise_scale"], seed=self.seed)
        self.n_calls = t["pool_windows"] // per
        self.call_records = per * win
        self.pcfg = pipeline_config(c, t, self.seed, self.call_records, self.device)
        self.engine = StreamingEngine(self.pcfg, self.device)
        if self.trace:   # spans that cover the device work they issue
            self.engine.timer = SpanTimer(self.device, sync_all=True)
        self.api = api
        self.tap.__enter__()
        self.stap.__enter__()
        self._call(0)            # builds and warms every kernel of the path
        self.engine.timer.spans.clear()

    def _call(self, i: int) -> None:
        c, t = self.cfg, self.traffic
        lo = (i % self.n_calls) * self.call_records
        hi = lo + self.call_records
        self.api.process_streaming_data(
            self.api.get_initial_results()[0], common.slice_rows(self.mods, lo, hi),
            MODALITY_TYPES, c["window_size"], self.pcfg.reduced_dim, c["k_basis"],
            c["n_clusters_cap"], self.seed, t["approach"], self.labels[lo:hi],
            c["step_window_ratio"], c["noise_rate"], c["label_mode"], False, 1.5, 2,
            cfg=self.pcfg, engine=self.engine, device=self.device)

    def window(self, seconds: float) -> CrisisWindowRecord:
        c, t = self.cfg, self.traffic
        per = t["windows_per_call"]
        # the check's call: drawn from those that surely run (the first few)
        self.check_call = common.draw(self.seed, t["min_calls"], 1, 2)[0]
        self.check_window = self.check_call * per + common.draw(self.seed, per, 1, 3)[0]
        self.tap.keep["kmeans"] = {self.check_window}
        self.stap.keep = self.check_window
        self.tap.arm()
        self.stap.arm()
        calls, tracer, _ = common.closed_loop(self._call, seconds, t["min_calls"],
                                              self.trace)
        windows = calls * per
        rec = CrisisWindowRecord(
            window_s=tracer.window_s, attempted=windows, failed=0,
            end_to_end={"records_per_s": windows * c["window_size"] / tracer.window_s},
            windows=windows, spans={k: list(v) for k, v in self.engine.timer.spans.items()})
        if self.trace:
            rec.trace = trace_mod.summarize(tracer)
            rec.mma_plane_bound_s = mma_counts.plane_bound_s(
                c["block_rows"], c["window_size"], c["text_dim"], c["nbins"])
        return rec

    def release(self) -> None:
        self.stap.__exit__(None, None, None)
        self.tap.__exit__(None, None, None)
        self.engine = None

    def check(self) -> dict:
        c, t = self.cfg, self.traffic
        win, block, w = c["window_size"], c["block_rows"], self.check_window
        pos = w % t["pool_windows"]
        p = ref_spectral.EmbeddingPanels(
            common.slice_rows(self.mods, pos * win, (pos + 1) * win), self.device)
        prog, ref = ref_spectral.Graph(win, self.device), ref_spectral.Graph(win, self.device)
        diff = edges = 0
        for lo in range(0, win, block):
            mine = ref_spectral.fused_block(p, lo, lo + block, c["k_basis"], c["nbins"])
            ref.add(lo, mine)
            edges += int(mine.sum())
            theirs = self.stap.blocks.get(lo)
            if theirs is None:
                diff += int(mine.sum())
            else:
                diff += graphs.popcount(graphs.packbits(mine) ^ theirs)
                prog.add(lo, graphs.unpackbits(theirs))
            del mine
        del p
        live = int(self.stap.n_clusters)
        ritz, lam = self.stap.ritz[:win], self.stap.lam
        # the identity under the program's own graph, as svd_identity: the
        # few edges a reassociated product flips (graph_mismatch) would move
        # an event's Rayleigh quotient by about 1e-5 under the reference's
        identity = ref_spectral.ritz_identity(prog.operator(), ritz, lam, live)
        top = ref_spectral.top_eigenvalues(ref.operator(), live)
        # the NJW rows the labels were drawn from (blocked_spectral.labels_from_ritz)
        emb = ritz[:, :live]
        emb = emb / torch.clamp(torch.linalg.norm(emb, dim=1, keepdim=True), min=1e-12)
        return {"graph_mismatch": judge.graph_mismatch(diff, edges),
                "ritz_identity": identity,
                "ritz_energy_gap": ref_spectral.ritz_energy_gap(lam, top, live),
                "label_cost_excess": judge.label_cost_excess(
                    self.tap.labels[w].cpu().numpy(), emb)}
