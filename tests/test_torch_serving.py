"""The port's serving detector (``mused_tpu_torch/serving.StreamDetector``)
against the JAX package's (``cfg.windows_per_batch=1``: one window per
dispatch, as the port always does), on the CPU at window 64, k_basis 3,
reduced_dim 8:

  * the same windows fire at the same rows, in tumbling and sliding mode;
  * results do not depend on how the stream is chopped into pushes;
  * ``save`` / ``load`` mid-stream resumes to the uninterrupted labels;
  * the same errors for a label-derived count and for bad shapes;
  * a pushed buffer is copied; a failed dispatch poisons the detector;
  * with the JAX side's draws injected, NMI within 0.05 of the JAX detector;
  * the background bucket on the crisis stream fires and lifts NMI;
  * with ``windows_per_batch=4`` (groups of 4 windows, a partial group
    flushed window by window) the results equal per-window serving, do not
    depend on the pushes' sizes, resume after a save with a partly filled
    group, and a non-batchable approach is clamped to per-window dispatch;
  * the drain rule: a push that fires no window returns the windows whose
    device work has completed; windows that have not completed stay
    pending until the hard bound, past which a firing push pulls them
    oldest-first; the results equal a run that returns them only at
    ``flush``.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from mused_tpu.data.synthetic import crisis_embedding_stream as jcrisis
from mused_tpu.engine.streaming import window_triggers
from mused_tpu.serving import StreamDetector as JDetector
from mused_tpu.utils.config import PipelineConfig as JConfig
from mused_tpu_torch import api as tapi
from mused_tpu_torch import serving
from mused_tpu_torch.data import synthetic as tsyn
from mused_tpu_torch.serving import StreamDetector
from mused_tpu_torch.utils import metrics, profiling
from mused_tpu_torch.utils.config import PipelineConfig
from torch_parity import inject_jax_draws, synthetic_window_stream

W = 64
CFG = dict(window_size=W, reduced_dim=8, k_basis=3, label_mode="all",
           n_clusters_override=6, k_estimate="eigengap")


@pytest.fixture(scope="module")
def stream():
    return synthetic_window_stream(n_rows=800, subset=512, seed=0)


def _serve(det, mods, chunk, stop=None):
    out = []
    end = len(mods[0]) if stop is None else stop
    for lo in range(0, end, chunk):
        out.extend(det.push([m[lo:min(lo + chunk, end)] for m in mods]))
    return out


def port(mtypes, approach="sSVDMC", **kw):
    cfg = PipelineConfig(approach=approach, **{**CFG, **kw.pop("cfg", {})})
    return StreamDetector(mtypes, W, cfg=cfg, device="cpu", **kw)


def jax_detector(mtypes, approach="sSVDMC", **kw):
    cfg = JConfig(approach=approach, windows_per_batch=1, **{**CFG, **kw.pop("cfg", {})})
    return JDetector(mtypes, W, cfg=cfg, **kw)


def _all(det, mods, chunk):
    return _serve(det, mods, chunk) + det.flush()


@pytest.mark.parametrize("ratio", [1, 2])
def test_triggers_match_jax(stream, ratio):
    mods, mtypes, _ = stream
    got = _all(port(mtypes, cfg=dict(step_window_ratio=ratio)), mods, 48)
    want = _all(jax_detector(mtypes, cfg=dict(step_window_ratio=ratio)), mods, 48)
    assert [(r.window_index, r.row_start) for r in got] == \
        [(r.window_index, r.row_start) for r in want]
    assert [r.row_start + W - 1 for r in got] == window_triggers(512, W, ratio)
    seen: set = set()
    for r in got:
        assert r.counts.sum() + r.background == W and len(r.clusters) == W
        assert set(r.new_events.tolist()) == set(r.event_ids.tolist()) - seen
        seen |= set(r.event_ids.tolist())


def test_chunking_invariance(stream):
    """Also a stress run of the dispatch worker: one record per push with
    the interpreter switching threads every microsecond."""
    mods, mtypes, _ = stream
    runs = [_all(port(mtypes, "SWFDMC"), mods, chunk) for chunk in (512, 7)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runs.append(_all(port(mtypes, "SWFDMC"), mods, 1))
    finally:
        sys.setswitchinterval(interval)
    assert len(runs[0]) == 512 // W
    for other in runs[1:]:
        for x, y in zip(runs[0], other):
            assert (x.window_index, x.row_start) == (y.window_index, y.row_start)
            np.testing.assert_array_equal(x.clusters, y.clusters)


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC"])
def test_save_load_resume(stream, tmp_path, approach):
    mods, mtypes, _ = stream
    full = _all(port(mtypes, approach, background=False), mods, W)
    det = port(mtypes, approach)
    cut = 3 * W + 7
    out = _serve(det, mods, W, stop=cut)
    path = str(tmp_path / "det.npz")
    out.extend(det.save(path))
    det2 = StreamDetector.load(path, device="cpu")
    assert det2.cfg == det.cfg and det2._count == cut
    out.extend(_serve(det2, [m[cut:] for m in mods], W) + det2.flush())
    assert len(out) == len(full)
    for x, y in zip(out, full):
        assert (x.window_index, x.row_start) == (y.window_index, y.row_start)
        np.testing.assert_array_equal(x.clusters, y.clusters)
        np.testing.assert_array_equal(x.new_events, y.new_events)
    bogus = str(tmp_path / "stream_00000001.npz")
    from mused_tpu_torch.utils import checkpoint as ckpt
    ckpt.save_checkpoint(bogus, det.engine.state, {"next_window": 1})
    with pytest.raises(ValueError, match="not a StreamDetector"):
        StreamDetector.load(bogus, device="cpu")


def test_same_errors_as_jax(stream):
    mods, mtypes, _ = stream
    for make in (lambda **kw: StreamDetector(mtypes, W, device="cpu", **kw),
                 lambda **kw: JDetector(mtypes, W, **kw)):
        with pytest.raises(ValueError, match="unsupervised"):
            make(k_estimate="labels")
        det = make(max_events=8)
        with pytest.raises(ValueError, match="modality"):
            det.push([mods[0][:4]])
        with pytest.raises(ValueError, match="record count"):
            det.push([m[:3] for m in mods[:-1]] + [mods[-1][:2]])
        with pytest.raises(ValueError, match="0-d"):
            det.push([np.float32(1.0)] * len(mods))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamDetector(mtypes, W)              # the card is the default


def test_push_detaches_from_caller_buffer(stream):
    mods, mtypes, _ = stream
    det_a, det_b = port(mtypes, k_estimate="fixed"), port(mtypes, k_estimate="fixed")
    out_a, out_b = [], []
    bufs = [np.empty_like(m[:100]) for m in mods]
    for lo in range(0, 512, 100):
        hi = min(lo + 100, 512)
        chunk = [m[lo:hi] for m in mods]
        for b, c in zip(bufs, chunk):
            b[:hi - lo] = c
        out_a.extend(det_a.push([b[:hi - lo] for b in bufs]))
        for b in bufs:
            b[:] = -777.0 if b.dtype != object else "clobbered"
        out_b.extend(det_b.push([c.copy() for c in chunk]))
    out_a.extend(det_a.flush())
    out_b.extend(det_b.flush())
    assert len(out_a) == len(out_b) == 512 // W
    for x, y in zip(out_a, out_b):
        np.testing.assert_array_equal(x.clusters, y.clusters)


def test_a_failed_dispatch_poisons_the_detector(stream, monkeypatch, tmp_path):
    mods, mtypes, _ = stream
    det = port(mtypes)
    orig = det.engine.dispatch_window

    def fail_on_window_2(host, dev, types, labels, widx, prev):
        if widx == 2:
            raise FloatingPointError("device step failed")
        return orig(host, dev, types, labels, widx, prev)

    monkeypatch.setattr(det.engine, "dispatch_window", fail_on_window_2)
    with pytest.raises(RuntimeError, match="dispatch worker failed"):
        _serve(det, mods, W)
        det.flush()
    for call in (lambda: det.push([m[:W] for m in mods]), det.flush,
                 lambda: det.save(str(tmp_path / "x.npz"))):
        with pytest.raises(RuntimeError, match="restore from the last save"):
            call()
    assert not (tmp_path / "x.npz").exists()


def test_entry_readiness_and_huge_window_clamp(stream):
    mods, mtypes, _ = stream
    det = port(mtypes, max_lag=0)
    assert det._dispatch_ahead == 0 and det._worker is None
    det.push([m[:W] for m in mods])                  # synchronous: no worker
    assert det._worker is None
    entry = det._pending[0] if det._pending else None
    assert entry is None or serving._entry_ready(entry)
    huge = port(mtypes, "SWFDMC", cfg=dict(force_blocked_window=True))
    assert huge.max_lag == 0 and huge._dispatch_ahead == 0


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC"])
def test_nmi_matches_jax_with_draws_injected(stream, monkeypatch, approach):
    mods, mtypes, labels = stream
    want = np.concatenate([r.clusters for r in _all(jax_detector(mtypes, approach),
                                                    mods, 96)])
    inject_jax_draws(monkeypatch)
    got = np.concatenate([r.clusters for r in _all(port(mtypes, approach), mods, 96)])
    truth = np.asarray(labels)[:len(got)]
    assert abs(metrics.nmi(truth, got) - metrics.nmi(truth, want)) <= 0.05


def test_crisis_stream_is_the_jax_packages():
    got = tsyn.crisis_embedding_stream(n_rows=300, n_events=5, noise_rate=0.3,
                                       d_text=24, d_image=16, seed=4)
    want = jcrisis(n_rows=300, n_events=5, noise_rate=0.3, d_text=24, d_image=16, seed=4)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_background_bucket_on_the_crisis_stream():
    """BASELINE.md config #2 (embeddings + sSpectral, eigengap count) with
    the reference's positional matching: the bucket fires, lifts NMI by at
    least 0.05 and keeps the events-only NMI; the JAX detector's bucket
    fires on the same stream."""
    mods, mtypes, labels = tsyn.crisis_embedding_stream(
        n_rows=1024, n_events=4, noise_rate=0.3, d_text=64, d_image=64, seed=3)
    kw = dict(window_size=256, reduced_dim=16, k_basis=8, label_mode="all",
              n_clusters_override=12, k_estimate="eigengap")
    runs = {}
    for bg in (False, True):
        det = StreamDetector(mtypes, 256, cfg=PipelineConfig(
            approach="sSpectral", background_bucket=bg, **kw), device="cpu")
        runs[bg] = np.concatenate([r.clusters for r in _all(det, mods, 200)])
    truth = labels[:len(runs[True])]
    assert np.any(runs[True] == -1) and not np.any(runs[False] == -1)
    assert metrics.nmi(truth, runs[True]) > metrics.nmi(truth, runs[False]) + 0.05
    assert metrics.nmi_events_only(truth, runs[True]) >= \
        metrics.nmi_events_only(truth, runs[False]) - 0.05
    jdet = JDetector(mtypes, 256, cfg=JConfig(approach="sSpectral", background_bucket=True,
                                              windows_per_batch=1, **kw))
    want = np.concatenate([r.clusters for r in _all(jdet, mods, 200)])
    assert np.any(want == -1)
    assert abs(metrics.nmi(truth, runs[True]) - metrics.nmi(truth, want)) <= 0.1


def test_api_reexports_the_detector():
    assert tapi.StreamDetector is StreamDetector


def _equal_results(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert (x.window_index, x.row_start) == (y.window_index, y.row_start)
        np.testing.assert_array_equal(x.clusters, y.clusters)
        np.testing.assert_array_equal(x.new_events, y.new_events)


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC"])
def test_group_serving_equals_per_window_serving(stream, approach):
    """7 windows: one group of 4 dispatched, 3 buffered and flushed window
    by window, the state threading through both (tests/test_serving.py's
    scanned case)."""
    mods, mtypes, _ = stream
    rows = [m[:7 * W] for m in mods]
    per_window = _all(port(mtypes, approach), rows, 96)
    det = port(mtypes, approach, cfg=dict(windows_per_batch=4))
    assert det._batch_w == 4
    _equal_results(_all(det, rows, 96), per_window)


def test_group_serving_chunking_and_save_load_with_a_partial_group(stream, tmp_path):
    mods, mtypes, _ = stream
    group = dict(windows_per_batch=4)
    full = _all(port(mtypes, cfg=group), mods, 512)
    _equal_results(_all(port(mtypes, cfg=group), mods, 13), full)
    det = port(mtypes, cfg=group)
    cut = 5 * W + 7                    # one group dispatched, one window buffered
    out = _serve(det, mods, W, stop=cut)
    assert len(det._gbuf) == 1
    path = str(tmp_path / "det.npz")
    out.extend(det.save(path))
    det2 = StreamDetector.load(path, device="cpu")
    assert det2._batch_w == 4 and det2._count == cut
    out.extend(_serve(det2, [m[cut:] for m in mods], W) + det2.flush())
    _equal_results(out, full)


def test_group_serving_clamps_a_non_batchable_approach(stream):
    mods, mtypes, _ = stream
    det = port(mtypes, "DBSCAN_incr", cfg=dict(windows_per_batch=4, eps=1.5, min_samples=2))
    assert det._batch_w == 1
    got = _all(det, mods, 96)
    want = _all(port(mtypes, "DBSCAN_incr", cfg=dict(eps=1.5, min_samples=2)), mods, 96)
    assert any(len(np.unique(r.clusters)) > 1 for r in want)     # real labels
    _equal_results(got, want)


def _never_ready(entry):
    return False


def test_a_push_that_fires_nothing_returns_the_landed_windows(stream, monkeypatch):
    """Three windows land while none reports ready; once they are, the next
    push returns them though it fires no window.  The two finalized at or
    below ``max_lag`` pending count as early."""
    mods, mtypes, _ = stream
    det = port(mtypes, "SWFDMC")
    monkeypatch.setattr(serving, "_entry_ready", _never_ready)
    assert det.push([m[:3 * W] for m in mods]) == []
    monkeypatch.undo()
    det._worker.drain()
    assert len(det._pending) == 3
    with profiling.recording():
        profiling.clear()
        got = det.push([m[3 * W:3 * W + 5] for m in mods])
        early = [r for r in profiling.recorded() if r.name == "serving.finalized_early"]
    assert [r.window_index for r in got] == [0, 1, 2] and not det._pending
    assert [r.key for r in early] == [1, 2]
    want = _all(port(mtypes, "SWFDMC"), [m[:3 * W + 5] for m in mods], 3 * W)
    _equal_results(got, want)


def _push_held(det, rows):
    """Push with the dispatch worker held until the push returns, so the
    push sees only the windows that landed before it."""
    gate = threading.Event()
    det._submit(gate.wait)
    try:
        return det.push(rows)
    finally:
        gate.set()
        det._worker.drain()


@pytest.mark.parametrize("dispatch_ahead", [0, 2])
def test_windows_not_ready_wait_for_the_hard_bound(stream, monkeypatch, dispatch_ahead):
    """No window reports ready: pushes return nothing until more windows are
    pending than ``max_lag`` plus what the worker holds; past that, each
    firing push pulls the oldest, and a push that fires nothing never
    waits."""
    mods, mtypes, _ = stream
    monkeypatch.setattr(serving, "_entry_ready", _never_ready)
    det = port(mtypes, "SWFDMC", max_lag=2, dispatch_ahead=dispatch_ahead)
    if dispatch_ahead:
        # the worker appends a window after its fire's drain, so the depth
        # passes the bound by one before the next fire pulls
        push, cap = (lambda rows: _push_held(det, rows)), 2 + (dispatch_ahead + 1) + 1
    else:
        push, cap = det.push, 2
    got = []
    for k in range(8):
        lo = k * W
        assert push([m[lo:lo + W - 3] for m in mods]) == []
        assert len(det._pending) == min(k, cap)
        fired = push([m[lo + W - 3:lo + W] for m in mods])   # fires window k
        assert [r.window_index for r in fired] == ([k - cap] if k >= cap else [])
        got.extend(fired)
        assert len(det._pending) == min(k + 1, cap)
    monkeypatch.undo()
    got.extend(det.flush())
    _equal_results(got, _all(port(mtypes, "SWFDMC"), [m[:8 * W] for m in mods], W))


@pytest.mark.parametrize("chunk", [32, 48, 100])
def test_results_equal_a_run_that_returns_them_only_at_flush(stream, monkeypatch, chunk):
    mods, mtypes, _ = stream
    got = _all(port(mtypes, "SWFDMC"), mods, chunk)
    monkeypatch.setattr(serving, "_entry_ready", _never_ready)
    held = port(mtypes, "SWFDMC", max_lag=len(mods[0]))
    assert _serve(held, mods, chunk) == []
    want = held.flush()
    assert [r.window_index for r in want] == list(range(len(mods[0]) // W))
    _equal_results(got, want)
