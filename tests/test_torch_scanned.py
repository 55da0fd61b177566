"""The port's scanned multi-window dispatch (``windows_per_batch`` = W > 1):
``engine/streaming.resolve_windows_per_batch``, ``scanned_window_steps``,
``scanned_group_dispatch`` and the offline group loop, on the CPU at window
64, k_basis 3, reduced_dim 8 (mused_tpu's seeded stream, 4 windows):

  * W in {2, 3, 4} against W = 1: every window's labels and every metric
    bit-equal, for the six batchable approaches (W = 3 over 4 windows pads
    the tail group); ``swfd_R`` recorded from the first window;
  * the background bucket and centroid matching on a numeric stream under
    W > 1, equal to W = 1;
  * checkpoints land at full-group boundaries, and a run stopped after one
    group resumes to the uninterrupted run;
  * the resolver equals the JAX package's over a grid of approach, ratio,
    backend, stream length, checkpointing, verbose and explicit W;
  * port W = 4 against the JAX engine's W = 4 with the JAX draws injected:
    NMI and F1 within 0.05, the level of the per-window parity tests in
    ``test_torch_streaming.py``.
"""
import contextlib
import io
import itertools
import os

import numpy as np
import pytest

from mused_tpu import api as japi
from mused_tpu.engine import streaming as js
from mused_tpu.utils.config import PipelineConfig as JConfig
from mused_tpu_torch import api as tapi
from mused_tpu_torch.data import synthetic as tsyn
from mused_tpu_torch.engine import streaming as ts
from mused_tpu_torch.utils import checkpoint as ckpt
from mused_tpu_torch.utils.config import PipelineConfig
from torch_parity import inject_jax_draws, synthetic_window_stream

KW = dict(window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2, seed=0,
          step_window_ratio=1, noise_rate=0.5, label_mode="binary", sorting=True,
          eps=1.5, min_samples=2)
BATCHABLE = ("SWFDMC", "sSVDMC", "sSVDMC_hung", "sSVDMC_pot", "sSVDMC_mini", "sSpectral")
METRICS = ("nmi_score", "nmi_e_score", "f1_score", "f1_aligned", "precision", "recall",
           "accuracy", "mae")


@pytest.fixture(scope="module")
def stream():
    return synthetic_window_stream(seed=0)


def _run(mods, mtypes, labels, approach, monkeypatch=None, api=tapi, kw=KW, **extra):
    """(metrics, every window's matched labels concatenated) of one stream."""
    seen = {}
    if monkeypatch is not None:
        orig = ts.metrics_mod.compute_all_metrics

        def spy(*args):
            seen["clusters"] = np.array(args[8])
            return orig(*args)

        monkeypatch.setattr(ts.metrics_mod, "compute_all_metrics", spy)
    if api is tapi:
        extra.setdefault("device", "cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        res = api.process_streaming_data(
            results=api.get_initial_results()[0], data_modalities=mods,
            modality_types=mtypes, approach=approach, complete_true_labels=labels,
            **kw, **extra)
    return {k: res[k][0] for k in METRICS}, seen.get("clusters")


@pytest.fixture(scope="module")
def per_window(stream):
    """Each batchable approach at W = 1."""
    mods, mtypes, labels = stream
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for approach in BATCHABLE:
            out[approach] = _run(mods, mtypes, labels, approach, mp, windows_per_batch=1)
    return out


@pytest.mark.parametrize("w", [2, 3, 4])
@pytest.mark.parametrize("approach", BATCHABLE)
def test_groups_equal_per_window_dispatch(stream, per_window, monkeypatch, approach, w):
    mods, mtypes, labels = stream
    calls = []
    orig = ts.scanned_group_dispatch

    def spy(engine, feats, n_clusters, windows, **kw):
        calls.append(list(windows))
        return orig(engine, feats, n_clusters, windows, **kw)

    monkeypatch.setattr(ts, "scanned_group_dispatch", spy)
    got, clusters = _run(mods, mtypes, labels, approach, monkeypatch, windows_per_batch=w)
    want, want_clusters = per_window[approach]
    assert got == want
    np.testing.assert_array_equal(clusters, want_clusters)
    # 4 windows in groups of w, the tail padded with its last window
    groups = [list(range(4))[i:i + w] for i in range(0, 4, w)]
    assert calls == [g + g[-1:] * (w - len(g)) for g in groups]


def test_swfd_r_is_recorded_from_the_first_window(stream):
    mods, mtypes, labels = stream
    r = {}
    for w in (1, 2):
        cfg = PipelineConfig(window_size=64, reduced_dim=8, k_basis=3, approach="SWFDMC",
                             label_mode="binary", n_clusters_override=2, windows_per_batch=w)
        engine = ts.StreamingEngine(cfg, "cpu")
        _run(mods, mtypes, labels, "SWFDMC", cfg=cfg, engine=engine)
        r[w] = engine.swfd_R
    assert r[1] is not None and r[2] == r[1]


@pytest.fixture(scope="module")
def crisis():
    return tsyn.crisis_embedding_stream(n_rows=1024, n_events=4, noise_rate=0.3,
                                        d_text=48, d_image=48, seed=3)


def test_background_bucket_under_groups(crisis):
    """The detector with the background bucket and centroid matching, W = 4
    against W = 1 (tests/test_background.py's scanned case)."""
    from mused_tpu_torch.serving import StreamDetector
    mods, mtypes, _ = crisis
    out = {}
    for w in (1, 4):
        cfg = PipelineConfig(window_size=128, reduced_dim=16, k_basis=6, approach="sSpectral",
                             label_mode="all", n_clusters_override=8, matching="centroid",
                             k_estimate="eigengap", background_bucket=True,
                             windows_per_batch=w)
        det = StreamDetector(mtypes, 128, cfg=cfg, device="cpu")
        assert det._batch_w == w
        res = []
        for lo in range(0, 1024, 96):
            res.extend(det.push([m[lo:lo + 96] for m in mods]))
        res.extend(det.flush())
        out[w] = np.concatenate([r.clusters for r in sorted(res, key=lambda r: r.window_index)])
    assert np.any(out[1] == -1)
    np.testing.assert_array_equal(out[4], out[1])


def test_centroid_matching_under_groups(crisis, monkeypatch):
    """A numeric stream with matching="centroid" (tests/test_matching.py's
    scanned case): W = 3 equals W = 1."""
    mods, mtypes, labels = crisis
    kw = dict(KW, window_size=128, reduced_dim=16, k_basis=6, n_clusters_total=4,
              noise_rate=0.3, label_mode="all", sorting=False)
    out = {}
    for w in (1, 3):
        cfg = PipelineConfig(window_size=128, reduced_dim=16, k_basis=6, approach="sSpectral",
                             label_mode="all", n_clusters_override=4, matching="centroid",
                             windows_per_batch=w)
        out[w] = _run(mods, mtypes, labels, "sSpectral", monkeypatch, kw=kw, cfg=cfg)
    assert out[3][0] == out[1][0]
    np.testing.assert_array_equal(out[3][1], out[1][1])


class _Stop(Exception):
    pass


def test_checkpoints_land_at_group_boundaries(stream, tmp_path):
    """W = 4 over 4 windows, saving every window: one save, after the group."""
    mods, mtypes, labels = stream
    saved = []
    orig = ckpt.save_checkpoint

    def spy(path, *a, **k):
        saved.append(os.path.basename(path))
        return orig(path, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ckpt, "save_checkpoint", spy)
        _run(mods, mtypes, labels, "sSVDMC", windows_per_batch=4,
             checkpoint_dir=str(tmp_path))
        # W = 3: the full first group saves, the padded tail group does not
        _run(mods, mtypes, labels, "sSVDMC", windows_per_batch=3,
             checkpoint_dir=str(tmp_path / "three"))
    assert saved == [os.path.basename(ckpt.checkpoint_name(str(tmp_path), 4)),
                     os.path.basename(ckpt.checkpoint_name(str(tmp_path), 3))]


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC"])
def test_group_checkpoint_resumes_to_the_uninterrupted_run(stream, tmp_path, approach):
    """Stopped after one group of 2, resumed from its checkpoint: the
    metrics of the uninterrupted run (and of W = 1)."""
    mods, mtypes, labels = stream
    straight, _ = _run(mods, mtypes, labels, approach, windows_per_batch=2)
    calls = {"n": 0}
    orig = ts.scanned_group_dispatch

    def stop_after_one(*a, **k):
        if calls["n"] >= 1:
            raise _Stop()
        calls["n"] += 1
        return orig(*a, **k)

    ckdir = str(tmp_path / approach)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, "scanned_group_dispatch", stop_after_one)
        with pytest.raises(_Stop):
            _run(mods, mtypes, labels, approach, windows_per_batch=2, checkpoint_dir=ckdir)
    assert ckpt.latest_checkpoint(ckdir) == ckpt.checkpoint_name(ckdir, 2)
    resumed, _ = _run(mods, mtypes, labels, approach, windows_per_batch=2,
                      checkpoint_dir=ckdir)
    per_window, _ = _run(mods, mtypes, labels, approach, windows_per_batch=1)
    assert resumed == straight == per_window


GRID_APPROACHES = ("SWFDMC", "sSVDMC_pot", "sSpectral", "DBSCAN_incr", "DBSCAN_centr",
                   "SVDMC_batch")


@pytest.mark.parametrize("explicit", [None, 1, 4, 8])
@pytest.mark.parametrize("approach", GRID_APPROACHES)
def test_resolver_equals_jax(approach, explicit):
    """approach x ratio x backend x n_windows x checkpointing x verbose x
    huge / centroid-on-standard, for one explicit W (None = auto)."""
    cases = 0
    for ratio, backend, n_windows, ck, verbose, window, extra, standard in itertools.product(
            (1, 2), ("tpu", "cpu", "cuda"), (None, 7, 8, 9, 12, 13, 16), (None, "/ck"),
            (False, True), (64, 2000, 40_000), ({}, {"force_blocked_window": True},
                                                {"matching": "centroid"}),
            (False, True)):
        kw = dict(approach=approach, window_size=window, step_window_ratio=ratio,
                  verbose=verbose, windows_per_batch=explicit, **extra)
        args = dict(standard_types=standard, checkpoint_dir=ck, backend=backend,
                    n_windows=n_windows)
        got = ts.resolve_windows_per_batch(PipelineConfig(**kw), **args)
        want = js.resolve_windows_per_batch(JConfig(**kw), **args)
        assert got == want, (kw, args)
        # the engine-argument ratio overrides the config's
        assert ts.resolve_windows_per_batch(PipelineConfig(**kw), step_window_ratio=2,
                                            **args) == \
            js.resolve_windows_per_batch(JConfig(**kw), step_window_ratio=2, **args)
        cases += 1
    assert cases == 2 * 3 * 7 * 2 * 2 * 3 * 3 * 2


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC"])
def test_groups_match_the_jax_groups_with_its_draws(stream, monkeypatch, approach):
    mods, mtypes, labels = stream
    want, _ = _run(mods, mtypes, labels, approach, api=japi, windows_per_batch=4)
    inject_jax_draws(monkeypatch)
    got, _ = _run(mods, mtypes, labels, approach, windows_per_batch=4)
    assert abs(got["nmi_score"] - want["nmi_score"]) <= 0.05
    assert abs(got["f1_score"] - want["f1_score"]) <= 0.05


def test_stacked_group_pads_token_widths():
    a = (np.zeros((3, 2), np.float32), np.array([[1, -1]], np.int16),
         np.array([[2, 0]], np.uint8))
    b = (np.ones((3, 2), np.float32), np.array([[4, 5, 6]], np.int16),
         np.array([[1, 1, 1]], np.uint8))
    got = ts.stack_window_features([a, b])
    want = js.stack_window_features([a, b])
    assert [g.shape for g in got] == [(2, 3, 2), (2, 1, 3), (2, 1, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ts.scanned_types_for(ts.STANDARD_TYPES, PipelineConfig().features) == \
        ("standard_sparse",)
    assert ts.scanned_types_for(["embedding"], PipelineConfig().features) == ("embedding",)
