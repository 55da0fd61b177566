"""The port's streaming slice vs ``mused_tpu.api.process_streaming_data``.

On mused_tpu's own seeded synthetic stream at window 64, k_basis 3 and
reduced_dim 8:
  * every window's fused adjacency on the plain path is bit-equal to the
    JAX engine's; on the kernel entry point (whose wrapper takes its plain
    version for CPU tensors) it is within 0.2% of entries of the JAX Pallas
    fusion, because unit-xyz location coordinates differ by an ulp between
    the frameworks (see the test);
  * with the JAX side's random draws injected (FD probe, SVD test matrix,
    k-means++ init), the stream's NMI is within 0.05 of the JAX package's,
    for SWFDMC and sSVDMC;
  * on the huge-window blocked path (forced at window 512, binned
    candidates), with the same draws injected, NMI is within 0.02 of the JAX
    engine for SWFDMC (candidate-native fold) and sSVDMC (blocked SVD).
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mused_tpu import api as japi
from mused_tpu.data import features as jfeat
from mused_tpu.engine import streaming as js
from mused_tpu.utils.config import PipelineConfig
from mused_tpu_torch import api as tapi
from mused_tpu_torch.data import synthetic as tsyn
from mused_tpu_torch.data.ingest import WindowPrefetcher, to_device
from mused_tpu_torch.engine import streaming as ts
from mused_tpu_torch.ops.kernels import affinity_kernel as ak
from mused_tpu_torch.ops.kernels import blocked_select as tbs
from mused_tpu_torch.ops.kernels import cand_matvec as tcm
from mused_tpu_torch.utils.profiling import SpanTimer
from torch_parity import as_features_of, inject_jax_draws, n, synthetic_window_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2, seed=0,
          step_window_ratio=1, noise_rate=0.5, label_mode="binary", sorting=True,
          eps=1.5, min_samples=2)


@pytest.fixture(scope="module")
def stream():
    return synthetic_window_stream(seed=0)


def _run(api, mods, mtypes, labels, approach, **extra):
    with contextlib.redirect_stdout(io.StringIO()):
        return api.process_streaming_data(
            results=api.get_initial_results()[0], data_modalities=mods,
            modality_types=mtypes, approach=approach, complete_true_labels=labels,
            **KW, **extra)


def test_window_triggers_match_jax():
    for args in [(256, 64, 1), (300, 64, 2), (50, 64, 1), (130, 32, 4)]:
        assert ts.window_triggers(*args) == js.window_triggers(*args)


def test_fused_adjacency_bit_equal_per_window(stream):
    mods, mtypes, _ = stream
    cfg = PipelineConfig(window_size=64, k_basis=3, reduced_dim=8)
    jeng = js.StreamingEngine(cfg)
    teng = ts.StreamingEngine(cfg, "cpu")
    for w in range(len(mods[0]) // 64):
        window = [m[64 * w:64 * (w + 1)] for m in mods]
        host = teng.featurize(window, mtypes)
        dev = to_device(host, torch.device("cpu"))
        want_plain = n(jeng.fuse_from_features(as_features_of(host, jfeat), mtypes))
        want_kernel = n(js._fuse_dispatch(tuple(host), types=("standard_sparse",),
                                          use_pallas=True, k_basis=3, tags_dim=2048,
                                          text_dim=4096))
        np.testing.assert_array_equal(n(teng.fuse_from_features(host, dev, mtypes)),
                                      want_plain)
        # kernel path: location ranks by chord3 on unit xyz, and torch's and
        # XLA's sin/cos differ in the last ulp (49 of 600 coordinates on a
        # 200-row draw), which can flip a near-tie; on window 0 it flips one
        # entry.  Held to test_pallas_affinity's fusion bar: <= 0.2% of
        # entries, row degrees within 2.  Fed the same xyz, chord3 is
        # bit-equal (test_torch_affinity).
        got = n(teng.fuse_from_features(host, dev, mtypes, use_kernel=True))
        assert (got != want_kernel).mean() <= 0.002, (got != want_kernel).sum()
        np.testing.assert_allclose(got.sum(1), want_kernel.sum(1), atol=2)


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC"])
def test_slice_nmi_matches_jax(approach, stream, monkeypatch):
    mods, mtypes, labels = stream
    want = _run(japi, mods, mtypes, labels, approach)
    inject_jax_draws(monkeypatch)
    got = _run(tapi, mods, mtypes, labels, approach, device="cpu")
    assert abs(got["nmi_score"][0] - want["nmi_score"][0]) <= 0.05
    assert abs(got["f1_score"][0] - want["f1_score"][0]) <= 0.05


@pytest.mark.parametrize("approach", ["sSVDMC_hung", "sSVDMC_pot", "sSVDMC_mini"])
def test_other_slice_approaches_run(approach, stream):
    mods, mtypes, labels = stream
    cfg = PipelineConfig(window_size=64, k_basis=3, reduced_dim=8, approach=approach,
                         n_clusters_override=2, use_pallas_affinity=True)
    res = _run(tapi, mods, mtypes, labels, approach, device="cpu", cfg=cfg)
    vals = [res[k][0] for k in ("nmi_score", "f1_score", "f1_aligned")]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals)


HUGE = dict(window_size=512, reduced_dim=8, k_basis=3, n_clusters_total=2, seed=0,
            step_window_ratio=1, noise_rate=0.5, label_mode="binary", sorting=True,
            eps=1.5, min_samples=2)


@pytest.fixture(scope="module")
def huge_stream():
    return synthetic_window_stream(n_rows=1200, subset=1024, seed=0)


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC"])
def test_huge_window_nmi_matches_jax(approach, huge_stream, monkeypatch):
    mods, mtypes, labels = huge_stream
    cfg = PipelineConfig(window_size=512, k_basis=3, reduced_dim=8, approach=approach,
                         n_clusters_override=2, subset_size=1024, seed=0,
                         force_blocked_window=True, huge_window_fused_select=True,
                         huge_window_cand_fold=True if approach == "SWFDMC" else None)
    runs = {}
    for name, api, extra in (("jax", japi, {}), ("port", tapi, {"device": "cpu"})):
        if name == "port":
            inject_jax_draws(monkeypatch)
        with contextlib.redirect_stdout(io.StringIO()):
            runs[name] = api.process_streaming_data(
                results=api.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, approach=approach, complete_true_labels=labels,
                cfg=cfg, **HUGE, **extra)
    launches = (tbs.launches, tbs.pair_launches, tcm.launches_t, tcm.launches)
    for key in ("nmi_score", "f1_score"):
        assert abs(runs["port"][key][0] - runs["jax"][key][0]) <= 0.02
    assert launches == (tbs.launches, tbs.pair_launches, tcm.launches_t, tcm.launches)


def _generic_stream(rows=1024, seed=0):
    """Numeric modalities with 4 planted clusters: location, time, a 40-wide
    embedding and a 7-wide default panel (some rows invalid in each)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, rows)
    centre = rng.normal(size=(4, 40)) * 3
    emb = centre[labels] + rng.normal(size=(rows, 40))
    loc = np.stack([40 + labels + rng.normal(0, 0.3, rows),
                    2 + labels + rng.normal(0, 0.3, rows)], 1)
    tim = np.stack([1e4 * labels + rng.normal(0, 900, rows) + 1e5,
                    1e4 * labels + rng.normal(0, 900, rows) + 1e5], 1)
    dft = centre[labels, :7] + rng.normal(size=(rows, 7))
    loc[::17] = np.nan
    tim[::23, 0] = 0.0
    dft[::29, 3] = np.inf
    return [loc, tim, emb, dft], ["location", "time", "embedding", "default"], labels


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC"])
def test_huge_window_generic_stream_matches_jax(approach, monkeypatch):
    mods, mtypes, labels = _generic_stream()
    cfg = PipelineConfig(window_size=512, k_basis=3, reduced_dim=8, approach=approach,
                         n_clusters_override=4, subset_size=1024, seed=0,
                         force_blocked_window=True, huge_window_fused_select=True,
                         huge_window_cand_fold=True if approach == "SWFDMC" else None)
    kw = dict(HUGE, n_clusters_total=4, label_mode="all")
    runs = {}
    for name, api, extra in (("jax", japi, {}), ("port", tapi, {"device": "cpu"})):
        if name == "port":
            inject_jax_draws(monkeypatch)
        with contextlib.redirect_stdout(io.StringIO()):
            runs[name] = api.process_streaming_data(
                results=api.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, approach=approach, complete_true_labels=labels,
                cfg=cfg, **kw, **extra)
    for key in ("nmi_score", "f1_score"):
        assert abs(runs["port"][key][0] - runs["jax"][key][0]) <= 0.02


def test_huge_window_minibatch_runs(huge_stream):
    mods, mtypes, labels = huge_stream
    cfg = PipelineConfig(window_size=512, k_basis=3, reduced_dim=8, approach="sSVDMC_mini",
                         n_clusters_override=2, subset_size=1024, seed=0,
                         force_blocked_window=True, huge_window_fused_select=True)
    with contextlib.redirect_stdout(io.StringIO()):
        res = tapi.process_streaming_data(
            results=tapi.get_initial_results()[0], data_modalities=mods,
            modality_types=mtypes, approach="sSVDMC_mini", complete_true_labels=labels,
            cfg=cfg, device="cpu", **HUGE)
    vals = [res[k][0] for k in ("nmi_score", "f1_score", "f1_aligned")]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals)


def test_huge_window_engine_layout():
    eng = ts.StreamingEngine(PipelineConfig(window_size=40_000, approach="SWFDMC"), "cpu")
    assert eng.huge and (eng.block, eng.pad) == (2048, 960)
    assert eng.state.swfd.blocks.shape[-1] == 1          # no ring for the huge fold
    dense = ts.StreamingEngine(PipelineConfig(window_size=3000), "cpu")
    assert not dense.huge and dense.pad == 0
    mods, mtypes, _ = tsyn.make_stream(300, noise_rate=0.5, seed=1)
    small = ts.StreamingEngine(PipelineConfig(window_size=300, force_blocked_window=True),
                               "cpu")
    assert small.featurize(mods, mtypes).location.shape == (300, 2)
    eng.pad = 20
    assert eng.featurize(mods, mtypes).location.shape == (320, 2)


def test_engine_refuses_what_the_slice_does_not_run():
    cfg = PipelineConfig(window_size=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ts.StreamingEngine(cfg, "cuda")
    for bad in [dict(approach="sSpectral"), dict(approach="DBSCAN_incr"),
                dict(window_size=40_000, approach="sSpectral"),
                dict(force_blocked_window=True, approach="DBSCAN_centr"),
                dict(force_blocked_window=True, huge_window_layout="columns"),
                dict(data_shards=2), dict(matching="centroid"),
                dict(background_bucket=True), dict(windows_per_batch=4)]:
        with pytest.raises(NotImplementedError):
            ts.StreamingEngine(cfg.replace(**bad), "cpu")
    with pytest.raises(NotImplementedError, match="slice 2"):
        tapi.process_streaming_data(None, [np.zeros((64, 2))] * 5, ts.STANDARD_TYPES,
                                    device="cpu", checkpoint_dir="ckpt", **KW,
                                    approach="sSVDMC", complete_true_labels=np.zeros(64))
    with pytest.raises(ValueError):
        ts.StreamingEngine(cfg.replace(k_estimate="guess"), "cpu")


def test_window_generator_rule():
    assert ts.window_seed(3, 5) == 3 * 2**32 + 5
    a = torch.randn(4, generator=ts.window_generator(0, 1, "cpu"))
    b = torch.randn(4, generator=ts.window_generator(0, 1, "cpu"))
    c = torch.randn(4, generator=ts.window_generator(0, 2, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_numpy_synthetic_stream_layout_matches_prepare_modalities(stream):
    jmods, jtypes, jlabels = stream
    mods, types, labels = tsyn.make_stream(256, n_events=4, noise_rate=0.5, seed=0)
    assert types == jtypes
    for got, want in zip(mods, jmods):
        assert got.shape[1:] == want.shape[1:] and got.dtype == want.dtype
    assert labels.dtype == jlabels.dtype and len(labels) == 256
    assert labels.sum() == int(256 * 0.5)
    assert np.all(np.diff(mods[1][:, 1]) >= 0)               # sorted by upload time
    assert isinstance(mods[3][0, 0], list) and isinstance(mods[2][0, 0], str)


def test_prefetcher_yields_windows_in_order_as_tensors():
    feats = [(np.full((3, 2), i, np.float32), np.arange(3, dtype=np.int16))
             for i in range(5)]
    pf = WindowPrefetcher(lambda i: feats[i], 5, "cpu", depth=2)
    try:
        got = [(h, d) for h, d in pf]
    finally:
        pf.close()
    assert [int(d[0][0, 0]) for _, d in got] == list(range(5))
    assert got[2][1][1].dtype == torch.int16


def test_span_timer_records_spans():
    timer = SpanTimer("cpu")
    for _ in range(3):
        with timer.span("fuse"):
            pass
    assert timer.summary()["fuse"]["count"] == 3


def test_neither_jax_nor_pandas_is_imported():
    """Nor the JAX package itself: the port keeps its own host tier."""
    code = ("import sys; sys.path.insert(0, %r); import mused_tpu_torch.api; "
            "import chip_smoke; import mused_tpu_torch.utils.convert; "
            "import mused_tpu_torch.data.synthetic; "
            "import mused_tpu_torch.ops.blocked_affinity; "
            "import mused_tpu_torch.ops.kernels.blocked_select; "
            "import mused_tpu_torch.ops.kernels.cand_matvec; "
            "import mused_tpu_torch.ops.matching; import mused_tpu_torch.utils.metrics; "
            "import mused_tpu_torch.data.features; import mused_tpu_torch.native; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'pandas', 'mused_tpu')])"
            % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA" in out.stderr


def test_launch_counter_untouched_by_cpu_runs(stream):
    mods, mtypes, labels = stream
    before = ak.launches
    cfg = PipelineConfig(window_size=64, k_basis=3, reduced_dim=8, approach="sSVDMC",
                         n_clusters_override=2, use_pallas_affinity=True)
    _run(tapi, mods, mtypes, labels, "sSVDMC", device="cpu", cfg=cfg)
    assert ak.launches == before
    json.dumps({"launches": ak.launches})
