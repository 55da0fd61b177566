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
  * sSpectral and the DBSCAN family likewise (NMI / F1 within 0.05), an
    unknown approach name runs the SVD and k-means as in the reference, the
    reference's keywords are all accepted, and the reference's R is
    recorded (ROADMAP Queue 3 #2-#4);
  * a stream started in the JAX package continues in the port with the
    JAX run's labels;
  * on the huge-window blocked path (forced at window 512, binned
    candidates), with the same draws injected, NMI is within 0.02 of the JAX
    engine for SWFDMC (candidate-native fold) and sSVDMC (blocked SVD), and
    every metric equals the JAX engine's for sSpectral (blocked spectral)
    and DBSCAN_centr (blocked SVD + blocked DBSCAN).
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


@pytest.mark.parametrize("approach", ["sSpectral", "DBSCAN_centr"])
def test_huge_window_spectral_and_dbscan_centr_match_jax(approach, huge_stream,
                                                         monkeypatch):
    """sSpectral (blocked spectral on the columns, no SVD; the eigengap count
    from the Ritz values) and DBSCAN_centr (blocked SVD, blocked DBSCAN, its
    own centroid matching) on the huge path, with the JAX side's draws
    injected (the blocked SVD's test matrix, blocked spectral's probe, the
    k-means++ init): every metric equal to the JAX engine's."""
    mods, mtypes, labels = huge_stream
    runs = {}
    for name, api, extra in (("jax", japi, {}), ("port", tapi, {"device": "cpu"})):
        cfg = PipelineConfig(window_size=512, k_basis=3, reduced_dim=8, approach=approach,
                             n_clusters_override=2, subset_size=1024, seed=0, eps=1.5,
                             min_samples=2, force_blocked_window=True,
                             huge_window_fused_select=True,
                             k_estimate="eigengap" if approach == "sSpectral" else "labels")
        if name == "port":
            inject_jax_draws(monkeypatch)
        with contextlib.redirect_stdout(io.StringIO()):
            runs[name] = api.process_streaming_data(
                results=api.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, approach=approach, complete_true_labels=labels,
                cfg=cfg, **HUGE, **extra)
    for key in ("nmi_score", "nmi_e_score", "f1_score", "f1_aligned"):
        assert runs["port"][key] == runs["jax"][key], key


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


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC"])
def test_huge_window_background_bucket(approach, monkeypatch):
    """The huge path's k-means branch applies the background bucket to the
    window's reduction (mused_tpu/engine/streaming.py:850-852); the
    mini-batch approach takes none."""
    mods, mtypes, _ = tsyn.crisis_embedding_stream(n_rows=256, n_events=4,
                                                   noise_rate=0.3, d_text=16,
                                                   d_image=16, seed=3)
    calls = []
    orig = ts.kmeans.mark_background

    def spy(x, labels, *, k_max):
        calls.append((tuple(x.shape), k_max))
        return orig(x, labels, k_max=k_max)

    monkeypatch.setattr(ts.kmeans, "mark_background", spy)
    for name, want in ((approach, [((256, 8), 12)]), ("sSVDMC_mini", [])):
        calls.clear()
        cfg = PipelineConfig(window_size=256, reduced_dim=8, k_basis=4, approach=name,
                             label_mode="all", n_clusters_override=12,
                             k_estimate="eigengap", background_bucket=True,
                             force_blocked_window=True)
        eng = ts.StreamingEngine(cfg, "cpu")
        host = eng.featurize(mods, mtypes)
        clusters = eng.process_window(host, to_device(host, eng.device), mtypes,
                                      np.zeros(256), 0, None)
        assert len(clusters) == 256 and calls == want, name


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
    # the scanned multi-window dispatch runs since it was ported
    assert ts.StreamingEngine(cfg.replace(windows_per_batch=4), "cpu").cfg.windows_per_batch == 4
    # the row-sharded layout runs since slice 4b, over a process group
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        ts.StreamingEngine(cfg.replace(data_shards=2), "cpu")
    # centroid matching runs since slice 2f, on numeric streams and dense
    # windows; elsewhere the JAX engine's ValueErrors, with their messages
    assert ts.StreamingEngine(cfg.replace(matching="centroid"), "cpu").centroid_matcher
    for package, device in ((js, ()), (ts, ("cpu",))):
        with pytest.raises(ValueError, match="matching='centroid' runs on the dense-window"):
            package.StreamingEngine(cfg.replace(matching="centroid",
                                                force_blocked_window=True), *device)
    for api, device in ((japi, {}), (tapi, {"device": "cpu"})):
        with pytest.raises(ValueError, match="supports numeric-modality streams"):
            api.process_streaming_data(None, [np.zeros((64, 2))] * 5, ts.STANDARD_TYPES,
                                       **KW, **device, approach="sSVDMC",
                                       complete_true_labels=np.zeros(64),
                                       matching="centroid")
    # the column-sharded layouts run since slice 4a; on one device they are
    # the JAX engine's ValueError (tests/test_torch_colsharded_engine.py)
    with pytest.raises(ValueError, match="data_shards > 1"):
        ts.StreamingEngine(cfg.replace(force_blocked_window=True,
                                       huge_window_layout="columns"), "cpu")
    # the reference's own refusal (mused_tpu/engine/streaming.py:563-568)
    with pytest.raises(ValueError, match="DBSCAN_incr"):
        ts.StreamingEngine(cfg.replace(force_blocked_window=True, approach="DBSCAN_incr"),
                           "cpu")
    for kw, exc in [(dict(merge_topology="ring", data_shards=2), ValueError),
                    (dict(data_shards=2), ValueError),
                    (dict(huge_window_layout="grid"), ValueError)]:
        with pytest.raises(exc, match="process group of 2 ranks|data_shards > 1"):
            tapi.process_streaming_data(None, [np.zeros((64, 2))] * 5, ts.STANDARD_TYPES,
                                        device="cpu", **KW, approach="sSVDMC",
                                        complete_true_labels=np.zeros(64), **kw)
    with pytest.raises(ValueError):
        ts.StreamingEngine(cfg.replace(k_estimate="guess"), "cpu")


@pytest.mark.parametrize("approach", ["sSpectral", "DBSCAN_incr", "DBSCAN_centr"])
def test_dense_approaches_of_slice_2_match_jax(approach, stream, monkeypatch):
    """sSpectral (spectral clustering of the fused graph) and the DBSCAN
    family (on the SVD-reduced window) with the JAX side's draws injected:
    NMI and F1 within 0.05 of the JAX package.  DBSCAN_incr clusters rows of
    every window together, so it also takes the JAX SVD's column signs."""
    mods, mtypes, labels = stream
    want = _run(japi, mods, mtypes, labels, approach)
    inject_jax_draws(monkeypatch, svd_signs=approach == "DBSCAN_incr")
    got = _run(tapi, mods, mtypes, labels, approach, device="cpu")
    assert abs(got["nmi_score"][0] - want["nmi_score"][0]) <= 0.05
    assert abs(got["f1_score"][0] - want["f1_score"][0]) <= 0.05


def test_unknown_approach_runs_svd_and_kmeans(stream, monkeypatch):
    """ROADMAP Queue 3 #2: the reference validates no approach name; an
    unknown one (a *_batch name included) runs the SVD and k-means with
    Hungarian matching, exactly as sSVDMC does."""
    mods, mtypes, labels = stream
    inject_jax_draws(monkeypatch)
    ref = _run(tapi, mods, mtypes, labels, "sSVDMC", device="cpu")
    for name in ("no_such_approach", "SVDMC_batch"):
        got = _run(tapi, mods, mtypes, labels, name, device="cpu")
        for key in ("nmi_score", "f1_score", "f1_aligned"):
            assert got[key][0] == ref[key][0], (name, key)
    want = _run(japi, mods, mtypes, labels, "no_such_approach")
    assert abs(got["nmi_score"][0] - want["nmi_score"][0]) <= 0.05


def test_process_streaming_data_takes_every_reference_keyword(stream, monkeypatch):
    """ROADMAP Queue 3 #3: every keyword of the JAX package's signature is
    accepted; the ported ones pass through to the config."""
    mods, mtypes, labels = stream
    kw = dict(checkpoint_every=2, data_shards=1, merge_topology="allgather",
              verbose=False, matching="auto", windows_per_batch=None,
              k_estimate="eigengap", eigengap_theta=0.2, background_bucket=True,
              huge_window_layout="rows", huge_window_col_shards=0,
              huge_window_cand_fold=False)
    res = _run(tapi, mods, mtypes, labels, "sSVDMC", device="cpu", **kw)
    assert np.isfinite(res["nmi_score"][0])
    captured = {}
    orig = ts.StreamingEngine.__init__

    def spy(self, cfg, device="cuda"):
        captured["cfg"] = cfg
        orig(self, cfg, device)

    monkeypatch.setattr(ts.StreamingEngine, "__init__", spy)
    _run(tapi, mods, mtypes, labels, "sSVDMC", device="cpu", **kw)
    cfg = captured["cfg"]
    assert (cfg.k_estimate, cfg.eigengap_theta, cfg.background_bucket,
            cfg.huge_window_cand_fold, cfg.verbose) == ("eigengap", 0.2, True, False, False)


def test_verbose_prints_the_reference_oracles(stream):
    """``verbose`` at a small window prints the reference's debug oracles
    (reference main.py:35-37, 51-53, 99-112) in the JAX package's order and
    format, the fused adjacency's sum included, and changes no result."""
    mods, mtypes, labels = stream

    def printed(api, **extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = api.process_streaming_data(
                results=api.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, approach="sSVDMC", complete_true_labels=labels,
                verbose=True, **KW, **extra)
        heads = [ln.split(":")[0] for ln in out.getvalue().splitlines()
                 if ln.startswith("[window")]
        return heads, res

    got, res = printed(tapi, device="cpu")
    want, _ = printed(japi)
    assert got == want and len(got) == 4 * 4
    assert "[window 0] fused adjacency (sum=" in got[1]
    quiet = _run(tapi, mods, mtypes, labels, "sSVDMC", device="cpu")
    assert res["nmi_score"][0] == quiet["nmi_score"][0]


def test_swfd_r_is_recorded_like_the_reference(stream):
    """ROADMAP Queue 3 #4: the first window's largest squared row norm of the
    fused matrix (reference main.py:61), equal to the JAX engine's and kept
    in the host snapshot."""
    mods, mtypes, labels = stream
    cfg = PipelineConfig(window_size=64, k_basis=3, reduced_dim=8, approach="SWFDMC",
                         n_clusters_override=2)
    jeng = js.StreamingEngine(cfg)
    jeng.process_window([m[:64] for m in mods], mtypes, labels[:64], 0, None)
    engine = ts.StreamingEngine(cfg, "cpu")
    _run(tapi, mods, mtypes, labels, "SWFDMC", device="cpu", cfg=cfg, engine=engine)
    assert engine.swfd_R is not None and engine.swfd_R == jeng.swfd_R
    assert engine.host_snapshot()["swfd_R"] == jeng.swfd_R


def test_jax_engine_state_continues_in_the_port(stream, monkeypatch):
    """A stream run 2 windows in the JAX package and continued in the port
    (``convert.engine_state_from_jax``) gives, on its remaining windows, the
    JAX run's continued labels, with the JAX draws injected."""
    import jax
    from mused_tpu_torch.utils import convert
    mods, mtypes, labels = stream
    cfg = PipelineConfig(window_size=64, k_basis=3, reduced_dim=8, approach="SWFDMC",
                         n_clusters_override=2, k_estimate="fixed")
    jeng = js.StreamingEngine(cfg)

    def window(w):
        return [m[64 * w:64 * (w + 1)] for m in mods], labels[64 * w:64 * (w + 1)]

    prev = None
    for w in range(2):
        rows, truth = window(w)
        prev = jeng.process_window(rows, mtypes, truth, w, prev)
    state_np = jax.tree_util.tree_map(np.asarray, jeng.state)
    host, prev_at_2 = jeng.host_snapshot(), prev
    want = []
    for w in range(2, 4):
        rows, truth = window(w)
        prev = jeng.process_window(rows, mtypes, truth, w, prev)
        want.append(prev)

    inject_jax_draws(monkeypatch)
    teng = ts.StreamingEngine(cfg, "cpu")
    teng.restore(*convert.engine_state_from_jax(state_np, host, "cpu"))
    assert teng.state.swfd.count == 128 and teng.swfd_R == jeng.swfd_R
    prev = prev_at_2
    for w, expected in zip(range(2, 4), want):
        rows, truth = window(w)
        feats = teng.featurize(rows, mtypes)
        prev = teng.process_window(feats, to_device(feats, teng.device), mtypes, truth,
                                   w, prev)
        np.testing.assert_array_equal(prev, expected)


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
    """Nor the JAX package itself: the port keeps its own host tier.  The
    driver surface (``main``, ``data/sed2012``, ``utils/output``,
    ``utils/tee``) imports with matplotlib absent, as on the card's machine
    (its plots are skipped)."""
    code = ("import sys; sys.modules['matplotlib'] = None; "    # as on the card's machine
            "sys.path.insert(0, %r); import mused_tpu_torch.api; "
            "import chip_smoke; import mused_tpu_torch.utils.convert; "
            "import mused_tpu_torch.data.synthetic; "
            "import mused_tpu_torch.ops.blocked_affinity; "
            "import mused_tpu_torch.ops.kernels.blocked_select; "
            "import mused_tpu_torch.ops.kernels.cand_matvec; "
            "import mused_tpu_torch.ops.matching; import mused_tpu_torch.utils.metrics; "
            "import mused_tpu_torch.data.features; import mused_tpu_torch.native; "
            "import mused_tpu_torch.serving; import mused_tpu_torch.ops.spectral; "
            "import mused_tpu_torch.ops.dbscan; import mused_tpu_torch.utils.checkpoint; "
            "import mused_tpu_torch.engine.batch; import mused_tpu_torch.ops.blocked_spectral; "
            "import mused_tpu_torch.ops.blocked_dbscan; "
            "import mused_tpu_torch.ops.blocked_hdbscan; "
            "import mused_tpu_torch.parallel.mesh; import mused_tpu_torch.parallel.colsharded; "
            "import mused_tpu_torch.parallel.sharded; import mused_tpu_torch.parallel.sweep; "
            "import mused_tpu_torch.parallel.sketch_merge; "
            "import mused_tpu_torch.parallel.kmeans_sharded; "
            "from mused_tpu_torch.native import IncDBHandle, incdb_available; "
            "import mused_tpu_torch.main; import mused_tpu_torch.data.sed2012; "
            "import mused_tpu_torch.utils.output as o; import mused_tpu_torch.utils.tee; "
            "assert not o.HAVE_MPL; "
            "print([m for m, mod in sys.modules.items() if mod is not None and "
            "m.split('.')[0] in ('jax', 'pandas', 'mused_tpu', 'matplotlib')])"
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
