"""Centroid matching (``matching="centroid"``, slice 2f) in the port's engine
against the JAX engine, on the crisis embedding stream (BASELINE.md config
#2, cut to 320 rows of two 24-wide embeddings, unsorted) at window 64:

  * every window's matched labels equal the JAX engine's with the JAX
    side's draws and SVD column signs injected (sSVDMC, SWFDMC), and
    ``process_streaming_data``'s metrics equal the JAX package's;
  * the serving detector with ``matching="centroid"`` equals the JAX
    detector window for window, and a ``save`` / ``load`` halfway resumes to
    the uninterrupted run;
  * a checkpointed stream resumes from its npz (the registry inside it) to
    the uninterrupted metrics;
  * a JAX engine's snapshot (registry included) continues in the port with
    the JAX run's labels.
"""
import contextlib
import io
import os

import jax
import numpy as np
import pytest

from mused_tpu import api as japi
from mused_tpu.data.synthetic import crisis_embedding_stream as jcrisis
from mused_tpu.engine import streaming as js
from mused_tpu.serving import StreamDetector as JDetector
from mused_tpu.utils.config import PipelineConfig as JConfig
from mused_tpu_torch import api as tapi
from mused_tpu_torch.data.ingest import to_device
from mused_tpu_torch.engine import streaming as ts
from mused_tpu_torch.serving import StreamDetector
from mused_tpu_torch.utils import checkpoint as ckpt
from mused_tpu_torch.utils import convert
from mused_tpu_torch.utils.config import PipelineConfig
from torch_parity import inject_jax_draws

W = 64
KW = dict(window_size=W, reduced_dim=8, k_basis=3, n_clusters_total=6, seed=0,
          step_window_ratio=1, noise_rate=0.3, label_mode="all", sorting=False,
          eps=1.5, min_samples=2)


@pytest.fixture(scope="module")
def crisis():
    return jcrisis(n_rows=320, n_events=4, noise_rate=0.3, d_text=24, d_image=24, seed=0)


def _cfg(cls, approach, **kw):
    return cls(window_size=W, reduced_dim=8, k_basis=3, approach=approach, label_mode="all",
               n_clusters_override=6, matching="centroid", **kw)


def _windows(mods, labels, lo, hi):
    for w in range(lo, hi):
        yield w, [m[W * w:W * (w + 1)] for m in mods], labels[W * w:W * (w + 1)]


def _jax_labels(eng, mods, mtypes, labels, lo, hi, prev=None):
    out = []
    for w, rows, truth in _windows(mods, labels, lo, hi):
        prev = eng.process_window(rows, mtypes, truth, w, prev)
        out.append(prev)
    return out


def _port_labels(eng, mods, mtypes, labels, lo, hi, prev=None):
    out = []
    for w, rows, truth in _windows(mods, labels, lo, hi):
        feats = eng.featurize(rows, mtypes)
        prev = eng.process_window(feats, to_device(feats, eng.device), mtypes, truth, w, prev)
        out.append(prev)
    return out


@pytest.mark.parametrize("approach", ["sSVDMC", "SWFDMC"])
def test_centroid_labels_match_jax_window_for_window(approach, crisis, monkeypatch):
    mods, mtypes, labels = crisis
    want = _jax_labels(js.StreamingEngine(_cfg(JConfig, approach)), mods, mtypes, labels,
                       0, 5)
    inject_jax_draws(monkeypatch, svd_signs=True)
    eng = ts.StreamingEngine(_cfg(PipelineConfig, approach), "cpu")
    got = _port_labels(eng, mods, mtypes, labels, 0, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.centroid_matcher.next_id > 0 and eng.centroid_matcher.window == 5


@pytest.mark.parametrize("approach", ["sSVDMC", "DBSCAN_centr"])
def test_process_streaming_data_centroid_metrics_match_jax(approach, crisis, monkeypatch):
    """DBSCAN_centr keeps its own centroid re-map (the registry is unused)."""
    mods, mtypes, labels = crisis

    def run(api, **dev):
        with contextlib.redirect_stdout(io.StringIO()):
            return api.process_streaming_data(
                results=api.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, approach=approach, complete_true_labels=labels,
                matching="centroid", **KW, **dev)

    want = run(japi)
    inject_jax_draws(monkeypatch, svd_signs=True)
    got = run(tapi, device="cpu")
    for key in ("nmi_score", "nmi_e_score", "f1_score", "f1_aligned"):
        assert got[key] == want[key], key


def _serve(det, mods, lo, hi, chunk=40):
    out = []
    for a in range(lo, hi, chunk):
        out.extend(det.push([m[a:min(a + chunk, hi)] for m in mods]))
    return out


def test_detector_centroid_matches_jax_and_resumes(crisis, tmp_path, monkeypatch):
    mods, mtypes, _ = crisis
    serve_cfg = dict(k_estimate="fixed")
    jdet = JDetector(mtypes, W, cfg=_cfg(JConfig, "sSVDMC", windows_per_batch=1,
                                          **serve_cfg))
    want = _serve(jdet, mods, 0, 320) + jdet.flush()
    inject_jax_draws(monkeypatch, svd_signs=True)
    whole = StreamDetector(mtypes, W, cfg=_cfg(PipelineConfig, "sSVDMC", **serve_cfg),
                           device="cpu")
    got = _serve(whole, mods, 0, 320) + whole.flush()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.clusters, w.clusters)
        np.testing.assert_array_equal(g.new_events, w.new_events)
    first = StreamDetector(mtypes, W, cfg=_cfg(PipelineConfig, "sSVDMC", **serve_cfg),
                           device="cpu")
    part = _serve(first, mods, 0, 160)
    part += first.save(str(tmp_path / "det.npz"))
    resumed = StreamDetector.load(str(tmp_path / "det.npz"), device="cpu")
    assert resumed.engine.centroid_matcher.window == first.engine.centroid_matcher.window
    part += _serve(resumed, mods, 160, 320) + resumed.flush()
    assert [r.window_index for r in part] == [r.window_index for r in got]
    for a, b in zip(part, got):
        np.testing.assert_array_equal(a.clusters, b.clusters)


def test_checkpointed_centroid_stream_resumes(crisis, tmp_path, monkeypatch):
    mods, mtypes, labels = crisis
    inject_jax_draws(monkeypatch, svd_signs=True)

    def run(d):
        with contextlib.redirect_stdout(io.StringIO()):
            return tapi.process_streaming_data(
                results=tapi.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, approach="sSVDMC", complete_true_labels=labels,
                matching="centroid", checkpoint_dir=str(d), checkpoint_every=2,
                device="cpu", **KW)

    whole = run(tmp_path / "a")
    run(tmp_path / "b")
    for f in os.listdir(tmp_path / "b"):      # keep the checkpoint after window 2
        if f != "stream_00000002.npz":
            os.remove(tmp_path / "b" / f)
    _, host = ckpt.load_checkpoint(str(tmp_path / "b" / "stream_00000002.npz"))
    snap = host["centroid_matcher"]
    assert snap["window"] == 2 and snap["max_dist"] is None and len(snap["ids"]) >= 1
    resumed = run(tmp_path / "b")
    for key in ("nmi_score", "f1_score", "f1_aligned"):
        assert resumed[key] == whole[key], key


def test_jax_centroid_snapshot_continues_in_the_port(crisis, monkeypatch):
    mods, mtypes, labels = crisis
    cfg_j = _cfg(JConfig, "sSVDMC", centroid_max_dist=0.9)
    jeng = js.StreamingEngine(cfg_j)
    prev = _jax_labels(jeng, mods, mtypes, labels, 0, 2)[-1]
    state_np = jax.tree_util.tree_map(np.asarray, jeng.state)
    host = jeng.host_snapshot()
    want = _jax_labels(jeng, mods, mtypes, labels, 2, 5, prev)
    inject_jax_draws(monkeypatch, svd_signs=True)
    teng = ts.StreamingEngine(_cfg(PipelineConfig, "sSVDMC", centroid_max_dist=0.9), "cpu")
    teng.restore(*convert.engine_state_from_jax(state_np, host, "cpu"))
    assert teng.centroid_matcher.max_dist == 0.9 and teng.centroid_matcher.window == 2
    got = _port_labels(teng, mods, mtypes, labels, 2, 5, prev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
