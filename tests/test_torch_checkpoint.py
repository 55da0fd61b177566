"""The port's checkpoint / resume (``mused_tpu_torch/utils/checkpoint``,
``process_streaming_data(checkpoint_dir=...)``), on the CPU at window 64:

  * a stream that crashes after 2 of its 4 windows and resumes from its
    checkpoints gives exactly the uninterrupted run's metrics, for SWFDMC,
    sSVDMC, DBSCAN_incr and DBSCAN_centr (mirrors tests/test_checkpoint.py);
  * a ``StreamState`` round-trips leaf for leaf, Python counters included;
  * ``latest_checkpoint`` ignores names that are not ``stream_<n>.npz``;
  * the dispatch-ahead loop (no checkpoints) gives the sequential loop's
    metrics.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from mused_tpu_torch import api as tapi
from mused_tpu_torch.data.ingest import to_device
from mused_tpu_torch.engine import streaming as ts
from mused_tpu_torch.utils import checkpoint as ckpt
from mused_tpu_torch.utils.config import PipelineConfig
from torch_parity import synthetic_window_stream

KW = dict(window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2, seed=0,
          step_window_ratio=1, noise_rate=0.5, label_mode="binary", sorting=True,
          eps=1.5, min_samples=2)


@pytest.fixture(scope="module")
def stream():
    return synthetic_window_stream(seed=0)


def _run(stream, approach, checkpoint_dir=None, crash_after=None, monkeypatch=None,
         **extra):
    mods, mtypes, labels = stream
    if crash_after is not None:
        orig, calls = ts.StreamingEngine.dispatch_window, {"n": 0}

        def bomb(self, *a, **k):
            if calls["n"] >= crash_after:
                raise KeyboardInterrupt("simulated crash")
            calls["n"] += 1
            return orig(self, *a, **k)

        monkeypatch.setattr(ts.StreamingEngine, "dispatch_window", bomb)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            res = tapi.process_streaming_data(
                results=tapi.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, approach=approach, complete_true_labels=labels,
                checkpoint_dir=checkpoint_dir, device="cpu", **KW, **extra)
    finally:
        if crash_after is not None:
            monkeypatch.undo()
    return res, out.getvalue()


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC", "DBSCAN_incr", "DBSCAN_centr"])
def test_crash_resume_matches_uninterrupted(approach, stream, tmp_path, monkeypatch):
    straight, _ = _run(stream, approach)
    ckdir = str(tmp_path / approach)
    with pytest.raises(KeyboardInterrupt):
        _run(stream, approach, ckdir, crash_after=2, monkeypatch=monkeypatch)
    assert ckpt.latest_checkpoint(ckdir).endswith("stream_00000002.npz")
    resumed, printed = _run(stream, approach, ckdir)
    assert "at window 2" in printed
    for key in ("nmi_score", "f1_score", "f1_aligned", "nmi_e_score"):
        assert resumed[key][0] == straight[key][0], key


def test_checkpoint_every_and_the_dispatch_ahead_loop(stream, tmp_path):
    ckdir = str(tmp_path / "every")
    sequential, _ = _run(stream, "SWFDMC", ckdir, checkpoint_every=2)
    assert sorted(os.listdir(ckdir)) == ["stream_00000002.npz", "stream_00000004.npz"]
    ahead, _ = _run(stream, "SWFDMC")
    assert ahead["nmi_score"][0] == sequential["nmi_score"][0]
    assert ahead["f1_score"][0] == sequential["f1_score"][0]


def test_stream_state_round_trip(stream, tmp_path):
    mods, mtypes, labels = stream
    cfg = PipelineConfig(window_size=64, k_basis=3, reduced_dim=8, approach="SWFDMC",
                         n_clusters_override=2)
    eng = ts.StreamingEngine(cfg, "cpu")
    prev = None
    for w in range(2):
        host = eng.featurize([m[64 * w:64 * (w + 1)] for m in mods], mtypes)
        prev = eng.process_window(host, to_device(host, eng.device), mtypes,
                                  labels[64 * w:64 * (w + 1)], w, prev)
    eng.state = eng.state._replace(minibatch=eng.state.minibatch._replace(initialized=True))
    path = ckpt.save_checkpoint(ckpt.checkpoint_name(str(tmp_path), 2), eng.state,
                                {"next_window": 2, "prev_clusters": prev,
                                 **eng.host_snapshot()})
    fresh = ts.StreamingEngine(cfg, "cpu")
    state, host = ckpt.load_checkpoint(path, like=fresh.state)
    assert host["next_window"] == 2 and host["swfd_R"] == eng.swfd_R
    np.testing.assert_array_equal(host["prev_clusters"], prev)
    want = ckpt.flatten_state(eng.state)
    got = ckpt.flatten_state(state)
    assert sorted(got) == sorted(want) and "swfd.active.sketch" in got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert type(state.swfd.count) is int and state.swfd.count == 128
    assert type(state.swfd.seal_cursor) is int and state.swfd.seal_cursor == 2
    assert state.minibatch.initialized is True
    assert state.swfd.blocks.dtype == torch.float32
    assert state.swfd.active.count.dtype == eng.state.swfd.active.count.dtype
    leaves, _ = ckpt.load_checkpoint(path)
    assert set(leaves) == set(want)
    bad = ts.StreamingEngine(cfg.replace(window_size=32), "cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.unflatten_like(bad.state, leaves)


def test_latest_checkpoint_ignores_foreign_names(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_checkpoint(d) is None
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("stream_manual.npz", "stream_00000003.npz.tmp", "other_00000009.npz",
                 "stream_00000012.npz", "stream_00000003.npz", "stream_.npz"):
        open(os.path.join(d, name), "wb").close()
    assert ckpt.latest_checkpoint(d) == os.path.join(d, "stream_00000012.npz")
    assert ckpt.checkpoint_name(d, 7) == os.path.join(d, "stream_00000007.npz")
