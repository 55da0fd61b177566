"""The scanned multi-window dispatch and the repaired host waits on a CUDA
device.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_scanned.py

On a seeded ``make_stream`` at window 500 (k_basis 10, reduced_dim 16, 7
windows): groups of W = 3 and 4 give every window's labels and every metric
of per-window dispatch on the card, with exactly 4 K1 launches per window
step (the padded tail's included); the engine's spans never call
``torch.cuda.synchronize``; Lloyd's loop on the card is bit-equal to the CPU
on sums exact in any order and reads the host as often; the detector's
groups equal its per-window results, each group's readiness a CUDA event.
"""
import contextlib
import io
import threading

import numpy as np
import pytest
import torch

from mused_tpu_torch import api
from mused_tpu_torch.data.synthetic import make_stream
from mused_tpu_torch.engine import streaming
from mused_tpu_torch.ops import kmeans
from mused_tpu_torch.ops.kernels import affinity_kernel as ak
from mused_tpu_torch.serving import StreamDetector, _entry_ready
from mused_tpu_torch.utils.config import PipelineConfig

WINDOW, N = 500, 3500


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the scanned dispatch's card path runs only on the card")
    streaming.configure_precision()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def stream():
    return make_stream(N, noise_rate=0.9, seed=3)


def _run(stream, approach, group, device, monkeypatch):
    mods, mtypes, labels = stream
    seen = []
    compute = streaming.metrics_mod.compute_all_metrics
    monkeypatch.setattr(streaming.metrics_mod, "compute_all_metrics",
                        lambda *a: seen.append(np.array(a[8])) or compute(*a))
    ak.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        res = api.process_streaming_data(
            api.get_initial_results()[0], mods, mtypes, WINDOW, 16, 10, 2, 0, approach, labels,
            1, 0.9, "binary", True, 1.5, 2, windows_per_batch=group, device=device)
    metrics = {k: v[0] for k, v in res.items() if k != "processing_time"}
    return metrics, seen[0], ak.launches


@pytest.mark.cuda
@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC", "sSpectral"])
def test_groups_on_the_card_equal_per_window_dispatch(cuda, stream, monkeypatch, approach):
    want, want_labels, launches = _run(stream, approach, 1, cuda, monkeypatch)
    assert launches == 4 * 7
    for group in (3, 4):
        got, labels, launches = _run(stream, approach, group, cuda, monkeypatch)
        assert got == want
        np.testing.assert_array_equal(labels, want_labels)
        assert launches == 4 * -(-7 // group) * group


@pytest.mark.cuda
def test_engine_spans_never_synchronize_the_card(cuda, stream, monkeypatch):
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a) or real())
    _run(stream, "SWFDMC", 1, cuda, monkeypatch)
    _run(stream, "sSVDMC", 4, cuda, monkeypatch)
    assert calls == []


@pytest.mark.cuda
@pytest.mark.parametrize("tol,max_iters", [(1e-4, 100), (-1.0, 20)])
def test_lloyd_on_the_card_equals_the_cpu(cuda, monkeypatch, tol, max_iters):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(0, 16, size=(512, 3)).astype(np.float32))
    init = x[torch.from_numpy(rng.choice(512, 6, replace=False))]
    runs = {}
    orig_bool = torch.Tensor.__bool__
    for dev in ("cpu", cuda):
        reads = []
        monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append(1) or orig_bool(t))
        labels, cents = kmeans.kmeans(x.to(dev), 6, None, k_max=8, max_iters=max_iters,
                                      tol=tol, init=torch.cat([init, torch.zeros(2, 3)]).to(dev))
        monkeypatch.undo()
        runs[str(dev)] = (labels.cpu(), cents.cpu(), len(reads))
    (lc, cc, rc), (lg, cg, rg) = runs.values()
    assert torch.equal(lc, lg) and torch.equal(cc, cg) and rc == rg
    assert rg <= -(-max_iters // kmeans.CHECK_EVERY)


@pytest.mark.cuda
def test_detector_groups_on_the_card(cuda, stream):
    mods, mtypes, _ = stream
    out = {}
    for group in (1, 4):
        cfg = PipelineConfig(window_size=WINDOW, reduced_dim=16, k_basis=10, approach="SWFDMC",
                             label_mode="all", n_clusters_override=20, k_estimate="eigengap",
                             windows_per_batch=group)
        det = StreamDetector(mtypes, WINDOW, cfg=cfg, max_lag=8)
        res, checked = [], 0
        for lo in range(0, N, 250):
            rows = [m[lo:lo + 250] for m in mods]
            if group == 1:
                res.extend(det.push(rows))
                continue
            gate = threading.Event()
            det._submit(gate.wait)     # hold the worker: the push returns before its group lands
            res.extend(det.push(rows))
            gate.set()
            det._worker.drain()
            if det._pending and len(det._pending[0]) == 5:
                handle = det._pending[0][3]
                assert handle._event is not None
                torch.cuda.synchronize()
                assert _entry_ready(det._pending[0])
                checked += 1
        assert checked == (1 if group == 4 else 0)
        out[group] = res + det.flush()
    assert [r.window_index for r in out[4]] == [r.window_index for r in out[1]]
    for a, b in zip(out[1], out[4]):
        np.testing.assert_array_equal(a.clusters, b.clusters)
