"""Slice 2's dense-window modules on a CUDA device against the same code on
the CPU.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_slice2.py

Tolerance: DBSCAN labels bit-equal (fixtures clear of eps by 1e-4
relative; the min-label fixed point is unique); the incremental clusterer's
labels bit-equal to its CPU run; the spectrum within 2e-6 of the CPU's
(both float64 eigh, cast to float32); ``mark_background`` on >= 99.9% of
rows (CUDA's sort / cumsum add in another order, so the Otsu threshold may
move by an ulp); the eigengap count equal; the detector on the card equal to
itself after save / load, its window bookkeeping equal to the CPU's; a
push that fires no window returns a window once its CUDA event completes,
and never waits for it.
"""
import threading
import time

import numpy as np
import pytest
import torch

from mused_tpu_torch.data.synthetic import crisis_embedding_stream
from mused_tpu_torch.ops import dbscan, kmeans, spectral
from mused_tpu_torch.serving import StreamDetector, _entry_ready
from mused_tpu_torch.utils.config import PipelineConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: slice 2's device paths run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _uniform_clear(seed, eps, n=600, d=3):
    """Uniform points with no pair within 1e-4 relative of eps."""
    while True:
        x = np.random.default_rng(seed).uniform(-5, 5, size=(n, d)).astype(np.float32)
        dist = np.sqrt(((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1))
        if not np.any(np.abs(dist - eps) <= 1e-4 * eps):
            return x
        seed += 1000


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_dbscan_on_the_card_equals_the_cpu(cuda, seed):
    x = _uniform_clear(seed, 0.8)
    want = dbscan.dbscan(x, 0.8, 4, device="cpu")
    np.testing.assert_array_equal(dbscan.dbscan(x, 0.8, 4, device=cuda), want)


@pytest.mark.cuda
def test_incremental_dbscan_on_the_card_equals_the_cpu(cuda):
    x = _uniform_clear(2, 1.0)
    runs = {}
    for dev in ("cpu", cuda):
        inc = dbscan.IncrementalDBSCAN(1.0, 4, device=dev)
        for i in range(0, len(x), 150):
            inc.insert(x[i:i + 150])
        runs[str(dev)] = inc.get_cluster_labels(x)
    np.testing.assert_array_equal(runs["cuda"], runs["cpu"])


@pytest.mark.cuda
def test_nearest_within_order_on_the_card(cuda):
    d2 = torch.tensor([[0.5, 0.0, -0.0, 0.5, float("inf"), 0.25, 0.5]])
    v_cpu, i_cpu = dbscan.nearest_within(d2, 6)
    v_gpu, i_gpu = dbscan.nearest_within(d2.to(cuda), 6)
    assert torch.equal(i_gpu.cpu(), i_cpu) and torch.equal(v_gpu.cpu(), v_cpu)


@pytest.mark.cuda
def test_spectral_pieces_on_the_card(cuda):
    mods, _, labels = crisis_embedding_stream(n_rows=400, n_events=4, noise_rate=0.3,
                                              d_text=32, d_image=32, seed=1)
    x = torch.from_numpy(np.concatenate(mods, 1))
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    sim = x @ x.T
    adj = torch.zeros_like(sim).scatter_(1, torch.topk(sim, 9, dim=1)[1], 1.0)
    lam_c, _ = spectral._normalized_spectrum(adj)
    lam_g, vecs_g = spectral._normalized_spectrum(adj.to(cuda))
    np.testing.assert_allclose(lam_g.cpu().numpy(), lam_c.numpy(), rtol=0, atol=2e-6)
    k = spectral.eigengap_k_from_spectrum(lam_c, k_max=8)
    assert int(spectral.eigengap_k_from_spectrum(lam_g, k_max=8)) == int(k)
    emb = spectral._njw_embedding(vecs_g, k, 8)
    lab, _ = kmeans.kmeans(emb, k, torch.Generator(device=cuda).manual_seed(0), k_max=8)
    got = kmeans.mark_background(emb, lab, k_max=8).cpu()
    want = kmeans.mark_background(emb.cpu(), lab.cpu(), k_max=8)
    assert (got == want).float().mean() >= 0.999


@pytest.mark.cuda
def test_detector_on_the_card(cuda, tmp_path):
    mods, mtypes, _ = crisis_embedding_stream(n_rows=1200, n_events=4, noise_rate=0.3,
                                              d_text=32, d_image=32, seed=2)
    cfg = PipelineConfig(window_size=200, reduced_dim=16, k_basis=6, approach="sSpectral",
                         label_mode="all", n_clusters_override=10, k_estimate="eigengap",
                         background_bucket=True)

    def run(det, lo, hi):
        out = []
        for a in range(lo, hi, 90):
            out.extend(det.push([m[a:min(a + 90, hi)] for m in mods]))
        return out

    full = StreamDetector(mtypes, 200, cfg=cfg)
    assert full.engine.device.type == "cuda"
    a = run(full, 0, 1200) + full.flush()
    cpu = StreamDetector(mtypes, 200, cfg=cfg, device="cpu")
    c = run(cpu, 0, 1200) + cpu.flush()
    assert [(r.window_index, r.row_start) for r in a] == \
        [(r.window_index, r.row_start) for r in c]
    half = StreamDetector(mtypes, 200, cfg=cfg)
    b = run(half, 0, 500)
    path = str(tmp_path / "det.npz")
    b.extend(half.save(path))
    resumed = StreamDetector.load(path)
    assert resumed.engine.state.swfd.blocks.device.type == "cuda"
    b.extend(run(resumed, 500, 1200) + resumed.flush())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.clusters, y.clusters)
    det = StreamDetector(mtypes, 200, cfg=cfg, max_lag=4)
    run(det, 0, 360)
    gate = threading.Event()
    det._submit(gate.wait)          # hold the worker: the push that fires window 1
    run(det, 360, 400)              # returns before its window lands
    gate.set()
    det._worker.drain()
    assert det._pending and all(e[2] is not None for e in det._pending)   # CUDA events
    torch.cuda.synchronize()
    assert all(_entry_ready(e) for e in det._pending)
    det.flush()


@pytest.mark.cuda
def test_a_push_returns_a_window_once_its_event_completes(cuda, monkeypatch):
    """A window whose CUDA event sits behind a device sleep: a push that
    fires no window neither returns it nor waits for the card; after a
    synchronize the next such push returns it."""
    mods, mtypes, _ = crisis_embedding_stream(n_rows=600, n_events=4, noise_rate=0.3,
                                              d_text=32, d_image=32, seed=2)
    cfg = PipelineConfig(window_size=200, reduced_dim=16, k_basis=6, approach="sSpectral",
                         label_mode="all", n_clusters_override=10, k_estimate="eigengap")
    det = StreamDetector(mtypes, 200, cfg=cfg)
    warm = det.push([m[:200] for m in mods]) + det.flush()
    assert [r.window_index for r in warm] == [0]
    cycles = 2_000_000_000
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    sleep_s = time.perf_counter() - t
    recorded_event = det._recorded_event

    def behind_a_sleep():
        torch.cuda._sleep(cycles)
        return recorded_event()

    monkeypatch.setattr(det, "_recorded_event", behind_a_sleep)
    assert det.push([m[200:400] for m in mods]) == []              # fires window 1
    det._worker.drain()
    assert len(det._pending) == 1
    t = time.perf_counter()
    got = det.push([m[400:410] for m in mods])                     # fires nothing
    took = time.perf_counter() - t
    assert got == [] and not _entry_ready(det._pending[0])         # still asleep
    assert took < sleep_s / 10, (took, sleep_s)
    torch.cuda.synchronize()
    got = det.push([m[410:420] for m in mods])
    assert [r.window_index for r in got] == [1] and not det._pending
