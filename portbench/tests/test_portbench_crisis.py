"""The crisis cell's pieces on the CPU: its frozen generator, its check on
the program's own output at a small size, the check failing each planted
fault, and the readers of its new per-layer metrics."""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, spans
from portbench.drivers import crisis_stream
from portbench.gen import crisis_synth
from portbench.roofline import mma_counts

CELL = "crisis-w100k-spectral"
# a small size of the cell: the program's plain versions run on the CPU; 24
# events of about 100 rows each in a 4096-row window
SMALL = {"config": {"window_size": 4096, "k_basis": 8, "nbins": 512, "text_dim": 128,
                    "image_dim": 128, "n_clusters_cap": 32, "n_events": 24},
         "traffic": {"pool_windows": 2, "windows_per_call": 1, "min_calls": 2}}
FAULTS = crisis_stream.FAULTS + ("half_rows", "labels_altered")


def _run(faults: tuple) -> dict:
    return harness.run_cell(harness.resolve(CELL), 2**31 + 11, 0.2, False,
                            t_start=time.perf_counter(), device="cpu", faults=faults,
                            overrides=SMALL)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 9_123_456_789])
def test_the_generator_gives_the_configurations_shapes_and_the_same_records(seed):
    cfg = harness.resolve(CELL).config
    kw = dict(n_events=cfg["n_events"], noise_rate=cfg["noise_rate"], d_text=cfg["text_dim"],
              d_image=cfg["image_dim"], noise_scale=cfg["embedding_noise_scale"])
    (text, image), labels = crisis_synth.make_stream(40_000, seed=seed, **kw)
    assert text.shape == (40_000, 768) and image.shape == (40_000, 768)
    assert text.dtype == image.dtype == np.float32 and labels.dtype == np.int64
    assert np.allclose(np.linalg.norm(text, axis=1), 1.0, atol=1e-5)
    assert set(np.unique(labels)) == set(range(cfg["n_events"] + 1))
    assert abs((labels == 0).mean() - cfg["noise_rate"]) < 0.02
    (t2, i2), l2 = crisis_synth.make_stream(40_000, seed=seed, **kw)
    assert np.array_equal(text, t2) and np.array_equal(image, i2) and np.array_equal(labels, l2)
    (t3, _), _ = crisis_synth.make_stream(40_000, seed=seed + 1, **kw)
    assert not np.array_equal(text, t3)


def test_the_generator_keeps_the_cosine_to_the_centroid_across_widths():
    """The noise scale of the configuration gives rows at d = 768 the cosine
    to their event's centroid that noise 0.15 gives at d = 512."""
    def cosine(d, scale):
        (text, _), labels = crisis_synth.make_stream(20_000, n_events=4, noise_rate=0.0,
                                                     d_text=d, d_image=d,
                                                     noise_scale=scale, seed=1)
        c = np.stack([text[labels == e].mean(axis=0) for e in range(1, 5)])
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        return float(np.mean(np.sum(text * c[labels - 1], axis=1)))
    scale = harness.resolve(CELL).config["embedding_noise_scale"]
    assert cosine(768, scale) == pytest.approx(cosine(512, 0.15), abs=0.01)


def test_a_sound_small_run_is_correct():
    out = _run(())
    assert out["correct"] is True, out["compared"]
    assert set(out["compared"]) == set(harness.resolve(CELL).traffic["limits"])


@pytest.mark.parametrize("fault", FAULTS)
def test_each_planted_fault_is_not_correct(fault):
    out = _run((fault,))
    assert out["correct"] is False, out["compared"]


def test_the_drivers_faults_are_kept_from_the_tap():
    drv = crisis_stream.Driver(harness.resolve(CELL), 1, None, trace=False,
                               faults=("ritz_tf32", "half_rows"))
    assert drv.stap.faults == ("ritz_tf32",) and drv.tap.faults == ("half_rows",)


def _rec(name, ms=1.0, device_ms=None, counters=None):
    return SimpleNamespace(name=name, key=None, start_ns=0, end_ns=int(ms * 1e6),
                           device_ms=device_ms, counters=counters)


def test_the_spectral_readers(monkeypatch):
    recs = ([_rec("spectral.sweep", device_ms=200.0) for _ in range(14)]
            + [_rec("spectral.sweeps", counters={"spectral.sweeps": 1}) for _ in range(14)]
            + [_rec("spectral.ritz", device_ms=10.0) for _ in range(14)])
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    run = SimpleNamespace(windows=2, attempted=2)
    assert harness.metric_reader("spectral.sweep_ms.crisis")(run) == pytest.approx(200.0)
    assert harness.metric_reader("spectral.ritz_ms.crisis")(run) == pytest.approx(70.0)
    monkeypatch.setattr(spans, "program_records", lambda: [])
    for name in ("spectral.sweep_ms.crisis", "spectral.ritz_ms.crisis",
                 "blocked.union_blocks.crisis"):
        assert harness.metric_reader(name)(run) is None


def test_the_tensor_core_roofline_counts_planes():
    """Two K2 launches and one K3 pair: four planes at their bound over the
    launches' device seconds."""
    bound = mma_counts.plane_bound_s(2048, 98_304, 768, 1536)
    assert bound == pytest.approx(2 * 2048 * 98_304 * 768 / 989e12)
    kernel_s = {"void (anonymous namespace)::binned_mma_kernel<0>(...)": 4 * bound,
                "(anonymous namespace)::binned_mma_pair_kernel(...)": 4 * bound,
                "binned_postings_kernel": 1.0}
    kernel_n = {"void (anonymous namespace)::binned_mma_kernel<0>(...)": 2,
                "(anonymous namespace)::binned_mma_pair_kernel(...)": 1,
                "binned_postings_kernel": 5}
    trace = SimpleNamespace(
        seconds_of=lambda p: sum(s for k, s in kernel_s.items() if any(x in k for x in p)),
        launches_of=lambda p: sum(c for k, c in kernel_n.items() if any(x in k for x in p)))
    run = SimpleNamespace(trace=trace, windows=3, mma_plane_bound_s=bound)
    assert harness.metric_reader("kernels.k23_mma_roofline.crisis")(run) == pytest.approx(50.0)
    assert harness.metric_reader("kernels.k23_mma_launches.crisis")(run) == pytest.approx(1.0)
    assert harness.metric_reader("kernels.k23_mma_roofline.crisis")(
        SimpleNamespace(trace=None, windows=3, mma_plane_bound_s=bound)) is None
