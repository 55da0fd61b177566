"""The port's huge-window path on two embedding modalities (the CrisisMMD-
style CLIP stream of BASELINE.md config #2) against the benchmark's plain
float64 reference (``portbench/reference/spectral.py``), on the CPU at a
small size: n = 4096 rows of two 64-wide embeddings, 512-row blocks,
nbins 64 (64 groups per bin).

  * fused row blocks equal, bit for bit, the reference's binned cosine rows
    on the same bf16-rounded unit rows, and the degrees equal the
    reference's.  The rows are +-1/8 in every feature (unit rows exactly),
    so every product is exact in float32 and in float64 alike, and the many
    tied similarities exercise both sides' tie rules (lowest group in a
    bin, slot order at the threshold);
  * on seeded Gaussian crisis rows, the port's Ritz pairs with the probe
    injected against the reference's subspace iteration from the same
    probe (ROADMAP's rule on random streams): Ritz values within 1e-5 (the
    port's products are float32, the reference's float64; a Ritz value is
    at most 1), ``ritz_identity`` and ``ritz_energy_gap`` under the cell's
    limits; products rounded to TF32 or missing half their rows fail them;
  * in ``process_streaming_data``'s huge window (``force_blocked_window``),
    the eigengap count and the background labels come from the Ritz pairs
    the sweeps returned: recomputed from them, they are the engine's;
  * the spans: one ``spectral.degrees`` and 7 ``spectral.sweeps`` a window,
    recorded only while recording is on.

The file imports no JAX.
"""
import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from mused_tpu_torch import api
from mused_tpu_torch.ops import blocked_affinity as ba
from mused_tpu_torch.ops import blocked_spectral as bspec
from mused_tpu_torch.ops import kmeans
from mused_tpu_torch.utils import profiling
from mused_tpu_torch.utils.config import PipelineConfig
from portbench.drivers.crisis_stream import tf32_round
from portbench.gen import crisis_synth
from portbench.reference import spectral as ref

N, D, BLOCK, NBINS, K_BASIS, K_MAX = 4096, 64, 512, 64, 8, 16
M = K_MAX + 8
LIMITS = json.loads((pathlib.Path(__file__).parents[1] / "portbench" / "traffic"
                     / "crisis-spectral.json").read_text())["limits"]


def _sign_rows(seed: int) -> list:
    """Two modalities of +-1/8 rows (unit norm exactly), 12 planted sign
    patterns with 8 flipped features per row, and 5% invalid rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        centers = rng.choice([-1.0, 1.0], size=(12, D))
        x = centers[rng.integers(0, 12, N)]
        flips = np.argsort(rng.random((N, D)), axis=1)[:, :8]
        np.put_along_axis(x, flips, -np.take_along_axis(x, flips, axis=1), axis=1)
        x = (x / 8.0).astype(np.float32)
        x[rng.random(N) < 0.05] = np.nan
        out.append(x)
    return out


def _crisis(seed: int):
    """(modalities, labels) of the crisis generator at d = 64 with its
    repository default noise 0.15: 12 events, 40% noise."""
    return crisis_synth.make_stream(N, n_events=12, noise_rate=0.4, d_text=D, d_image=D,
                                    noise_scale=0.15, seed=seed)


def _cols(mods):
    return ba.generic_columns([torch.from_numpy(m) for m in mods], ["embedding"] * 2, "cpu")


def _sweep_kw():
    return dict(block=BLOCK, k_basis=K_BASIS, select="binned", nbins=NBINS)


def _reference_graph(mods):
    p = ref.EmbeddingPanels(mods, "cpu")
    g = ref.Graph(N, "cpu")
    blocks = {}
    for lo in range(0, N, BLOCK):
        blocks[lo] = ref.fused_block(p, lo, lo + BLOCK, K_BASIS, NBINS)
        g.add(lo, blocks[lo])
    return blocks, g.operator()


@pytest.fixture(scope="module")
def crisis():
    mods, _ = _crisis(2**31 + 5)
    _, m = _reference_graph(mods)
    probe = torch.from_numpy(np.random.default_rng(3).standard_normal((N, M))
                             .astype(np.float32))
    return mods, m, probe


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_fused_blocks_and_degrees_equal_the_reference_bit_for_bit(seed):
    mods = _sign_rows(seed)
    cols = _cols(mods)
    blocks, _ = _reference_graph(mods)
    deg = torch.zeros(N, dtype=torch.float64)
    for start, fused in ba.scan_blocks(cols, BLOCK, K_BASIS, select="binned", nbins=NBINS):
        want = blocks[start]
        assert torch.equal(fused != 0, want), start
        deg[start:start + BLOCK] += want.sum(dim=1)
        deg += want.sum(dim=0)
    assert sum(int(b.sum()) for b in blocks.values()) > N * K_BASIS
    got = bspec._degrees(cols, **_sweep_kw())
    assert torch.equal(got.double(), 0.5 * deg)


def _ritz(mods, probe, monkeypatch=None, fault=None):
    cols = _cols(mods)
    if fault == "tf32":
        orig = bspec._sym_matmul
        monkeypatch.setattr(bspec, "_sym_matmul",
                            lambda c, v, **kw: tf32_round(orig(c, tf32_round(v), **kw)))
    elif fault == "half_rows":
        orig_scan = ba.scan_blocks

        def half(*a, **kw):
            for start, fused in orig_scan(*a, **kw):
                fused = fused.clone()
                fused[BLOCK // 2:] = 0
                yield start, fused

        orig = bspec._sym_matmul

        def sym(*a, **kw):
            monkeypatch.setattr(ba, "scan_blocks", half)
            try:
                return orig(*a, **kw)
            finally:
                monkeypatch.setattr(ba, "scan_blocks", orig_scan)

        monkeypatch.setattr(bspec, "_sym_matmul", sym)
    return bspec.spectral_embedding_blocked(cols, None, k_max=K_MAX, probe=probe,
                                            **_sweep_kw())


def test_ritz_pairs_match_the_reference_from_the_same_probe(crisis):
    mods, m, probe = crisis
    ritz, lam = _ritz(mods, probe)
    _, want = ref.ritz_from_probe(m, probe, n_iter=6)
    assert torch.allclose(lam.double(), want, rtol=0, atol=1e-5)
    live = int(bspec.eigengap_k_from_spectrum(lam, k_max=K_MAX))
    assert live >= 2
    top = ref.top_eigenvalues(m, live)
    assert ref.ritz_identity(m, ritz, lam, live) <= LIMITS["ritz_identity"]
    assert 0 <= ref.ritz_energy_gap(lam, top, live) <= LIMITS["ritz_energy_gap"]


@pytest.mark.parametrize("fault,number", [("tf32", "ritz_identity"),
                                          ("half_rows", "ritz_identity"),
                                          ("half_rows", "ritz_energy_gap")])
def test_a_fault_in_the_products_fails_a_limit(crisis, monkeypatch, fault, number):
    mods, m, probe = crisis
    ritz, lam = _ritz(mods, probe, monkeypatch, fault)
    live = int(bspec.eigengap_k_from_spectrum(lam, k_max=K_MAX))
    if number == "ritz_identity":
        value = ref.ritz_identity(m, ritz, lam, live)
    else:
        value = ref.ritz_energy_gap(lam, ref.top_eigenvalues(m, live), live)
    assert value > LIMITS[number]


def _stream(mods, labels, cfg):
    with contextlib.redirect_stdout(io.StringIO()):
        return api.process_streaming_data(
            api.get_initial_results()[0], mods, ["embedding", "embedding"], N, M, K_BASIS,
            K_MAX, 5, "sSpectral", labels, 1, 0.4, "all", False, 1.5, 2, cfg=cfg,
            device="cpu")


def _cfg():
    return PipelineConfig(seed=5, subset_size=N, noise_rate=0.4, label_mode="all",
                          sorting=False, window_size=N, reduced_dim=M, k_basis=K_BASIS,
                          approach="sSpectral", n_clusters_override=K_MAX,
                          k_estimate="eigengap", background_bucket=True,
                          force_blocked_window=True, huge_window_fused_select=True)


def test_the_huge_windows_count_and_background_come_from_its_ritz_pairs(monkeypatch):
    mods, labels = _crisis(11)
    seen = {}
    embed, label = bspec.spectral_embedding_blocked, bspec.labels_from_ritz

    def embedding(*a, **kw):
        seen["ritz"], seen["lam"] = embed(*a, **kw)
        return seen["ritz"], seen["lam"]

    def labels_from_ritz(ritz, n_clusters, gen, **kw):
        seen["count"], seen["state"], seen["kw"] = int(n_clusters), gen.get_state(), kw
        seen["labels"] = label(ritz, n_clusters, gen, **kw)
        return seen["labels"]

    monkeypatch.setattr(bspec, "spectral_embedding_blocked", embedding)
    monkeypatch.setattr(bspec, "labels_from_ritz", labels_from_ritz)
    _stream(mods, labels, _cfg())
    assert seen["kw"]["background"] and seen["kw"]["k_max"] == K_MAX
    assert seen["count"] == int(bspec.eigengap_k_from_spectrum(seen["lam"], k_max=K_MAX))
    gen = torch.Generator().set_state(seen["state"])
    again = label(seen["ritz"], seen["count"], gen, **seen["kw"])
    assert torch.equal(again, seen["labels"])
    gen = torch.Generator().set_state(seen["state"])
    plain = label(seen["ritz"], seen["count"], gen, **{**seen["kw"], "background": False})
    bg = seen["labels"] == -1
    assert bool(bg.any()) and torch.equal(seen["labels"][~bg], plain[~bg])
    emb = seen["ritz"][:N, :K_MAX] * (torch.arange(K_MAX) < seen["count"])
    emb = emb / torch.clamp(torch.linalg.norm(emb, dim=1, keepdim=True), min=1e-12)
    assert torch.equal(kmeans.mark_background(emb, plain, k_max=K_MAX), seen["labels"])
    # the bucket holds noise records more than the stream does
    assert (labels[bg.numpy()] == 0).mean() > (labels == 0).mean()


def test_the_spectral_spans_are_recorded_only_while_recording():
    mods, labels = _crisis(12)
    profiling.clear()
    cols = _cols(mods)
    bspec.spectral_embedding_blocked(cols, torch.Generator().manual_seed(0), k_max=K_MAX,
                                     **_sweep_kw())
    assert not profiling.recorded()
    try:
        with profiling.recording():
            _stream(mods, labels, _cfg())
        recs = profiling.recorded()
    finally:
        profiling.clear()
    names = [r.name for r in recs]
    assert names.count("spectral.degrees") == 1
    assert names.count("spectral.sweep") == 7
    assert sum(r.counters["spectral.sweeps"] for r in recs
               if r.name == "spectral.sweeps") == 7
    assert names.count("spectral.ritz") == 7
    assert all(r.counters is None and r.end_ns >= r.start_ns for r in recs
               if r.name.startswith("spectral.") and r.name != "spectral.sweeps")
