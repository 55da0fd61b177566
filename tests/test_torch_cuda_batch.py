"""The batch engine and the blocked clustering family on a CUDA device
against the same code on the CPU.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_batch.py

Tolerances: blocked DBSCAN labels bit-equal to the CPU's dense DBSCAN
(fixtures clear of eps by 1e-4 relative); the card's Borůvka HDBSCAN equal
in partition to the CPU's host Prim; blocked spectral degrees bit-equal to
the CPU's (sums of 0/1 entries), its Ritz values within 1e-4 of the CPU's
with the same probe, and the same partition as the CPU on separated blobs;
the batch engine and the huge-window sSpectral / DBSCAN_centr through their
entry points with exact kernel launch counts and metrics in [0, 1].
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from mused_tpu_torch import api
from mused_tpu_torch.data.synthetic import make_stream
from mused_tpu_torch.engine import batch
from mused_tpu_torch.ops import blocked_affinity as ba
from mused_tpu_torch.ops import blocked_dbscan, blocked_hdbscan, blocked_spectral, dbscan
from mused_tpu_torch.ops import kmeans
from mused_tpu_torch.ops.kernels import affinity_kernel as ak
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.utils.config import PipelineConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the batch engine's device paths run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _uniform_clear(seed, eps, n=2500, d=3):
    """Uniform points with no pair within 1e-4 relative of eps."""
    while True:
        x = np.random.default_rng(seed).uniform(-6, 6, size=(n, d)).astype(np.float32)
        dist = np.sqrt(((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1))
        if not np.any(np.abs(dist - eps) <= 1e-4 * eps):
            return x
        seed += 1000


def _blobs(seed, n, k, d, spread=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 8
    return np.concatenate([c + rng.normal(size=(n // k, d)) * spread
                           for c in centers]).astype(np.float32)


def _same_partition(a, b) -> bool:
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [512, 700])
def test_blocked_dbscan_on_the_card_equals_dense_dbscan(cuda, block):
    x = _uniform_clear(0, 0.7)
    want = dbscan.dbscan(x, 0.7, 4, device="cpu")
    np.testing.assert_array_equal(blocked_dbscan.dbscan_blocked(x, 0.7, 4, block=block,
                                                                device=cuda), want)


@pytest.mark.cuda
def test_boruvka_on_the_card_equals_prim(cuda, monkeypatch):
    """Also through ``dbscan.hdbscan``'s route: above the (lowered) cap a
    card runs the Borůvka sweeps."""
    x = np.concatenate([_blobs(1, 600, 4, 5), np.random.default_rng(1).uniform(
        -15, 15, size=(30, 5)).astype(np.float32)])
    want = dbscan.hdbscan(x, 5, 3, device="cpu")
    got = blocked_hdbscan.hdbscan_blocked(x, 5, 3, block=256, device=cuda)
    assert _same_partition(got, want)
    calls = []
    orig = blocked_hdbscan.hdbscan_blocked

    def spy(*a, **kw):
        calls.append(kw["device"])
        return orig(*a, **kw)

    monkeypatch.setattr(blocked_hdbscan, "hdbscan_blocked", spy)
    monkeypatch.setattr(dbscan, "_PRIM_DENSE_CAP", 256)
    assert _same_partition(dbscan.hdbscan(x, 5, 3, device=cuda), want)
    assert len(calls) == 1 and torch.device(calls[0]).type == "cuda"


@pytest.mark.cuda
def test_blocked_spectral_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """The CPU's and the card's generators draw different numbers, so both
    runs take k-means++ centres drawn on the CPU from the same seed."""
    orig = kmeans.kmeans

    def same_draws(x, k, generator=None, *, k_max, **kw):
        init = kmeans.kmeanspp_init(x.cpu(), k_max, int(k), torch.Generator().manual_seed(7))
        return orig(x, k, generator, k_max=k_max, init=init.to(x.device), **kw)

    monkeypatch.setattr(kmeans, "kmeans", same_draws)
    x = _blobs(2, 1024, 4, 6)
    cpu = ba.generic_columns([x], ("default",), "cpu")
    card = ba.generic_columns([x], ("default",), cuda)
    kw = dict(block=256, k_basis=8)
    deg = blocked_spectral._degrees(cpu, **kw)
    assert torch.equal(blocked_spectral._degrees(card, **kw).cpu(), deg)
    probe = torch.randn((1024, 12), generator=torch.Generator().manual_seed(0))
    inv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)), 0.0)
    runs = []
    for cols, dev in ((cpu, "cpu"), (card, cuda)):
        runs.append(blocked_spectral.ritz_from_products(
            lambda v, cols=cols: blocked_spectral._sym_matmul(cols, v, **kw), inv.to(dev),
            None, n=1024, m=12, probe=probe.to(dev)))
    np.testing.assert_allclose(runs[1][1].cpu().numpy(), runs[0][1].numpy(), rtol=0,
                               atol=1e-4)
    # labels where 6 iterations converge (3 blobs of 64 rows; at 4 x 256 the
    # top Ritz values sit near 0.97, not yet at the four 1s)
    x = _blobs(0, 192, 3, 6)
    labels = [blocked_spectral.spectral_clustering_blocked(
        ba.generic_columns([x], ("default",), dev), 3,
        torch.Generator(device=dev).manual_seed(0), k_max=3, block=64, k_basis=8).cpu().numpy()
        for dev in ("cpu", cuda)]
    assert _same_partition(*labels)
    assert _same_partition(labels[0], np.repeat(np.arange(3), 64))


BATCH_KW = dict(reduced_dim=16, k_basis=10, n_clusters=2, seed=0, noise_rate=0.5,
                label_mode="binary", sorting=True, eps=1.5, min_samples=2,
                min_cluster_size=3, window_size=64)


@pytest.mark.cuda
@pytest.mark.parametrize("approach", ["SVDMC_batch", "DBSCAN_batch", "HDBSCAN_batch",
                                      "Spectral_batch"])
def test_batch_engine_on_the_card(cuda, approach):
    """4,096 records: the dense path (4 K1 launches, no K2) and the forced
    blocked path on the binned route (2 blocks; 6 sweeps of the blocked SVD,
    8 of blocked spectral; 2 K2 and 1 K3 per block per sweep, no K1)."""
    mods, mtypes, labels = make_stream(4096, noise_rate=0.5, seed=3)
    for forced in (False, True):
        cfg = PipelineConfig(approach=approach, reduced_dim=16, k_basis=10,
                             force_blocked_batch=forced)
        ak.reset_launches()
        bs.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            res = api.process_batch_data(api.get_initial_results()[0], mods, mtypes,
                                         approach=approach, complete_true_labels=labels,
                                         cfg=cfg, **BATCH_KW)
        torch.cuda.synchronize()
        sweeps = 8 if approach == "Spectral_batch" else 6
        want = (0, 2 * 2 * sweeps, 2 * sweeps) if forced else (4, 0, 0)
        assert (ak.launches, bs.launches, bs.pair_launches) == want, (forced, approach)
        vals = [res[k][0] for k in ("nmi_score", "f1_score", "f1_aligned")]
        assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals), vals


@pytest.mark.cuda
@pytest.mark.parametrize("approach", ["sSpectral", "DBSCAN_centr"])
def test_huge_window_spectral_and_dbscan_centr_on_the_card(cuda, approach):
    """Two forced huge windows of 4,096 rows (2 blocks each) through
    ``process_streaming_data``: blocked spectral's 8 sweeps or the blocked
    SVD's 6, each 2 K2 and 1 K3 per block, and no K1."""
    mods, mtypes, labels = make_stream(8192, noise_rate=0.5, seed=4)
    cfg = PipelineConfig(window_size=4096, reduced_dim=16, k_basis=10, approach=approach,
                         n_clusters_override=2, force_blocked_window=True,
                         k_estimate="eigengap" if approach == "sSpectral" else "labels")
    ak.reset_launches()
    bs.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        res = api.process_streaming_data(
            api.get_initial_results()[0], mods, mtypes, window_size=4096, reduced_dim=16,
            k_basis=10, n_clusters_total=2, seed=0, approach=approach,
            complete_true_labels=labels, step_window_ratio=1, noise_rate=0.5,
            label_mode="binary", sorting=True, eps=1.5, min_samples=2, cfg=cfg)
    torch.cuda.synchronize()
    sweeps = 8 if approach == "sSpectral" else 6
    assert (ak.launches, bs.launches, bs.pair_launches) == (0, 2 * 2 * 2 * sweeps,
                                                            2 * 2 * sweeps)
    vals = [res[k][0] for k in ("nmi_score", "f1_score", "f1_aligned")]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals), vals
