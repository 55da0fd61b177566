"""The port's blocked spectral clustering vs the JAX package's
``ops/blocked_spectral``, on the CPU.

Both sides get the same column panels (the JAX Columns carried over with
``columns_from_jax``), so the sweeps, not the frameworks' last-ulp trig,
are compared.  Tolerances:
  * ``_degrees``: bit-equal (sums of 0/1 entries are exact in float32);
  * ``_sym_matmul``: within 1e-5 relative to the largest entry (true fp32
    products summed in another order);
  * the Ritz values, with the JAX probe injected: within 1e-4 (the port's
    Ritz ``eigh`` runs in float64, the JAX package's in float32);
  * labels with the JAX probe and k-means++ draws injected: bit-equal (the
    NJW rows do not depend on the Ritz vectors' signs);
  * against the port's dense spectral clustering: the same partition, with
    and without padding rows.
Each is checked on the strip route and on the binned route (the candidate
kernels' plain versions on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.data import features as jfeat
from mused_tpu.ops import blocked_affinity as jba
from mused_tpu.ops import blocked_spectral as jbspec
from mused_tpu.ops import kmeans as jkm
from mused_tpu.utils.config import FeatureConfig
from mused_tpu_torch.ops import affinity as taff
from mused_tpu_torch.ops import blocked_affinity as tba
from mused_tpu_torch.ops import blocked_spectral as tbspec
from mused_tpu_torch.ops import kmeans as tkm
from mused_tpu_torch.ops import spectral as tspec
from mused_tpu_torch.utils.convert import columns_from_jax
from torch_parity import n as tonp, synthetic_window_stream, t

N, BLOCK, K = 256, 64, 5
NBINS = N // 2
ROUTES = [dict(select="strip", nbins=0), dict(select="binned", nbins=NBINS)]


@pytest.fixture(scope="module")
def jcols():
    mods, _, _ = synthetic_window_stream(n_rows=N + 64, subset=N, seed=0)
    return jba.standard_columns(jfeat.featurize_window(*mods, FeatureConfig()),
                                FeatureConfig())


@pytest.fixture(scope="module")
def tcols(jcols):
    return columns_from_jax(jax.tree_util.tree_map(np.asarray, jcols), "cpu")


def _jkw(jcols, route):
    return dict(kinds=jcols.kinds, block=BLOCK, k_basis=K, **route)


def _same_partition(a, b) -> bool:
    """Equal up to a renaming of the labels."""
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("route", ROUTES, ids=["strip", "binned"])
def test_degrees_and_sym_matmul_match_jax(route, jcols, tcols):
    want = np.asarray(jbspec._degrees(jcols.tensors, jcols.valids, jcols.idf,
                                      **_jkw(jcols, route)))
    got = tonp(tbspec._degrees(tcols, block=BLOCK, k_basis=K, **route))
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    v = np.random.default_rng(1).normal(size=(N, 9)).astype(np.float32)
    want = np.asarray(jbspec._sym_matmul(jcols.tensors, jcols.valids, jcols.idf,
                                         jnp.asarray(v), **_jkw(jcols, route)))
    got = tonp(tbspec._sym_matmul(tcols, t(v), block=BLOCK, k_basis=K, **route))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _inject_probe(monkeypatch, key):
    orig = tbspec.ritz_from_products

    def ritz(sym_matmul, inv_sqrt, generator, *, n, m, n_iter=6, probe=None):
        probe = t(np.asarray(jax.random.normal(key, (n, m), jnp.float32)))
        return orig(sym_matmul, inv_sqrt, generator, n=n, m=m, n_iter=n_iter, probe=probe)

    monkeypatch.setattr(tbspec, "ritz_from_products", ritz)


def _inject_kmeanspp(monkeypatch, key):
    orig = tkm.kmeans

    def kmeans(x, k, generator=None, *, k_max, **kw):
        init = jkm._kmeanspp_init(jnp.asarray(tonp(x)), k_max, jnp.int32(int(k)), key)
        return orig(x, k, generator, k_max=k_max, init=t(np.asarray(init)), **kw)

    monkeypatch.setattr(tkm, "kmeans", kmeans)


@pytest.mark.parametrize("route", ROUTES, ids=["strip", "binned"])
def test_ritz_values_match_jax_with_the_probe_injected(route, jcols, tcols, monkeypatch):
    key = jax.random.key(4)
    ritz_j, lam_j = jbspec.spectral_embedding_blocked(jcols, key, k_max=4, block=BLOCK,
                                                      k_basis=K, **route)
    _inject_probe(monkeypatch, key)
    ritz_t, lam_t = tbspec.spectral_embedding_blocked(tcols, None, k_max=4, block=BLOCK,
                                                      k_basis=K, **route)
    assert ritz_t.shape == tuple(ritz_j.shape) == (N, 12)
    np.testing.assert_allclose(tonp(lam_t), np.asarray(lam_j), rtol=0, atol=1e-4)
    assert np.all(np.diff(tonp(lam_t)) <= 0)
    # the leading Ritz vectors agree up to sign
    for c in range(3):
        a, b = tonp(ritz_t)[:, c], np.asarray(ritz_j)[:, c]
        assert abs(abs(float(a @ b)) - 1.0) < 1e-3


@pytest.mark.parametrize("route", ROUTES, ids=["strip", "binned"])
def test_labels_bit_equal_with_the_draws_injected(route, jcols, tcols, monkeypatch):
    key = jax.random.key(2)
    want = np.asarray(jbspec.spectral_clustering_blocked(
        jcols, 3, key, k_max=4, block=BLOCK, k_basis=K, n_real=N - 40, **route))
    _inject_probe(monkeypatch, key)
    _inject_kmeanspp(monkeypatch, key)
    got = tonp(tbspec.spectral_clustering_blocked(tcols, 3, None, k_max=4, block=BLOCK,
                                                  k_basis=K, n_real=N - 40, **route))
    assert got.shape == want.shape == (N - 40,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("background", [False, True])
def test_labels_from_ritz_bit_equal(background, jcols, monkeypatch):
    """The NJW tail on the same Ritz basis, with a () count as eigengap
    gives it and with the background bucket."""
    key = jax.random.key(6)
    ritz, lam = jbspec.spectral_embedding_blocked(jcols, key, k_max=6, block=BLOCK,
                                                  k_basis=K)
    k = jbspec.eigengap_k_from_spectrum(lam, k_max=6)
    assert int(tbspec.eigengap_k_from_spectrum(t(np.asarray(lam)), k_max=6)) == int(k)
    want = np.asarray(jbspec.labels_from_ritz(ritz, k, key, k_max=6, n_real=N,
                                              background=background))
    _inject_kmeanspp(monkeypatch, key)
    got = tonp(tbspec.labels_from_ritz(t(np.asarray(ritz)), torch.tensor(int(k)), None,
                                       k_max=6, n_real=N, background=background))
    np.testing.assert_array_equal(got, want)


def _blobs(seed, n, k, d, spread=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 8
    return np.concatenate([c + rng.normal(size=(n // k, d)) * spread
                           for c in centers]).astype(np.float32)


@pytest.mark.parametrize("route", ROUTES, ids=["strip", "binned"])
def test_same_partition_as_the_dense_spectral(route):
    """tests/test_blocked_spectral.py's fixture on the port alone: blocked
    spectral of the default-kind columns against dense spectral of the
    Euclidean kNN graph (k_basis - 1 neighbours besides self on both)."""
    x = _blobs(0, 192, 3, 6)
    gen = torch.Generator().manual_seed(0)
    want = tonp(tspec.spectral_clustering(taff.euclidean_adjacency(t(x), 8), 3, gen,
                                          k_max=3))
    cols = tba.generic_columns([x], ("default",), "cpu")
    got = tonp(tbspec.spectral_clustering_blocked(
        cols, 3, torch.Generator().manual_seed(0), k_max=3, block=64, k_basis=8,
        select=route["select"], nbins=96 if route["nbins"] else 0))
    assert _same_partition(got, want) and len(set(want.tolist())) == 3


def test_padding_rows_do_not_distort():
    """150 rows padded with invalid (NaN) rows to 192 = 3 blocks: the padding
    has zero degree and is sliced off before k-means."""
    x = _blobs(1, 150, 3, 4)
    xp = np.pad(x, ((0, 42), (0, 0)), constant_values=np.nan)
    cols = tba.generic_columns([xp], ("default",), "cpu")
    deg = tonp(tbspec._degrees(cols, block=64, k_basis=8))
    assert np.all(deg[150:] == 0) and np.all(deg[:150] > 0)
    got = tonp(tbspec.spectral_clustering_blocked(
        cols, 3, torch.Generator().manual_seed(1), k_max=3, block=64, k_basis=8, n_real=150))
    assert got.shape == (150,)
    assert _same_partition(got, np.repeat(np.arange(3), 50))
    with pytest.raises(ValueError, match="divide"):
        tbspec.spectral_embedding_blocked(cols, None, k_max=3, block=100, k_basis=8)
    with pytest.raises(ValueError, match="divide"):
        next(tba.scan_blocks(cols, 100, 8))
