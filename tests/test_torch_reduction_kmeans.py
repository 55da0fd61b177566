"""Port's randomized SVD, eigengap and k-means vs the JAX package.

Tolerances: with the JAX test matrix ``omega`` injected, singular values and
the Gram of ``svd_reduce``'s output agree to rtol 1e-4; ``eigengap_k`` is
exact; k-means on separated blobs reaches NMI >= 0.99 between the two
sides (their k-means++ draws differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import kmeans as jkm
from mused_tpu.ops import reduction as jred
from mused_tpu.utils.metrics import nmi
from mused_tpu_torch.ops import kmeans as tkm
from mused_tpu_torch.ops import reduction as tred
from torch_parity import n, t

RTOL = 1e-4


def _low_rank(rng, rows, d, rank=5):
    a = rng.normal(size=(rows, rank)) * np.geomspace(20, 2, rank)
    return (a @ rng.normal(size=(rank, d)) + 0.01 * rng.normal(size=(rows, d))).astype(np.float32)


def test_randomized_svd_matches_jax_with_injected_omega(rng):
    x = _low_rank(rng, 60, 40)
    key = jax.random.key(3)
    rank = 5
    omega = jax.random.normal(key, (40, min(rank + 10, 40)), jnp.float32)
    ju, js, _ = jred.randomized_svd(jnp.asarray(x), rank, key)
    tu, ts, _ = tred.randomized_svd(t(x), rank, omega=t(omega))
    np.testing.assert_allclose(n(ts), n(js), rtol=RTOL)
    jr, tr = n(ju) * n(js), n(tu) * n(ts)
    np.testing.assert_allclose(tr @ tr.T, jr @ jr.T, rtol=RTOL, atol=RTOL * np.abs(jr).max() ** 2)


@pytest.mark.parametrize("rows,d,reduced_dim", [(64, 64, 8), (5, 200, 12)])
def test_svd_reduce_gram_and_static_shape(rows, d, reduced_dim, rng):
    x = (rng.random((rows, d)) < 0.2).astype(np.float32)
    key = jax.random.key(1)
    r = min(reduced_dim, d - 1)
    omega = jax.random.normal(key, (d, min(r + 10, min(rows, d))), jnp.float32)
    want = n(jred.svd_reduce(jnp.asarray(x), reduced_dim, key))
    got = n(tred.svd_reduce(t(x), reduced_dim, omega=t(omega)))
    assert got.shape == want.shape == (rows, reduced_dim)
    np.testing.assert_allclose(got @ got.T, want @ want.T, rtol=RTOL,
                               atol=RTOL * np.abs(want @ want.T).max())


@pytest.mark.parametrize("energies,k_max", [
    ([100, 60, 55, 20, 18, 16, 0, 0, 0], 8),    # pad-tail artifact must not win
    ([100, 95, 90, 10, 9, 8, 7, 6], 6),
    ([100, 40, 39, 38, 37, 36, 35], 6),          # Perron gap only
    ([50, 49, 48, 47, 46, 45, 44, 43, 42, 41], 9),
    ([100, 0, 0, 0], 3),
])
def test_eigengap_k_exact(energies, k_max):
    rng = np.random.default_rng(5)
    q = np.linalg.qr(rng.normal(size=(40, len(energies))))[0]
    reduced = (q * np.sqrt(np.asarray(energies, np.float64))).astype(np.float32)
    want = int(jred.eigengap_k(jnp.asarray(reduced), k_max=k_max))
    got = int(tred.eigengap_k(t(reduced), k_max=k_max))
    assert got == want


def _blobs(rng, k=4, per=60, d=6):
    centers = rng.normal(size=(k, d)) * 10
    x = np.concatenate([c + rng.normal(size=(per, d)) for c in centers]).astype(np.float32)
    return x, np.repeat(np.arange(k), per)


@pytest.mark.parametrize("k,k_max", [(4, 4), (3, 6)])
def test_kmeans_agrees_with_jax_on_separated_blobs(k, k_max, rng):
    x, truth = _blobs(rng, k=k)
    jl, _ = jkm.kmeans(jnp.asarray(x), jnp.int32(k), jax.random.key(0), k_max=k_max)
    gen = torch.Generator().manual_seed(0)
    tl, cents = tkm.kmeans(t(x), k, gen, k_max=k_max)
    assert nmi(n(jl), n(tl)) >= 0.99
    assert nmi(truth, n(tl)) >= 0.99
    assert n(tl).max() < k and cents.shape == (k_max, x.shape[1])


def test_kmeans_relocates_an_empty_cluster(rng):
    x, _ = _blobs(rng, k=3)
    init = np.array([x[0], x[70], [1e6] * x.shape[1]], np.float32)   # 3rd starts empty
    labels, _ = tkm.kmeans(t(x), 3, None, k_max=3, init=t(init))
    assert len(np.unique(n(labels))) == 3


def test_minibatch_matches_jax_on_blobs(rng):
    x, truth = _blobs(rng, k=3)
    jst = jkm.minibatch_init(3, x.shape[1])
    tst = tkm.minibatch_init(3, x.shape[1], "cpu")
    gen = torch.Generator().manual_seed(0)
    for w in range(2):
        perm = rng.permutation(len(x))
        jst, jl = jkm.minibatch_step(jst, jnp.asarray(x[perm]), jax.random.key(w))
        tst, tl = tkm.minibatch_step(tst, t(x[perm]), gen)
        assert nmi(n(jl), n(tl)) >= 0.99
        assert nmi(truth[perm], n(tl)) >= 0.99
    assert tst.initialized and float(tst.counts.sum()) == 2 * len(x)


def test_mark_background_waits_for_the_serving_slice():
    """The serving slice has come: the background bucket runs and, on a
    degenerate window (zero rows, one cluster), flags nothing, as the JAX
    package does (tests/test_torch_spectral.py holds it bit-equal on real
    fixtures)."""
    got = tkm.mark_background(torch.zeros((4, 2)), torch.zeros(4), k_max=2)
    want = jkm.mark_background(jnp.zeros((4, 2)), jnp.zeros(4, jnp.int32), k_max=2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_kmeanspp_init_draws_only_the_live_centres(rng):
    """Centres past the live count are zero, and the live ones are the draws
    a k_max = k seeding makes from the same generator."""
    x = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    wide = tkm.kmeanspp_init(x, 8, torch.tensor(3), torch.Generator().manual_seed(4))
    narrow = tkm.kmeanspp_init(x, 3, 3, torch.Generator().manual_seed(4))
    assert wide.shape == (8, 3) and torch.equal(wide[:3], narrow)
    assert torch.all(wide[3:] == 0)
