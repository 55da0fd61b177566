"""The port's spectral clustering and background bucket vs the JAX package's
``ops/spectral`` and ``ops/kmeans.mark_background``, on the CPU.

  * The normalized spectrum (an ``eigh``) agrees within 2e-6 absolute on
    every eigenvalue.  Eigenvectors are not compared: their signs, and the
    rotation inside a repeated eigenvalue (one per connected component),
    differ between LAPACK builds.
  * ``eigengap_k_from_spectrum`` on the same eigenvalues gives the same
    count.
  * ``_njw_embedding`` on the same eigenvectors agrees within 1 ulp of its
    unit rows (1.2e-7 absolute): XLA fuses the row norm's multiply-add into
    its reduction and picks, by row width, whether to use FMA, so no single
    torch order matches every width.
  * ``spectral_clustering`` with the JAX side's eigenvectors and k-means++
    draws injected gives the same labels, given and eigengap counts, with
    and without the background bucket.
  * ``mark_background`` gives the same labels as the JAX package on
    ``tests/test_background.py``'s planted-far-mode and clean-window
    fixtures, on a raw crisis-stream embedding, and on one-row and zero-row
    inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import affinity as jaff
from mused_tpu.ops import kmeans as jkm
from mused_tpu.ops import spectral as jspec
from mused_tpu_torch.data import synthetic as tsyn
from mused_tpu_torch.ops import kmeans as tkm
from mused_tpu_torch.ops import spectral as tspec
from torch_parity import n, t


def _knn_graph(seed, k=6, per=30, centres=((0, 0), (5, 5), (0, 5)), spread=0.4):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(size=(per, 2)) * spread + c for c in centres])
    return np.asarray(jaff.euclidean_adjacency(jnp.asarray(pts.astype(np.float32)), k))


GRAPHS = [(0, dict()), (1, dict(spread=1.2)), (2, dict(per=20, k=4)),
          (3, dict(centres=((0, 0), (4, 0), (8, 0), (0, 4), (4, 4))))]


@pytest.mark.parametrize("seed,kw", GRAPHS)
def test_normalized_spectrum_matches_jax(seed, kw):
    adj = _knn_graph(seed, **kw)
    lam_j, _ = jspec._normalized_spectrum(jnp.asarray(adj))
    lam_t, vecs_t = tspec._normalized_spectrum(t(adj))
    np.testing.assert_allclose(n(lam_t), n(lam_j), rtol=0, atol=2e-6)
    assert np.all(np.diff(n(lam_t)) <= 0)                    # descending
    # the vectors are an orthonormal eigenbasis of the same operator
    a = (adj + adj.T) * 0.5
    np.fill_diagonal(a, 0)
    d = a.sum(1)
    inv = np.where(d > 0, 1 / np.sqrt(np.maximum(d, 1e-12)), 0)
    norm = a * inv[:, None] * inv[None, :]
    v = n(vecs_t).astype(np.float64)
    np.testing.assert_allclose(norm @ v, v * n(lam_t)[None, :], atol=1e-5)


@pytest.mark.parametrize("seed,kw", GRAPHS)
def test_eigengap_count_bit_equal(seed, kw):
    lam = np.asarray(jspec._normalized_spectrum(jnp.asarray(_knn_graph(seed, **kw)))[0])
    for k_max in (2, 3, 4, 5, 8, 16):
        want = jspec.eigengap_k_from_spectrum(jnp.asarray(lam), k_max=k_max)
        got = tspec.eigengap_k_from_spectrum(t(lam), k_max=k_max)
        assert got.dtype == torch.int32 and int(got) == int(want), k_max
    flat = np.ones(10, np.float32)                  # every mu at the floor: k = 1
    assert int(tspec.eigengap_k_from_spectrum(t(flat), k_max=4)) == int(
        jspec.eigengap_k_from_spectrum(jnp.asarray(flat), k_max=4)) == 1


@pytest.mark.parametrize("seed,kw", GRAPHS[:2])
def test_njw_embedding_matches_jax(seed, kw):
    vecs = np.asarray(jspec._normalized_spectrum(jnp.asarray(_knn_graph(seed, **kw)))[1])
    for n_comp, cap in [(1, 4), (2, 4), (3, 4), (4, 4), (3, 8), (5, 6)]:
        want = np.asarray(jspec._njw_embedding(jnp.asarray(vecs), jnp.int32(n_comp), cap))
        got = n(tspec._njw_embedding(t(vecs), n_comp, cap))
        assert got.shape == want.shape == (len(vecs), cap)
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23)
        assert np.all(got[:, n_comp:] == 0)
    # a cap wider than the vectors pads with zero columns
    got = n(tspec._njw_embedding(t(vecs[:, :3]), 3, 5))
    assert got.shape == (len(vecs), 5) and np.all(got[:, 3:] == 0)


@pytest.mark.parametrize("k_source", ["given", "eigengap"])
@pytest.mark.parametrize("background", [False, True])
def test_spectral_clustering_bit_equal_with_injected_vectors(k_source, background,
                                                              monkeypatch):
    adj = _knn_graph(0, spread=0.9)
    key = jax.random.key(5)
    k_max = 6
    want = np.asarray(jspec.spectral_clustering(jnp.asarray(adj), jnp.int32(3), key,
                                                k_max=k_max, k_source=k_source,
                                                background=background))
    lam, vecs = jspec._normalized_spectrum(jnp.asarray(adj))
    monkeypatch.setattr(tspec, "_normalized_spectrum",
                        lambda a: (t(np.asarray(lam)), t(np.asarray(vecs))))
    orig = tkm.kmeans

    def kmeans(x, k, generator=None, *, k_max, **kw):
        init = jkm._kmeanspp_init(jnp.asarray(n(x)), k_max, jnp.int32(int(k)), key)
        return orig(x, k, generator, k_max=k_max, init=t(np.asarray(init)), **kw)

    monkeypatch.setattr(tkm, "kmeans", kmeans)
    got = n(tspec.spectral_clustering(t(adj), 3, None, k_max=k_max, k_source=k_source,
                                      background=background))
    np.testing.assert_array_equal(got, want)


def test_spectral_clustering_cuts_two_cliques():
    a = np.zeros((40, 40), np.float32)
    a[:20, :20] = a[20:, 20:] = 1.0
    np.fill_diagonal(a, 0)
    labels = n(tspec.spectral_clustering(t(a), 2, torch.Generator().manual_seed(0),
                                         k_max=2))
    assert len(set(labels[:20])) == len(set(labels[20:])) == 1 and labels[0] != labels[20]
    emb = n(tspec.spectral_embedding(t(a), 2, max_components=4))
    assert emb.shape == (40, 4) and np.all(emb[:, 2:] == 0)


def _sphere_clusters(rng, k=4, per=60, d=8, spread=0.02):
    """tests/test_background.py's fixture: tight unit-norm clusters."""
    dirs = rng.normal(size=(k, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    x = np.repeat(dirs, per, axis=0) + rng.normal(size=(k * per, d)) * spread
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), np.repeat(np.arange(k), per)


def _both(x, labels, k_max):
    want = np.asarray(jkm.mark_background(jnp.asarray(x), jnp.asarray(labels, jnp.int32),
                                          k_max=k_max))
    got = n(tkm.mark_background(t(x), t(labels), k_max=k_max))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


def test_mark_background_planted_far_mode_bit_equal():
    rng = np.random.default_rng(0)
    x, labels = _sphere_clusters(rng)
    noise = rng.normal(size=(40, x.shape[1]))
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    xa = np.concatenate([x, noise.astype(np.float32)])
    la = np.concatenate([labels, np.zeros(40, np.int64)])
    out = _both(xa, la, 6)
    assert (out[len(x):] == -1).mean() > 0.8 and (out[:len(x)] == -1).mean() < 0.05


def test_mark_background_clean_window_bit_equal():
    x, labels = _sphere_clusters(np.random.default_rng(1))
    out = _both(x, labels, 6)
    assert not np.any(out == -1)


def test_mark_background_raw_embedding_and_edges():
    mods, _, truth = tsyn.crisis_embedding_stream(n_rows=300, n_events=4, noise_rate=0.3,
                                                  d_text=16, d_image=16, seed=2)
    x = np.concatenate(mods, axis=1)
    labels = np.where(truth > 0, truth - 1, 0)       # noise forced into event 0
    _both(x, labels, 5)
    _both(x[:1], labels[:1], 5)                      # one row: nothing to split
    _both(np.zeros((12, 4), np.float32), np.zeros(12, np.int64), 2)   # zero rows
