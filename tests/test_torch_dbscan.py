"""The port's DBSCAN family vs the JAX package's ``ops/dbscan``, on the CPU.

DBSCAN's verdict on a pair is ``d2 <= eps**2`` on expanded-norm products,
which can flip between two BLAS builds for a pair within an ulp of eps
(``mused_tpu/ops/dbscan.py:59-60``).  Every fixture here is checked to hold
no pair within 1e-4 relative of eps, and then the labels must be bit-equal:

  * ``dbscan_labels`` / ``dbscan`` and ``hdbscan`` (host numpy, copied),
    and ``hdbscan``'s route to the device Borůvka above its cap on a card;
  * ``IncrementalDBSCAN``'s chunked inserts against the JAX package's and
    against batch ``dbscan`` over the union;
  * its snapshot round trip, and a JAX snapshot restored into the port;
  * ``match_centroids`` / ``dbscan_centroid_incremental`` over 3 windows;
  * the native union-find core (built here with the host compiler) against
    the re-clustering fallback.
"""
import numpy as np
import pytest
import torch

from mused_tpu import api as japi
from mused_tpu.ops import dbscan as jdb
from mused_tpu_torch import api as tapi
from mused_tpu_torch import native as tnative
from mused_tpu_torch.ops import blocked_hdbscan as tbh
from mused_tpu_torch.ops import dbscan as tdb


def _clear_of_eps(x, eps, rel=1e-4):
    d = np.sqrt(((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1))
    assert not np.any(np.abs(d - eps) <= rel * eps), "a pair sits at eps"
    return x


def blobs(rng, k=3, n_per=40, d=4, spread=0.08, with_noise=8):
    centers = rng.normal(size=(k, d)) * 6
    pts = np.concatenate([c + rng.normal(size=(n_per, d)) * spread for c in centers])
    if with_noise:
        pts = np.concatenate([pts, rng.uniform(-12, 12, size=(with_noise, d))])
    return pts.astype(np.float32)


def _uniform(seed, eps, n=300, d=3):
    """Uniform points clear of eps: the first clear draw from ``seed`` on."""
    while True:
        x = np.random.default_rng(seed).uniform(-4, 4, size=(n, d)).astype(np.float32)
        try:
            return _clear_of_eps(x, eps)
        except AssertionError:
            seed += 1000


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbscan_bit_equal(seed):
    x = _clear_of_eps(blobs(np.random.default_rng(seed)), 1.0)
    got = tdb.dbscan(x, eps=1.0, min_samples=3, device="cpu")
    want = jdb.dbscan(x, eps=1.0, min_samples=3)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # a tensor keeps its own device
    np.testing.assert_array_equal(tdb.dbscan(torch.from_numpy(x), 1.0, 3), want)


def n_(x):
    return x.cpu().numpy()


@pytest.mark.parametrize("seed", [3, 4])
def test_dbscan_bit_equal_on_long_chains(seed):
    """Uniform points at a small eps: long, branching core chains (many
    propagation steps) and many border points."""
    x = _uniform(seed, 0.9)
    np.testing.assert_array_equal(tdb.dbscan(x, 0.9, 4, device="cpu"),
                                  jdb.dbscan(x, 0.9, 4))
    line = np.stack([np.arange(50, dtype=np.float32) * 0.9, np.zeros(50, np.float32)], 1)
    assert (tdb.dbscan(line, eps=1.0, min_samples=2, device="cpu") == 0).all()
    far = np.array([[0.0, 0], [10, 0], [0, 10]], np.float32)
    assert (tdb.dbscan(far, eps=1.0, min_samples=2, device="cpu") == -1).all()


@pytest.mark.parametrize("seed,mcs,ms", [(0, 5, 3), (1, 5, 3), (2, 4, 2), (3, 8, 1)])
def test_hdbscan_bit_equal(seed, mcs, ms):
    rng = np.random.default_rng(seed)
    x = blobs(rng, k=3, n_per=50, with_noise=6)
    if seed == 2:                        # exact duplicates: zero-weight MST edges
        x[:10] = x[0]
    got = tdb.hdbscan(x, mcs, ms, device="cpu")
    np.testing.assert_array_equal(got, jdb.hdbscan(x, mcs, ms))
    assert tdb.hdbscan(x[:0], device="cpu").shape == (0,)
    assert list(tdb.hdbscan(x[:1], device="cpu")) == [-1]


def test_hdbscan_above_the_dense_cap_waits_for_the_batch_slice(monkeypatch):
    """The batch slice has come: above ``_PRIM_DENSE_CAP`` rows a CUDA
    device takes the device Borůvka (``blocked_hdbscan``) instead of
    raising; the CPU stays on host Prim.  The cap is lowered here so the
    route shows at a small size; the spy stands in for the card's run."""
    x = blobs(np.random.default_rng(7), with_noise=4)
    calls = []

    def spy(data, min_cluster_size=5, min_samples=2, block=2048, *, device="cuda"):
        calls.append((len(data), min_cluster_size, min_samples, torch.device(device).type))
        return np.zeros(len(data), np.int64)

    monkeypatch.setattr(tbh, "hdbscan_blocked", spy)
    monkeypatch.setattr(tdb, "_PRIM_DENSE_CAP", 64)
    assert (tdb.hdbscan(x, 5, 3, device="cuda") == 0).all()
    assert calls == [(len(x), 5, 3, "cuda")]
    np.testing.assert_array_equal(tdb.hdbscan(x, 5, 3, device="cpu"), jdb.hdbscan(x, 5, 3))
    np.testing.assert_array_equal(tdb.hdbscan(x[:64], 5, 3, device="cuda"),
                                  jdb.hdbscan(x[:64], 5, 3))       # at the cap: Prim
    assert len(calls) == 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_incremental_chunked_inserts_bit_equal(seed):
    x = _uniform(seed, 1.0)
    jinc = jdb.IncrementalDBSCAN(eps=1.0, min_pts=4)
    tinc = tdb.IncrementalDBSCAN(eps=1.0, min_pts=4, device="cpu")
    for i in range(0, 300, 60):
        jinc.insert(x[i:i + 60])
        tinc.insert(x[i:i + 60])
        np.testing.assert_array_equal(tinc.get_cluster_labels(x[:i + 60]),
                                      jinc.get_cluster_labels(x[:i + 60]))
    assert tinc._handle is not None          # the native core ran


def test_incremental_equals_batch_over_the_union():
    rng = np.random.default_rng(0)
    x = _clear_of_eps(blobs(rng, k=2, n_per=30, with_noise=4), 1.0)
    inc = tdb.IncrementalDBSCAN(eps=1.0, min_pts=3, device="cpu")
    first = inc.insert(x[:40]).get_cluster_labels(x[:40])
    assert len(first) == 40
    rest = inc.insert(x[40:]).get_cluster_labels(x[40:])
    batch = tdb.dbscan(x, eps=1.0, min_samples=3, device="cpu")
    np.testing.assert_array_equal(rest, batch[40:])
    np.testing.assert_array_equal(inc.get_cluster_labels(x), batch)
    with pytest.raises(ValueError, match="retained"):
        inc.get_cluster_labels(np.zeros((len(x) + 1, 4)))


def test_incremental_snapshot_round_trip_and_from_jax():
    x = _uniform(5, 1.0)
    inc = tdb.IncrementalDBSCAN(eps=1.0, min_pts=4, device="cpu")
    inc.insert(x[:150]).insert(x[150:220])
    back = tdb.IncrementalDBSCAN.from_snapshot(inc.snapshot(), device="cpu")
    np.testing.assert_array_equal(back.get_cluster_labels(x[:220]),
                                  inc.get_cluster_labels(x[:220]))
    np.testing.assert_array_equal(back.insert(x[220:]).get_cluster_labels(x),
                                  inc.insert(x[220:]).get_cluster_labels(x))
    jinc = jdb.IncrementalDBSCAN(eps=1.0, min_pts=4)
    jinc.insert(x[:100]).insert(x[100:200])
    ported = tdb.IncrementalDBSCAN.from_snapshot(jinc.snapshot(), device="cpu")
    np.testing.assert_array_equal(ported.insert(x[200:]).get_cluster_labels(x),
                                  jinc.insert(x[200:]).get_cluster_labels(x))
    # the legacy capped mode keeps its labels through the snapshot
    capped = tdb.IncrementalDBSCAN(eps=1.0, min_pts=4, max_buffer=64, device="cpu")
    capped.insert(x[:100])
    jcap = jdb.IncrementalDBSCAN(eps=1.0, min_pts=4, max_buffer=64)
    jcap.insert(x[:100])
    again = tdb.IncrementalDBSCAN.from_snapshot(capped.snapshot(), device="cpu")
    np.testing.assert_array_equal(again.get_cluster_labels(x[36:100]),
                                  jcap.get_cluster_labels(x[36:100]))


def test_centroid_matching_bit_equal_over_three_windows():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(3, 4)) * 6
    windows = []
    for order in ([0, 1, 2], [1, 2, 0], [2, 0]):
        w = np.concatenate([base[c] + rng.normal(size=(20, 4)) * 0.05 for c in order]
                           + [rng.uniform(-15, 15, size=(3, 4))]).astype(np.float32)
        windows.append(_clear_of_eps(w, 1.0))
    jstate, tstate = (None, None), (None, None)
    for w in windows:
        jl, jc, ju = jdb.dbscan_centroid_incremental(w, *jstate, eps=1.0, min_samples=3)
        tl, tc, tu = tdb.dbscan_centroid_incremental(w, *tstate, eps=1.0, min_samples=3,
                                                     device="cpu")
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tu, ju)
        jstate, tstate = (jc, ju), (tc, tu)
    labels = np.array([0, 0, 1, -1])
    got = tdb.match_centroids(windows[0][:4], labels, tstate[0], tstate[1])
    want = jdb.match_centroids(windows[0][:4], labels, jstate[0], jstate[1])
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert tdb.dbscan_centroid_incremental(np.zeros(3), None, None, device="cpu")[0] is None


def test_centroid_matching_bit_equal_with_thousands_of_clusters():
    """A huge window's DBSCAN_centr labelling: thousands of clusters, so the
    port groups rows by one stable sort and takes the distances to the
    previous centroids in several slabs; the same sums as the JAX package."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(20_000, 40)).astype(np.float32)
    first = rng.integers(-1, 2000, len(x))
    got = tdb.match_centroids(x, first, None, None)
    want = jdb.match_centroids(x, first, None, None)
    second = rng.integers(-1, 2500, len(x))
    for g, w_ in zip(tdb.match_centroids(x, second, got[1], got[2]),
                     jdb.match_centroids(x, second, want[1], want[2])):
        np.testing.assert_array_equal(g, w_)


def test_native_core_against_the_fallback(monkeypatch):
    assert tnative.incdb_available(), tnative.incdb_load_error
    x = _uniform(6, 1.0)
    before = tnative.incdb_calls
    native = tdb.IncrementalDBSCAN(eps=1.0, min_pts=4, device="cpu")
    for i in range(0, 300, 100):
        native.insert(x[i:i + 100])
    assert tnative.incdb_calls == before + 3
    monkeypatch.setattr(tnative, "_load_incdb", lambda: None)
    fallback = tdb.IncrementalDBSCAN(eps=1.0, min_pts=4, device="cpu")
    for i in range(0, 300, 100):
        fallback.insert(x[i:i + 100])
    assert fallback._handle is None
    ours, batch = native.get_cluster_labels(x), fallback.get_cluster_labels(x)
    np.testing.assert_array_equal(batch, jdb.dbscan(x, 1.0, 4))
    # the one permitted difference: a border point tied between clusters
    # joins its first core neighbour in discovery order (the native core)
    # or its minimum-labelled one (batch DBSCAN)
    within = ((x[:, None] - x[None]) ** 2).sum(-1) <= 1.0
    core = within.sum(1) >= 4
    np.testing.assert_array_equal(ours == -1, batch == -1)
    pairs = set(zip(ours[core].tolist(), batch[core].tolist()))
    assert len(pairs) == len({a for a, _ in pairs}) == len({b for _, b in pairs})
    for i in np.where(~core & (ours != -1))[0]:
        assert ours[i] in set(ours[within[i] & core].tolist())


def test_native_handle_rejects_malformed_pairs():
    h = tnative.IncDBHandle.create(2)
    assert h is not None
    with pytest.raises(ValueError):
        h.insert(2, np.array([0], np.int32), np.array([5], np.int32))
    h.insert(2, np.array([1], np.int32), np.array([0], np.int32))
    assert list(h.labels()) == [0, 0]


def test_nearest_within_order_is_lax_top_k():
    """Nearest first, lowest column on ties, -0.0 (whose negation is +0.0)
    above +0.0: ``lax.top_k(-d2)``'s order, which fixes the order the native
    core discovers each point's neighbours in."""
    import jax
    import jax.numpy as jnp
    d2 = np.array([[0.5, 0.0, -0.0, 0.5, np.inf, 0.25, 0.5]], np.float32)
    vals, idx = tdb.nearest_within(torch.from_numpy(d2), 6)
    jneg, jidx = jax.lax.top_k(-jnp.asarray(d2), 6)
    np.testing.assert_array_equal(n_(idx), np.asarray(jidx))
    np.testing.assert_array_equal(n_(vals), -np.asarray(jneg))


def test_api_names_match_the_reference():
    import inspect
    for name in ("perform_dbscan_clustering", "perform_hdbscan_clustering"):
        assert (inspect.signature(getattr(tapi, name)).parameters.keys()
                == inspect.signature(getattr(japi, name)).parameters.keys())
    assert tapi.IncrementalDBSCAN is tdb.IncrementalDBSCAN
