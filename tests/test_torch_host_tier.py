"""The port's copies of the host tier against their originals in the JAX
package, on seeded numpy inputs (all on the CPU):

  * ``data/features.featurize_window`` (dense and sparse layouts) with the
    Python hashers on both sides, and the port's native hasher against its
    Python fallbacks: bit-equal (both hash with CRC32);
  * ``ops/matching.match_clusters`` (Hungarian and Sinkhorn, with and
    without a previous window) and ``utils/metrics.compute_all_metrics``:
    equal;
  * ``utils/config``: ``PipelineConfig()`` / ``FeatureConfig()`` field for
    field, and ``APPROACHES``.
"""
import contextlib
import dataclasses
import io
import os
import shutil
import subprocess

import numpy as np
import pytest

from mused_tpu import native as jnative
from mused_tpu.data import features as jfeat
from mused_tpu.ops import matching as jmatch
from mused_tpu.utils import config as jconfig
from mused_tpu.utils import metrics as jmetrics
from mused_tpu_torch import native as tnative
from mused_tpu_torch.data import features as tfeat
from mused_tpu_torch.data.synthetic import make_stream
from mused_tpu_torch.ops import matching as tmatch
from mused_tpu_torch.utils import config as tconfig
from mused_tpu_torch.utils import metrics as tmetrics


@pytest.fixture(scope="module")
def window():
    """200 records of the port's synthetic stream, with the awkward cells
    the featurizer must survive: empty / missing text, empty-string, None
    and NaN tag cells, empty usernames."""
    mods, _, _ = make_stream(200, noise_rate=0.5, seed=3)
    loc, tim, users, tags, text = (np.array(m, dtype=m.dtype, copy=True) for m in mods)
    text[3, 0], text[3, 1] = "", None
    text[4, 0] = "A b CD e-f 12 3 ünï"
    tags[5, 0], tags[6, 0], tags[7, 0] = "", None, float("nan")
    tags[8, 0] = ["x", "", "x", "y"]
    users[9, 0] = ""
    return loc, tim, users, tags, text


@pytest.fixture
def python_hashers(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)


@pytest.mark.parametrize("sparse", [True, False])
def test_featurize_window_bit_equal(window, sparse, python_hashers):
    got = tfeat.featurize_window(*window, tconfig.FeatureConfig(sparse=sparse))
    want = jfeat.featurize_window(*window, jconfig.FeatureConfig(sparse=sparse))
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sparse", [True, False])
def test_native_hasher_matches_python(window, sparse, monkeypatch):
    """The port's C++ hasher (built here with the host compiler) against its
    Python fallbacks, through featurize_window."""
    assert tnative.available(), tnative.load_error
    before = tnative.calls
    cfg = tconfig.FeatureConfig(sparse=sparse)
    native = tfeat.featurize_window(*window, cfg)
    assert tnative.calls == before + 2
    monkeypatch.setattr(tnative, "_load", lambda: None)
    plain = tfeat.featurize_window(*window, cfg)
    for g, w in zip(native, plain):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def jax_native_hasher(tmp_path_factory):
    """The JAX package's hasher, built from its Makefile into a directory of
    this module's own.  Its loader runs ``make -B`` in place, writing the
    library while another test process may be opening it; a private build
    keeps that race away from these cases."""
    build_dir = tmp_path_factory.mktemp("jax_native")
    for name in ("Makefile", "hasher.cpp"):
        shutil.copy2(os.path.join(jnative._DIR, name), build_dir / name)
    make = subprocess.run(["make", "-C", str(build_dir), "-s", "libmused_hasher.so"],
                          capture_output=True, text=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_DIR", str(build_dir))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_failed", False)
        assert jnative.available(), (f"the JAX package's hasher did not load: make exited "
                                     f"{make.returncode}: {make.stdout}{make.stderr}")
        yield jnative


@pytest.mark.parametrize("fn", ["hash_text_counts", "multihot_tags",
                                "hash_text_sparse", "multihot_tags_sparse"])
def test_native_hasher_matches_the_jax_package_native(window, fn, jax_native_hasher):
    _, _, _, tags, text = window
    texts = [f"{a} {b}" for a, b in text]
    cells = ["" if c is None or isinstance(c, float) else c for c in tags[:, 0]]
    rows = texts if "text" in fn else cells
    args = (rows, 512) if fn in ("hash_text_counts", "multihot_tags") else (rows, 512, 8)
    got, want = getattr(tnative, fn)(*args), getattr(jax_native_hasher, fn)(*args)
    assert got is not None and want is not None
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def _labels(seed, n=300, k=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, n)


@pytest.mark.parametrize("method", ["hungarian", "pot"])
@pytest.mark.parametrize("with_prev", [True, False])
def test_match_clusters_equal(method, with_prev):
    prev = _labels(0) if with_prev else None
    new = (_labels(0) + 1) % 5          # a relabeled copy: a perfect match exists
    new[::7] = _labels(1)[::7]          # with some disagreement
    got = tmatch.match_clusters(prev, new, method=method, min_overlap=3)
    want = jmatch.match_clusters(prev, new, method=method, min_overlap=3)
    np.testing.assert_array_equal(got, want)
    if with_prev:
        assert not np.array_equal(got, new)


def test_match_clusters_infeasible_and_background_equal():
    prev, new = np.zeros(20, int), np.arange(20)        # no pair reaches overlap 5
    np.testing.assert_array_equal(tmatch.match_clusters(prev, new),
                                  jmatch.match_clusters(prev, new))
    bg = np.full(20, -1)
    np.testing.assert_array_equal(tmatch.match_clusters(bg, new),
                                  jmatch.match_clusters(bg, new))
    cost = np.array([[np.inf, -3.0], [np.inf, -2.0]])
    assert tmatch.is_feasible(cost) == jmatch.is_feasible(cost) is False
    np.testing.assert_array_equal(tmatch.sinkhorn([0.5, 0.5], [0.5, 0.5], np.eye(2)),
                                  jmatch.sinkhorn([0.5, 0.5], [0.5, 0.5], np.eye(2)))


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_all_metrics_equal(seed):
    truth = _labels(seed, k=3) * (_labels(seed + 10, k=2) > 0)
    clusters = _labels(seed + 20, k=3)
    args = (300, 0.5, "binary", True, 8, 3, 64, clusters, truth, 2_000_000_000, 0)
    with contextlib.redirect_stdout(io.StringIO()) as out_t:
        got = tmetrics.compute_all_metrics(tmetrics.get_initial_results()[0], *args)
    with contextlib.redirect_stdout(io.StringIO()) as out_j:
        want = jmetrics.compute_all_metrics(jmetrics.get_initial_results()[0], *args)
    assert got == want and out_t.getvalue() == out_j.getvalue()
    assert tmetrics.get_initial_results()[1] == jmetrics.get_initial_results()[1]
    assert tmetrics.nmi(truth, clusters) == jmetrics.nmi(truth, clusters)


def test_per_class_metrics_equal_with_many_clusters():
    """The port counts per class with bincounts, the JAX package with a loop
    over classes: equal on a batch-like labelling (hundreds of clusters,
    noise -1, binary truth)."""
    rng = np.random.default_rng(5)
    truth = (rng.random(5000) < 0.1).astype(np.int64)
    clusters = rng.integers(-1, 400, 5000)
    for name in ("weighted_f1", "weighted_precision", "weighted_recall", "aligned_f1"):
        assert getattr(tmetrics, name)(truth, clusters) == \
            getattr(jmetrics, name)(truth, clusters), name


def test_metrics_of_an_empty_stream_equal():
    empty = np.empty(0, int)
    for name in ("nmi", "aligned_f1", "accuracy", "mean_absolute_error"):
        assert getattr(tmetrics, name)(empty, empty) == getattr(jmetrics, name)(empty, empty)


@pytest.mark.parametrize("cls", ["PipelineConfig", "FeatureConfig"])
def test_config_fields_equal(cls):
    got, want = getattr(tconfig, cls)(), getattr(jconfig, cls)()
    got_fields = [(f.name, f.type) for f in dataclasses.fields(got)]
    assert got_fields == [(f.name, f.type) for f in dataclasses.fields(want)]
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert (dataclasses.asdict(g) == dataclasses.asdict(w)
                if dataclasses.is_dataclass(g) else g == w), f.name


def test_config_behaviour_equal():
    assert tconfig.APPROACHES == jconfig.APPROACHES
    for kw in ({}, {"label_mode": "types"}, {"label_mode": "all"},
               {"n_clusters_override": 7}, {"approach": "SVDMC_batch"}):
        got, want = tconfig.PipelineConfig(**kw), jconfig.PipelineConfig(**kw)
        assert (got.n_clusters_total, got.is_batch) == (want.n_clusters_total,
                                                        want.is_batch)
        assert got.replace(window_size=8).window_size == 8


# ---------------------------------------------------------------------------
# ops/matching.CentroidMatcher (slice 2f): host numpy + scipy, bit-equal
# ---------------------------------------------------------------------------

def _matcher_windows(seed: int, windows: int = 8, n: int = 60, d: int = 5):
    """(feats, labels) per window: clusters whose centres drift and whose
    window-local ids shuffle, events born and dying, a background (-1)
    bucket, rows with non-finite features, one all-background window."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(12, d)) * 4.0
    out = []
    for w in range(windows):
        live = rng.choice(12, size=rng.integers(2, 6), replace=False)
        which = rng.integers(0, len(live), n)
        feats = centres[live[which]] + 0.3 * rng.normal(size=(n, d)) + 0.05 * w
        local = rng.permutation(len(live))[which].astype(np.int64)
        local[rng.random(n) < 0.1] = -1
        feats[rng.random(n) < 0.05, rng.integers(0, d)] = np.nan
        if w == 5:
            local[:] = -1
        out.append((feats.astype(np.float32), local))
    return out


def _snap_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("max_dist,max_registry,seed",
                         [(None, 4096, 0), (2.0, 4096, 1), (None, 6, 2), (1.0, 4, 3)])
def test_centroid_matcher_bit_equal(max_dist, max_registry, seed):
    """Stable ids window by window, the registry (centroids, ids, last use,
    next id) after each, eviction at a small ``max_registry`` included."""
    want = jmatch.CentroidMatcher(max_dist, max_registry=max_registry)
    got = tmatch.CentroidMatcher(max_dist, max_registry=max_registry)
    for feats, labels in _matcher_windows(seed):
        a, b = want.match(feats, labels), got.match(feats, labels)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
        _snap_equal(got.snapshot(), want.snapshot())
    assert len(got.ids) <= max_registry


def test_centroid_matcher_background_and_non_finite_rows():
    """-1 rows keep -1 and register nothing; a cluster whose rows are all
    non-finite keeps a zero centroid, like the original."""
    feats = np.ones((6, 3), np.float32)
    feats[3:] = np.nan
    labels = np.array([0, 0, -1, 1, 1, 1])
    for m in (jmatch.CentroidMatcher(), tmatch.CentroidMatcher()):
        assert m.match(feats, np.full(6, -1)).tolist() == [-1] * 6 and m.centroids is None
        assert m.match(feats, labels).tolist() == labels.tolist()
        np.testing.assert_array_equal(m.centroids[1], np.zeros(3))
        np.testing.assert_array_equal(m.match(feats, labels[::-1].copy()), [0, 0, 0, -1, 1, 1])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_centroid_matcher_snapshot_round_trip(direction):
    """A registry snapshotted after 4 windows and rebuilt in the other
    package continues exactly as the uninterrupted original; the snapshot is
    a copy, not a view of the live registry."""
    windows = _matcher_windows(7)
    src_mod, dst_mod = (jmatch, tmatch) if direction == "jax_to_port" else (tmatch, jmatch)
    whole, first = jmatch.CentroidMatcher(1.5, max_registry=6), src_mod.CentroidMatcher(
        1.5, max_registry=6)
    for feats, labels in windows[:4]:
        whole.match(feats, labels)
        first.match(feats, labels)
    snap = first.snapshot()

    def copy(d):       # from_snapshot keeps last_used by reference, in both packages
        return {k: (np.array(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()}

    before = copy(snap)
    resumed = dst_mod.CentroidMatcher.from_snapshot(copy(snap))
    for feats, labels in windows[4:]:
        np.testing.assert_array_equal(resumed.match(feats, labels), whole.match(feats, labels))
        first.match(feats, labels)
    _snap_equal(snap, before)
