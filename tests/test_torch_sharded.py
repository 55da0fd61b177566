"""The row-sharded modules (``mused_tpu_torch/parallel/sketch_merge``,
``kmeans_sharded`` and ``sharded``) on 4 gloo ranks of the CPU against the
JAX package's on its virtual CPU devices with a (4, 1) mesh, at small sizes:
a 64-row dense window (k_basis 3, reduced_dim 8) and a 512-row huge window
(block 64, nbins 128, ell 16).

One spawn of 4 ranks runs every case (``torch_dist.sharded_cases``) while
this process computes the JAX side.  Tolerances:
  * sketch merges on the same per-rank sketches: BᵀB within 1e-5·‖S‖²_F of
    the JAX package's, and inside the FD bound; ``global_max_row_norm`` and
    ``ppermute`` exact;
  * row-sharded k-means from the same initial centres: labels equal,
    centroids within 1e-5; on small-integer fixtures (sums exact in any
    order) labels and centroids bit-equal to ``mused_tpu.ops.kmeans.kmeans``,
    with at most ceil(steps / ``CHECK_EVERY``) host reads on every rank;
  * the fused (m, n) shard: time, username and tags bit-equal; location
    and text on >= 99.9% of edges with every row's degree equal (each
    modality alone, by invalidating the others on both sides); the fused
    OR of the sparse and generic layouts under the same rule;
  * the distributed SVD with the JAX test matrix: equal up to column sign,
    within 1e-4 of the largest entry;
  * the huge ``rows`` entry points, held to the port's own single-device
    sweep (the Rayleigh-Ritz basis differs between torch and XLA):
    sq_frobenius bit-equal, the FD bound; the blocked SVD and the Ritz
    values with the JAX draws injected, against the JAX package's;
  * every rank returns the same replicated results.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mused_tpu.data import features as jfeat
from mused_tpu.ops import blocked_affinity as jba
from mused_tpu.ops import fd as jfd
from mused_tpu.ops import kmeans as jkm
from mused_tpu.parallel import kmeans_sharded as jks
from mused_tpu.parallel import sharded as jsh
from mused_tpu.parallel import sketch_merge as jsm
from mused_tpu.parallel.mesh import make_mesh as jmake_mesh
from mused_tpu_torch.data import features as tfeat
from mused_tpu_torch.ops import blocked_affinity as tba
from mused_tpu_torch.ops import kmeans as tkm
from mused_tpu_torch.parallel import sharded as tsh
import torch_dist
from torch_parity import integer_kmeans_case, n as tonp, reference_lloyd, t

DENSE_N, KB, RANK, TAGS_DIM, TEXT_DIM = 64, 3, 8, 256, 512
HUGE_N, BLOCK, NBINS, ELL, K_MAX = 512, 64, 128, 16, 4
D_SKETCH = 32
MODALITIES = ("location", "time", "username", "tags", "text")
BIT_EQUAL = ("time", "username", "tags")
HUGE_FD = {f"huge_fd_{mode}_{cand}_{select}_{topo}": dict(mode=mode, cand_fold=cand,
                                                         select=select, nbins=NBINS,
                                                         topology=topo)
           for mode, cand, select, topo in (("eigh", None, "strip", "allgather"),
                                            ("subspace", None, "binned", "allgather"),
                                            ("subspace", True, "binned", "ring"),
                                            ("subspace", False, "binned", "ring"))}
JOIN_TIMEOUT = 180
INTEGER_CASES = ("converges", "empty_cluster", "max_iters")


def _standard_window(rng, n, h_tags=TAGS_DIM, h_text=TEXT_DIM):
    """tests/test_colsharded.py's standard window."""
    loc = rng.uniform(low=(-60.0, -170.0), high=(60.0, 170.0), size=(n, 2)).astype(np.float32)
    loc[rng.random(n) < 0.1] = np.nan
    tim = rng.uniform(1.0, 1e5, size=(n, 2)).astype(np.float32)
    tim[rng.random(n) < 0.1] = 0.0
    uid = rng.integers(0, 12, size=n).astype(np.int32)
    uid[rng.random(n) < 0.1] = -1
    tags = (rng.random((n, h_tags)) < 0.02).astype(np.uint8)
    text = rng.poisson(0.05, size=(n, h_text)).astype(np.uint8)
    tags_valid = rng.random(n) < 0.9
    return (loc, tim, uid, tags, text, tags_valid)


def _only(feats, keep: str):
    """The standard window with every modality but ``keep`` invalid."""
    loc, tim, uid, tags, text, tags_valid = (np.array(a) for a in feats)
    if keep != "location":
        loc[:] = np.nan
    if keep != "time":
        tim[:] = 0.0
    if keep != "username":
        uid[:] = -1
    if keep != "tags":
        tags[:] = 0
        tags_valid[:] = False
    if keep != "text":
        text[:] = 0
    return (loc, tim, uid, tags, text, tags_valid)


def _sparse_window(rng, n, t_tags=6, t_text=10):
    """A sparse-token window: int16 ids (-1 padding, distinct per row) and
    uint8 counts."""
    loc, tim, uid, _, _, tags_valid = _standard_window(rng, n)

    def ids(width, dim):
        out = np.full((n, width), -1, np.int16)
        for i in range(n):
            k = rng.integers(0, width + 1)
            out[i, :k] = rng.choice(dim, size=k, replace=False)
        return out

    text_ids = ids(t_text, TEXT_DIM)
    text_cnt = np.where(text_ids >= 0, rng.integers(1, 4, size=text_ids.shape), 0).astype(np.uint8)
    return (loc, tim, uid, ids(t_tags, TAGS_DIM), text_ids, text_cnt, tags_valid)


def _generic_window(rng, n):
    emb = rng.normal(size=(n, 16)).astype(np.float32)
    dft = rng.normal(size=(n, 6)).astype(np.float32)
    loc = rng.uniform(low=(-60.0, -170.0), high=(60.0, 170.0), size=(n, 2)).astype(np.float32)
    tim = rng.uniform(1.0, 1e5, size=(n, 2)).astype(np.float32)
    emb[::13] = np.nan
    dft[::17, 2] = np.inf
    loc[::19] = np.nan
    tim[::23, 0] = 0.0
    return (emb, dft, loc, tim)


GENERIC_TYPES = ("embedding", "default", "location", "time")


def _blobs(rng, n=64, d=4):
    centers = rng.normal(size=(3, d)) * 6
    return np.concatenate([c + rng.normal(size=(n // 3 + 1, d)) * 0.3
                           for c in centers])[:n].astype(np.float32)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    sketch_rows = [rng.normal(size=(48, D_SKETCH)).astype(np.float32) for _ in range(4)]
    sketches = [np.asarray(jfd.update_stream(jfd.init(ELL // 2, D_SKETCH), jnp.asarray(r)).sketch)
                for r in sketch_rows]
    rows = rng.normal(size=(256, D_SKETCH)).astype(np.float32)
    std = _standard_window(np.random.default_rng(1), DENSE_N)
    fused = {f"only_{m}": (_only(std, m), ("standard",)) for m in MODALITIES}
    fused["standard"] = (std, ("standard",))
    fused["sparse"] = (_sparse_window(np.random.default_rng(2), DENSE_N), ("standard_sparse",))
    fused["generic"] = (_generic_window(np.random.default_rng(3), DENSE_N), GENERIC_TYPES)
    x = _blobs(np.random.default_rng(4))
    key = jax.random.key(6)
    km_init = np.asarray(jkm._kmeanspp_init(jnp.asarray(x), 5, jnp.int32(3), key))
    far = np.array(km_init)
    far[2] = 1e3                                     # a centre no point takes: relocation
    kmeans = {"kmeans": (x, 3, 5, km_init), "kmeans_relocate": (x, 3, 5, far)}
    kmeans_reads = {}
    for name in INTEGER_CASES:
        xi, k, k_max, key_i, max_iters, tol = integer_kmeans_case(name)
        init = np.array(jkm._kmeanspp_init(jnp.asarray(xi), k_max, jnp.int32(k), key_i))
        kmeans_reads[name] = (xi, k, k_max, init, max_iters, tol)
    huge = _standard_window(np.random.default_rng(5), HUGE_N)
    svd_key, huge_key = jax.random.key(7), jax.random.key(8)
    svd_fused = _jax_fused(std, ("standard",))
    k = min(RANK + 10, DENSE_N)
    payload = {
        "consts": {"ell": ELL // 2, "kb": KB, "rank": RANK, "tags_dim": TAGS_DIM,
                   "text_dim": TEXT_DIM, "block": BLOCK, "nbins": NBINS, "k_max": K_MAX},
        "sketches": sketches, "rows": rows, "kmeans": kmeans, "kmeans_reads": kmeans_reads,
        "fused": fused,
        "svd_fused": svd_fused,
        "svd_omega": np.asarray(jax.random.normal(svd_key, (DENSE_N, k), jnp.float32)),
        "huge": huge, "huge_fd": {k_: dict(v, ell=ELL) for k_, v in HUGE_FD.items()},
        "huge_omega": np.asarray(jax.random.normal(huge_key, (HUGE_N, RANK + 8), jnp.float32)),
        "huge_probe": np.asarray(jax.random.normal(huge_key, (HUGE_N, K_MAX + 8), jnp.float32)),
    }
    for v in payload["huge_fd"].values():
        v.pop("ell")
    ranks = torch_dist.start("sharded_cases", payload, world=4)
    try:
        jx = _jax_side(payload, svd_key, huge_key)
    except BaseException:
        ranks.terminate()
        raise
    return {"ranks": ranks.join(JOIN_TIMEOUT), "jax": jx, "payload": payload}


@functools.lru_cache(maxsize=None)
def _mesh4():
    return jmake_mesh(n_data=4)


@functools.lru_cache(maxsize=None)
def _jax_fuser(types, ndims):
    """One jitted shard_map per feature layout (eager shard_map runs op by op)."""
    body = functools.partial(jsh._features_to_fused_shard, types=types, k_basis=KB,
                             tags_dim=TAGS_DIM, text_dim=TEXT_DIM)
    specs = tuple(P(*(("data",) + (None,) * (d - 1))) for d in ndims)
    return jax.jit(jax.shard_map(lambda *s: body(s), mesh=_mesh4(), in_specs=specs,
                                 out_specs=P("data", None), check_vma=False))


def _jax_fused(feats, types):
    """JAX's fused (n, n) matrix: the row shards of ``_features_to_fused_shard``."""
    feats = tuple(jnp.asarray(f) for f in feats)
    return np.asarray(_jax_fuser(types, tuple(f.ndim for f in feats))(*feats))


def _per_chip(fn, *args, in_specs):
    """fn's replicated result on each of the 4 chips, stacked."""
    out = jax.jit(jax.shard_map(lambda *a: fn(*a)[None], mesh=_mesh4(), in_specs=in_specs,
                                out_specs=P("data"), check_vma=False))(*args)
    return np.asarray(out)


def _jax_side(payload, svd_key, huge_key) -> dict:
    mesh = _mesh4()
    c = payload["consts"]
    out = {}
    stacked = jnp.asarray(np.stack(payload["sketches"]))
    out["allgather"] = _per_chip(lambda s: jsm.allgather_merge(s[0], c["ell"]), stacked,
                                 in_specs=(P("data"),))
    out["ring"] = _per_chip(lambda s: jsm.ring_merge(s[0]), stacked, in_specs=(P("data"),))
    for topo in ("allgather", "ring"):
        out[f"distributed_fd_{topo}"] = np.asarray(jsm.distributed_fd(
            jnp.asarray(payload["rows"]), ell=c["ell"], mesh=mesh, topology=topo))
    for name, (x, k, k_max, init) in payload["kmeans"].items():
        alive = jnp.arange(k_max) < k

        def lloyd(x_s, init=init, alive=alive):
            labels, cents = jks._sharded_lloyd(x_s, jnp.asarray(init), alive, 100, 1e-4)
            return labels, cents[None]

        labels, cents = jax.jit(jax.shard_map(lloyd, mesh=mesh, in_specs=P("data", None),
                                              out_specs=(P("data"), P("data", None, None)),
                                              check_vma=False))(jnp.asarray(x))
        out[name] = (np.asarray(labels), np.asarray(cents[0]))
    for name, (feats, types) in payload["fused"].items():
        out[name] = _jax_fused(feats, types)
    out["dist_svd"] = _per_chip(lambda f: jsh._dist_svd_reduce(f, svd_key, c["rank"]),
                                jnp.asarray(payload["svd_fused"]),
                                in_specs=(P("data", None),))[0]
    jcols = jba.standard_columns(jfeat.WindowFeatures(*(jnp.asarray(a)
                                                        for a in payload["huge"])))
    out["huge_svd"] = np.asarray(jsh.sharded_blocked_svd_reduce(
        jcols, huge_key, rank=c["rank"], block=BLOCK, k_basis=KB, mesh=mesh,
        select="binned", nbins=NBINS))
    ritz, lam = jsh.sharded_spectral_embedding(jcols, huge_key, k_max=K_MAX, block=BLOCK,
                                               k_basis=KB, mesh=mesh, select="binned",
                                               nbins=NBINS)
    out["huge_spectral"] = (np.asarray(ritz), np.asarray(lam))
    return out


def _gram(b):
    b = np.asarray(b, np.float64)
    return b.T @ b


def _assert_gram_close(got, want, scale):
    assert np.max(np.abs(_gram(got) - _gram(want))) <= 1e-5 * scale


def _same_on_every_rank(world, name):
    first = world["ranks"][0][name]
    for other in world["ranks"][1:]:
        for a, b in zip(first if isinstance(first, tuple) else (first,),
                        other[name] if isinstance(first, tuple) else (other[name],)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# sketch merges
# ---------------------------------------------------------------------------

def test_allgather_merge_matches_jax(world):
    s = np.concatenate(world["payload"]["sketches"])
    scale = float(np.sum(s.astype(np.float64) ** 2))
    for r, res in enumerate(world["ranks"]):
        _assert_gram_close(res["allgather"], world["jax"]["allgather"][r], scale)
    _same_on_every_rank(world, "allgather")


def test_ring_merge_matches_jax_on_every_rank(world):
    """Each rank's own union sketch against its chip's, and the rank-0 copy
    (what the engine absorbs) on every rank."""
    s = np.concatenate(world["payload"]["sketches"])
    scale = float(np.sum(s.astype(np.float64) ** 2))
    bound = scale / (world["payload"]["consts"]["ell"])
    for r, res in enumerate(world["ranks"]):
        _assert_gram_close(res["ring"], world["jax"]["ring"][r], scale)
        err = np.linalg.norm(_gram(s) - _gram(res["ring"]), 2)
        assert err <= bound
        np.testing.assert_array_equal(res["ring_rank0"], world["ranks"][0]["ring"])


@pytest.mark.parametrize("topology", ["allgather", "ring"])
def test_distributed_fd_matches_jax_and_the_fd_bound(world, topology):
    rows = world["payload"]["rows"]
    scale = float(np.sum(rows.astype(np.float64) ** 2))
    got = world["ranks"][0][f"distributed_fd_{topology}"]
    _assert_gram_close(got, world["jax"][f"distributed_fd_{topology}"], scale)
    # p local FD bounds plus the merge's: tests/test_parallel.py's 3 ||A||_F^2 / ell
    assert np.linalg.norm(_gram(rows) - _gram(got), 2) <= 3.0 * scale / (ELL // 2)
    _same_on_every_rank(world, f"distributed_fd_{topology}")


def test_global_max_row_norm_is_exact(world):
    rows = torch.from_numpy(world["payload"]["rows"])
    want = float(torch.max(torch.sum(rows * rows, dim=1)))
    assert [float(r["max_row_norm"]) for r in world["ranks"]] == [want] * 4


def test_ppermute_shifts_along_the_axis(world):
    for r, res in enumerate(world["ranks"]):
        ints, floats = res["ppermute"]
        src = (r - 1) % 4
        assert ints.dtype == np.int8 and list(ints) == [src, 10 * src]
        assert list(floats) == [float((r - 3) % 4)]


# ---------------------------------------------------------------------------
# k-means, the fused shard, the distributed SVD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["kmeans", "kmeans_relocate"])
def test_kmeans_sharded_matches_jax(world, name):
    labels, cents = world["ranks"][0][name]
    want_labels, want_cents = world["jax"][name]
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(cents, want_cents, atol=1e-5)
    _same_on_every_rank(world, name)
    if name == "kmeans_relocate":          # the far centre moved onto a point
        assert np.abs(cents[2]).max() < 100


@pytest.mark.parametrize("name", INTEGER_CASES)
def test_kmeans_sharded_reads_the_host_once_per_check(world, name):
    """At most ceil(steps / CHECK_EVERY) reads of ``Tensor.__bool__`` on
    every rank, labels and centroids bit-equal to ``mused_tpu.ops.kmeans.kmeans``
    (its k-means++ centres injected) on sums exact in any order."""
    x, k, k_max, key, max_iters, tol = integer_kmeans_case(name)
    want_labels, want_cents = jkm.kmeans(jnp.asarray(x), jnp.int32(k), key, k_max=k_max,
                                         max_iters=max_iters, tol=tol)
    init = world["payload"]["kmeans_reads"][name][3]
    steps = reference_lloyd(x, k, init, k_max=k_max, max_iters=max_iters, tol=tol)[2]
    for res in world["ranks"]:
        labels, cents, reads = res[f"reads_{name}"]
        assert reads <= math.ceil(steps / tkm.CHECK_EVERY), (reads, steps)
        np.testing.assert_array_equal(labels, np.asarray(want_labels))
        np.testing.assert_array_equal(cents, np.asarray(want_cents))


def _shards(world, name):
    return np.concatenate([r[name] for r in world["ranks"]])


def _assert_edges(got, want, exact: bool):
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    agree = np.mean(got == want)
    assert agree >= 0.999, agree
    np.testing.assert_array_equal(got.sum(1), want.sum(1))


@pytest.mark.parametrize("modality", MODALITIES)
def test_fused_shard_per_modality_matches_jax(world, modality):
    got, want = _shards(world, f"only_{modality}"), world["jax"][f"only_{modality}"]
    assert want.sum() > 0
    _assert_edges(got, want, modality in BIT_EQUAL)


@pytest.mark.parametrize("layout", ["standard", "sparse", "generic"])
def test_fused_shard_matches_jax(world, layout):
    _assert_edges(_shards(world, layout), world["jax"][layout], exact=False)


def test_dist_svd_matches_jax_up_to_sign(world):
    got, want = world["ranks"][0]["dist_svd"], world["jax"]["dist_svd"]
    assert got.shape == want.shape == (DENSE_N, RANK)
    sign = np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)
    assert np.max(np.abs(got * sign - want)) <= 1e-4 * np.max(np.abs(want))
    _same_on_every_rank(world, "dist_svd")


def test_sharded_window_step_runs(world):
    labels, reduced = world["ranks"][0]["window_step"]
    assert labels.shape == (DENSE_N,) and labels.max() < 2
    assert reduced.shape == (DENSE_N, RANK) and np.isfinite(reduced).all()
    _same_on_every_rank(world, "window_step")


# ---------------------------------------------------------------------------
# the huge-window rows layout
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _single_device(select):
    """The single-device port's columns and dense fused matrix of the huge window."""
    huge = _standard_window(np.random.default_rng(5), HUGE_N)
    cols = tba.standard_columns(tfeat.WindowFeatures(*(t(a) for a in huge)))
    full = np.concatenate([tonp(tba.fused_rowblock(cols, s, BLOCK, KB, select=select,
                                                   nbins=NBINS))
                           for s in range(0, HUGE_N, BLOCK)])
    return cols, full


@pytest.mark.parametrize("name", sorted(HUGE_FD))
def test_rows_fd_sketch_against_the_single_device_fold(world, name):
    kw = HUGE_FD[name]
    cols, full = _single_device(kw["select"])
    _, sq1, _ = tba.blocked_fd_sketch(cols, ell=ELL, block=BLOCK, k_basis=KB,
                                      mode=kw["mode"], select=kw["select"], nbins=NBINS,
                                      cand_fold=kw["cand_fold"])
    sketch, sq, loss = world["ranks"][0][name]
    assert float(sq) == float(sq1) == float(np.sum(full))
    assert float(loss) >= 0
    bound = 2.0 * float(np.sum(full)) / ELL
    assert np.linalg.norm(_gram(full) - _gram(sketch), 2) <= bound
    _same_on_every_rank(world, name)


def test_rows_blocked_svd_matches_jax_with_its_draws(world):
    got, want = world["ranks"][0]["huge_svd"], world["jax"]["huge_svd"]
    scale = float(np.max(np.abs(_gram(want))))
    assert np.max(np.abs(_gram(got) - _gram(want))) <= 1e-3 * scale
    _same_on_every_rank(world, "huge_svd")


def test_rows_spectral_matches_jax_with_its_probe(world):
    (ritz, lam), (jritz, jlam) = world["ranks"][0]["huge_spectral"], world["jax"]["huge_spectral"]
    assert ritz.shape == jritz.shape == (HUGE_N, K_MAX + 8)
    np.testing.assert_allclose(lam, jlam, atol=1e-4)
    _same_on_every_rank(world, "huge_spectral")


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,block,p", [(96, 32, 8), (100, 32, 1), (64, 16, 3)])
def test_row_block_geometry_raises_the_jax_message(n, block, p):
    with pytest.raises(ValueError) as jerr:
        jsh._check_row_blocks(n, block, p)
    with pytest.raises(ValueError) as terr:
        tsh._check_row_blocks(n, block, p)
    assert str(terr.value) == str(jerr.value)


def test_unknown_merge_topology_raises():
    from mused_tpu_torch.parallel import sketch_merge as tsm
    with pytest.raises(ValueError, match="merge_topology"):
        tsm.merge(torch.zeros((2, 3)), 2, None, "tree")

