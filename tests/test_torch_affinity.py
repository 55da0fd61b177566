"""Port's affinity graphs and kNN kernel wrapper vs the JAX package.

Tolerance: bit-equal everywhere.  The port's plain kNN and the kernel
wrapper's CPU path must equal both the JAX oracle (``lax.top_k`` in
``mused_tpu.ops.affinity.knn_adjacency``) and the Pallas kernel in interpret
mode, for every metric, including fewer-valid-than-k rows, duplicate rows
(exactly k edges) and the city-scale chord3 case.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import affinity as ja
from mused_tpu.ops.pallas import affinity_kernel as pk
from mused_tpu_torch.ops import affinity as ta
from mused_tpu_torch.ops.kernels import affinity_kernel as ak
from torch_parity import n, t

METRICS = ["dot", "euclidean", "jaccard", "l1", "chord3"]


def _features(metric, rng, rows):
    if metric == "l1":
        return rng.uniform(1e6, 2e6, size=(rows, 2)).astype(np.float32)
    if metric == "jaccard":
        mh = (rng.random((rows, 64)) < 0.08).astype(np.float32)
        mh[5] = 0.0                                  # empty set, valid row
        return mh
    if metric == "chord3":
        ll = rng.uniform([-80, -170], [80, 170], size=(rows, 2)).astype(np.float32)
        return np.array(pk.location_to_unit_xyz(jnp.asarray(ll)))
    x = rng.normal(size=(rows, 24)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(metric, case, rng):
    rows, k = 96, 7
    x = _features(metric, rng, rows)
    valid = np.ones(rows, bool)
    if case == "masked":
        valid[[3, 11, 40]] = False
    elif case == "fewer_valid_than_k":
        valid[:] = False
        valid[:6] = True                             # 5 valid neighbours < k
    elif case == "duplicates":
        x[10:50] = x[10]                             # 40 exact duplicates
    return x, valid, k


def _assert_matches_jax(x, valid, k, metric):
    oracle = n(ja.knn_adjacency(pk._sim_block(jnp.asarray(x), jnp.asarray(x), metric),
                                jnp.asarray(valid), k))
    pallas = n(pk.knn_adjacency_pallas(jnp.asarray(x), jnp.asarray(valid), k,
                                       metric=metric, interpret=True))
    ref = n(ak.knn_adjacency_reference(t(x), t(valid), k, metric))
    wrapped = n(ak.knn_adjacency(t(x), t(valid), k, metric))
    np.testing.assert_array_equal(ref, oracle)
    np.testing.assert_array_equal(ref, pallas)
    np.testing.assert_array_equal(wrapped, ref)
    return ref


@pytest.mark.parametrize("case", ["masked", "fewer_valid_than_k", "duplicates"])
@pytest.mark.parametrize("metric", METRICS)
def test_knn_adjacency_bit_equal_jax(metric, case, rng):
    x, valid, k = _case(metric, case, rng)
    got = _assert_matches_jax(x, valid, k, metric)
    deg = got.sum(axis=1)
    if case == "fewer_valid_than_k":
        assert (deg[valid] == 5).all() and (deg[~valid] == 0).all()
    if case == "duplicates":
        assert (deg == k).all()


@pytest.mark.parametrize("metric", METRICS)
def test_knn_adjacency_bf16_operands_bit_equal_jax(metric, rng):
    """``input_dtype="bfloat16"``: operands rounded to bf16, f32 sums, as the
    Pallas kernel's option does in interpret mode."""
    x, valid, k = _case(metric, "masked", rng)
    pallas = n(pk.knn_adjacency_pallas(jnp.asarray(x), jnp.asarray(valid), k,
                                       metric=metric, interpret=True,
                                       input_dtype="bfloat16"))
    ref = n(ak.knn_adjacency_reference(t(x), t(valid), k, metric, input_dtype="bfloat16"))
    wrapped = n(ak.knn_adjacency(t(x), t(valid), k, metric, input_dtype="bfloat16"))
    np.testing.assert_array_equal(ref, pallas)
    np.testing.assert_array_equal(wrapped, ref)
    assert (ref.sum(1)[valid] == k).all()


def test_chord3_city_scale_bit_equal():
    """~200 m spacing: chord3 keeps the haversine ranking where the f32 dot
    saturates (test_pallas_affinity.test_chord3_city_scale_resolution)."""
    latlon = np.array([[41.39 + i * 0.0018, 2.16] for i in range(20)], np.float32)
    xyz = np.asarray(pk.location_to_unit_xyz(jnp.asarray(latlon)))
    got = _assert_matches_jax(xyz, np.ones(20, bool), 4, "chord3")
    hav = n(ta.location_adjacency(t(latlon), 4))
    np.testing.assert_array_equal(got, hav)


def test_time_nan_padded_rows_generic_fusion(rng):
    """NaN-padded time rows are invalid on the kernel path exactly as on the
    plain path, and match the JAX Pallas generic fusion."""
    from mused_tpu.engine.streaming import _fuse_generic as j_generic
    from mused_tpu_torch.engine.streaming import _fuse_generic as t_generic
    m = np.abs(rng.normal(size=(64, 2))).astype(np.float32) + 0.1
    m[50:] = np.nan
    m[7] = 0.0
    want = n(j_generic((jnp.asarray(m),), k_basis=2, types=("time",), use_pallas=True))
    for use_kernel in (False, True):
        got = n(t_generic((t(m),), k_basis=2, types=("time",), use_kernel=use_kernel))
        np.testing.assert_array_equal(got, want)
        assert got[50:].sum() == 0 and got[:, 50:].sum() == 0


def test_per_modality_adjacency_bit_equal(rng):
    rows, kb = 80, 3
    latlon = rng.uniform([-60, -170], [60, 170], size=(rows, 2)).astype(np.float32)
    latlon[[4, 9]] = np.nan
    times = rng.uniform(1e3, 1e5, size=(rows, 2)).astype(np.float32)
    times[5, 0] = 0.0
    uids = rng.integers(-1, 12, size=rows).astype(np.int32)
    tags = (rng.random((rows, 48)) < 0.1).astype(np.float32)
    tags_valid = np.ones(rows, bool)
    tags_valid[6] = False
    text = rng.integers(0, 3, size=(rows, 64)).astype(np.float32) * \
        (rng.random((rows, 64)) < 0.2)
    text[8] = 0.0
    emb = rng.normal(size=(rows, 16)).astype(np.float32)
    pairs = [
        (ja.location_adjacency(jnp.asarray(latlon), kb), ta.location_adjacency(t(latlon), kb)),
        (ja.time_adjacency(jnp.asarray(times), kb), ta.time_adjacency(t(times), kb)),
        (ja.username_adjacency(jnp.asarray(uids)), ta.username_adjacency(t(uids))),
        (ja.tags_adjacency(jnp.asarray(tags), kb, jnp.asarray(tags_valid)),
         ta.tags_adjacency(t(tags), kb, t(tags_valid))),
        (ja.text_adjacency(jnp.asarray(text), kb), ta.text_adjacency(t(text), kb)),
        (ja.euclidean_adjacency(jnp.asarray(emb), kb), ta.euclidean_adjacency(t(emb), kb)),
        (ja.embedding_adjacency(jnp.asarray(emb), kb), ta.embedding_adjacency(t(emb), kb)),
        (ja.multimodal_fused_adjacency(
            jnp.asarray(latlon), jnp.asarray(times), jnp.asarray(uids), jnp.asarray(tags),
            jnp.asarray(text), k_basis=kb, tags_valid=jnp.asarray(tags_valid)),
         ta.multimodal_fused_adjacency(t(latlon), t(times), t(uids), t(tags), t(text),
                                       k_basis=kb, tags_valid=t(tags_valid))),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(n(got), n(want))


def test_counts_from_tokens_and_fuse(rng):
    ids = rng.integers(-1, 32, size=(10, 6)).astype(np.int16)
    cnt = rng.integers(0, 4, size=(10, 6)).astype(np.uint8)
    for c in (None, cnt):
        want = ja.counts_from_tokens(jnp.asarray(ids), None if c is None else jnp.asarray(c), 32)
        got = ta.counts_from_tokens(t(ids), None if c is None else t(c), 32)
        np.testing.assert_array_equal(n(got), n(want))
    mats = [(rng.random((8, 8)) < 0.3).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(n(ta.fuse([t(m) for m in mats])),
                                  n(ja.fuse([jnp.asarray(m) for m in mats])))


@pytest.mark.parametrize("sparse", [True, False])
def test_standard_fusion_bit_equal_jax(sparse):
    """Kernel-entry fusion vs JAX ``_fuse_standard_pallas`` (interpret) and
    plain fusion vs ``_fuse_standard_sparse`` / ``_fuse_standard`` on a
    featurized synthetic window."""
    from mused_tpu.data import features as feat
    from mused_tpu.engine import streaming as js
    from mused_tpu.utils.config import FeatureConfig
    from mused_tpu_torch.engine import streaming as ts
    from torch_parity import synthetic_window_stream
    mods, _, _ = synthetic_window_stream(n_rows=300, n_events=3, subset=128)
    fc = FeatureConfig(sparse=sparse)
    wf = feat.featurize_window(*mods, fc)
    kw = dict(k_basis=3, tags_dim=fc.tags_hash_dim, text_dim=fc.text_hash_dim)
    if sparse:
        args = (wf.location, wf.times, wf.user_ids, wf.tags_ids, wf.text_ids,
                wf.text_cnt, wf.tags_valid)
        plain_jax = js._fuse_standard_sparse(*map(jnp.asarray, args), **kw)
    else:
        args = (wf.location, wf.times, wf.user_ids, wf.tags, wf.text, None, wf.tags_valid)
        plain_jax = js._fuse_standard(wf.location, wf.times, wf.user_ids,
                                      wf.tags.astype(np.float32),
                                      wf.text.astype(np.float32), 3, wf.tags_valid)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else t(a) for a in args]
    kernel_jax = js._fuse_standard_pallas(*jargs, sparse=sparse, **kw)
    kernel_port = ts._fuse_standard_kernel(*targs, sparse=sparse, **kw)
    plain_port = ts._fuse_standard_plain(*targs, sparse=sparse, **kw)
    np.testing.assert_array_equal(n(plain_port), n(plain_jax))
    # unit-xyz from torch's and XLA's sin/cos differ in the last ulp; on this
    # window no near-tie flips, so the kernel fusion is bit-equal too
    np.testing.assert_array_equal(n(kernel_port), n(kernel_jax))


def test_wrapper_checks_inputs():
    x = torch.zeros((8, 3))
    v = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        ak.knn_adjacency(x, v, 2, "cosine")
    with pytest.raises(TypeError):
        ak.knn_adjacency(x.double(), v, 2, "dot")
    with pytest.raises(TypeError):
        ak.knn_adjacency(x, v[:4], 2, "dot")
    with pytest.raises(ValueError):
        ak.knn_adjacency(torch.zeros((8, 2)), v, 2, "chord3")
    with pytest.raises(ValueError):
        ak.knn_adjacency(x, v, 2, "dot", input_dtype="float16")


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(rng):
    x = t(_features("dot", rng, 32))
    before = ak.launches
    out = ak.knn_adjacency(x, torch.ones(32, dtype=torch.bool), 4, "dot")
    assert ak.launches == before
    assert out.dtype == torch.float32 and (out.sum(1) == 4).all()
