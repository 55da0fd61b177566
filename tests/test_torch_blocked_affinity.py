"""The huge-window blocked affinity (column panels, rebuilt row blocks, the FD
fold and the blocked SVD) against the JAX package on a 256-row window of
its own seeded synthetic stream.

Row-block tests feed both sides the same column panels (the JAX Columns,
carried over with ``columns_from_jax``), so the comparison is of the sweep
and not of torch's and XLA's last-ulp differences in trig and norms.
Tolerances:
  * edges of every rebuilt block (strip, binned, candidate form): identical;
  * the column builders: integer panels and validity identical, float
    panels to 1e-6 relative, the bf16 text panel equal in >= 99.9% of
    entries and within one bf16 ulp elsewhere (an f32 ulp of the norm can
    flip a rounding);
  * FD fold, candidate against dense: the same sq_frobenius (an integer
    edge count); Gram within 15% (the candidate fold's operands are bf16),
    as tests/test_cand_fold.py holds the JAX package;
  * blocked SVD with the same test matrix: (U S)(U S)^T to 1e-3 relative
    (fp32 QR / SVD rounding; the sign of each column is free).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.data import features as feat
from mused_tpu.engine.batch import _pad_window_features
from mused_tpu.ops import affinity as jaff
from mused_tpu.ops import blocked_affinity as jba
from mused_tpu.ops.pallas import blocked_select as jbs
from mused_tpu.ops.pallas import cand_matvec as jcm
from mused_tpu.utils.config import FeatureConfig
from mused_tpu_torch.data import features as tfeat
from mused_tpu_torch.data.ingest import pad_window_features, to_device
from mused_tpu_torch.ops import affinity as taff
from mused_tpu_torch.ops import blocked_affinity as tba
from mused_tpu_torch.ops.kernels import cand_matvec as tcm
from mused_tpu_torch.utils.convert import columns_from_jax
from torch_parity import as_features_of, n as tonp, synthetic_window_stream, t

N, BLOCK, K = 256, 64, 5
NBINS = N // 2


@pytest.fixture(scope="module")
def window():
    mods, _, _ = synthetic_window_stream(n_rows=N + 64, subset=N, seed=0)
    return feat.featurize_window(*mods, FeatureConfig())


@pytest.fixture(scope="module")
def jcols(window):
    return jba.standard_columns(window, FeatureConfig())


@pytest.fixture(scope="module")
def tcols(jcols):
    return columns_from_jax(jax.tree_util.tree_map(np.asarray, jcols), "cpu")


def test_standard_columns_match_jax(window, jcols):
    port_window = as_features_of(window, tfeat)
    got = tba.standard_columns(type(port_window)._make(to_device(port_window,
                                                                torch.device("cpu"))),
                               FeatureConfig())
    assert got.kinds == jcols.kinds
    for g, w in zip(got.valids, jcols.valids):
        np.testing.assert_array_equal(tonp(g), np.asarray(w))
    xyz, tim, uid, (tags, sums), text = got.tensors
    jxyz, jtim, juid, (jtags, jsums), jtext = jcols.tensors
    np.testing.assert_allclose(tonp(xyz), np.asarray(jxyz), rtol=1e-6, atol=1e-6)
    for g, w in ((tim, jtim), (uid, juid), (tags, jtags), (sums, jsums)):
        np.testing.assert_array_equal(tonp(g), np.asarray(w))
    np.testing.assert_allclose(tonp(got.idf), np.asarray(jcols.idf), rtol=1e-6)
    gt, wt = tonp(text.float()), np.asarray(jtext.astype(jnp.float32))
    assert (gt == wt).mean() >= 0.999
    np.testing.assert_allclose(gt, wt, rtol=2.0 ** -7, atol=0)


def test_generic_columns_match_jax():
    rng = np.random.default_rng(0)
    loc = rng.uniform([-60, -150], [60, 150], size=(N, 2)).astype(np.float32)
    loc[3] = np.nan
    tim = rng.uniform(1, 1e4, size=(N, 2)).astype(np.float32)
    tim[4, 0] = 0.0
    emb = rng.normal(size=(N, 40)).astype(np.float32)
    emb[5] = 0.0
    dft = rng.normal(size=(N, 7)).astype(np.float32)
    dft[6, 2] = np.inf
    mats, types = [loc, tim, emb, dft], ("location", "time", "embedding", "default")
    want = jba.generic_columns(mats, types)
    got = tba.generic_columns(mats, types, "cpu")
    assert got.kinds == want.kinds == ("location_xyz", "time", "embedding_bf16",
                                       "default_safe")
    for g, w in zip(got.valids, want.valids):
        np.testing.assert_array_equal(tonp(g), np.asarray(w))
    np.testing.assert_allclose(tonp(got.tensors[0]), np.asarray(want.tensors[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tonp(got.tensors[1]), np.asarray(want.tensors[1]))
    ge, we = tonp(got.tensors[2].float()), np.asarray(want.tensors[2].astype(jnp.float32))
    assert ge.shape == we.shape == (N, 128)
    np.testing.assert_allclose(ge, we, rtol=2.0 ** -7, atol=0)
    np.testing.assert_array_equal(tonp(got.tensors[3][0].float()),
                                  np.asarray(want.tensors[3][0].astype(jnp.float32)))
    np.testing.assert_array_equal(tonp(got.tensors[3][1]), np.asarray(want.tensors[3][1]))


def test_knn_adjacency_block_matches_jax():
    rng = np.random.default_rng(1)
    sim = rng.integers(-3, 3, size=(48, N)).astype(np.float32) / 2
    sim[sim == 0] = -0.0
    sim[:, ::7] = 0.0                       # +0.0 beside -0.0: IEEE total order ranks it higher
    row_valid, col_valid = rng.random(48) > 0.1, rng.random(N) > 0.1
    for k in (1, 5, 30):
        want = jaff.knn_adjacency_block(jnp.asarray(sim), jnp.asarray(row_valid),
                                        jnp.asarray(col_valid), k, jnp.int32(100), False,
                                        out_dtype=jnp.bool_)
        got = taff.knn_adjacency_block(t(sim), t(row_valid), t(col_valid), k, 100,
                                       approx=True, out_dtype=torch.bool)
        np.testing.assert_array_equal(tonp(got), np.asarray(want))


@pytest.mark.parametrize("select", ["strip", "binned"])
def test_fused_rowblock_matches_jax(select, jcols, tcols):
    for start in (0, 64, 192):
        want = jba.fused_rowblock(jcols, jnp.int32(start), BLOCK, K, select=select,
                                  nbins=NBINS)
        got = tba.fused_rowblock(tcols, start, BLOCK, K, select=select, nbins=NBINS)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(tonp(got), np.asarray(want))


def test_candidate_rowblock_matches_jax_and_the_dense_block(jcols, tcols):
    tn = jbs.pick_tn(N, NBINS)
    assert tba.cand_fold_supported(tcols.kinds, tcols.tensors, NBINS, N)
    for start in (0, 128):
        want = jba.candidate_rowblock(jcols, jnp.int32(start), BLOCK, K, NBINS, tn, False)
        got = tba.candidate_rowblock(tcols, start, BLOCK, K, NBINS)
        np.testing.assert_array_equal(tonp(got.slabs), np.asarray(want.slabs))
        rows = tonp(tcm.dense_rows_reference(got))
        np.testing.assert_array_equal(rows, np.asarray(jcm.dense_rows_reference(want)))
        dense = tba.fused_rowblock(tcols, start, BLOCK, K, select="binned", nbins=NBINS)
        np.testing.assert_array_equal(rows, tonp(dense) > 0)


def test_cand_fold_gating_matches_jax(tcols, jcols):
    assert tba.cand_fold_supported(tcols.kinds, tcols.tensors, NBINS, N) \
        == jba.cand_fold_supported(tcols.kinds, tcols.tensors, NBINS, N)
    for nbins in (0, 100, 2):            # no bins, not dividing, > 127 groups
        assert not tba.cand_fold_supported(tcols.kinds, tcols.tensors, nbins, N)
    odd = tcols._replace(kinds=tcols.kinds[:4] + ("text",))
    assert not tba.cand_fold_supported(odd.kinds, odd.tensors, NBINS, N)
    with pytest.raises(ValueError):
        tba.blocked_fd_sketch(odd, ell=8, block=BLOCK, k_basis=K, select="binned",
                              nbins=NBINS, cand_fold=True)
    # a legacy kind has no candidate route: it takes the strip, as in JAX
    jodd = jcols._replace(kinds=jcols.kinds[:4] + ("text",))
    np.testing.assert_array_equal(
        tonp(tba.fused_rowblock(odd, 0, BLOCK, K, select="binned", nbins=NBINS)),
        np.asarray(jba.fused_rowblock(jodd, jnp.int32(0), BLOCK, K, select="binned",
                                      nbins=NBINS)))


def test_blocked_fd_sketch_cand_equals_dense_edges(tcols):
    kw = dict(ell=16, block=BLOCK, k_basis=K, mode="subspace", select="binned",
              nbins=NBINS)
    sk_d, sq_d, loss_d = tba.blocked_fd_sketch(tcols, cand_fold=False, **kw)
    sk_c, sq_c, loss_c = tba.blocked_fd_sketch(tcols, cand_fold=True, **kw)
    edges = sum(float(tba.fused_rowblock(tcols, s, BLOCK, K, select="binned",
                                         nbins=NBINS).sum()) for s in range(0, N, BLOCK))
    assert float(sq_d) == float(sq_c) == edges
    gd, gc = tonp(sk_d).T @ tonp(sk_d), tonp(sk_c).T @ tonp(sk_c)
    assert np.linalg.norm(gd - gc) / np.linalg.norm(gd) < 0.15
    assert abs(float(loss_d) - float(loss_c)) / max(float(loss_d), 1.0) < 0.1


def test_blocked_svd_reduce_matches_jax_with_the_same_omega(jcols, tcols):
    key = jax.random.key(3)
    rank = 8
    want = np.asarray(jba.blocked_svd_reduce(jcols, key, rank=rank, block=BLOCK,
                                             k_basis=K, select="binned", nbins=NBINS))
    omega = np.asarray(jax.random.normal(key, (N, rank + 8), jnp.float32))
    got = tonp(tba.blocked_svd_reduce(tcols, None, rank=rank, block=BLOCK, k_basis=K,
                                      select="binned", nbins=NBINS, omega=t(omega)))
    assert got.shape == want.shape == (N, rank)
    gw, gg = want @ want.T, got @ got.T
    np.testing.assert_allclose(gg, gw, rtol=1e-3, atol=1e-3 * np.abs(gw).max())


@pytest.mark.parametrize("sparse", [True, False])
def test_pad_window_features_matches_jax(window, sparse):
    wf = window
    if not sparse:
        fc = FeatureConfig()
        wf = feat.WindowFeatures(
            location=window.location, times=window.times, user_ids=window.user_ids,
            tags=tonp(taff.counts_from_tokens(t(window.tags_ids).long(), None,
                                              fc.tags_hash_dim)).astype(np.uint8),
            text=tonp(taff.counts_from_tokens(t(window.text_ids).long(),
                                              t(window.text_cnt), fc.text_hash_dim)
                      ).astype(np.uint8),
            tags_valid=window.tags_valid)
    got = pad_window_features(as_features_of(wf, tfeat), 37)
    want = _pad_window_features(wf, 37)
    assert type(got) is getattr(tfeat, type(want).__name__)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
