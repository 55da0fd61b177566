"""Stride-binned candidates (K2 / K3): the port's wrappers on CPU tensors
(their plain versions) against the JAX package's Pallas kernels run in
interpret mode, on the same numpy inputs.

Tolerance: bit-equal.  Inputs are chosen so that every metric's sums are
exact in f32 whatever their order (dot / chord on multiples of 1/4 over 128
features, jaccard on 0/1 counts), and chord3 / l1 run unfused in the JAX
package's summation order; so vals and grp match exactly, ties included.
One exception: the JAX chord3 kernel in interpret mode contracts its
``acc += d * d`` into fused multiply-adds, so it differs from the JAX
package's own reference emulation (its CPU path and test oracle) in the last
ulp of about a fifth of the values.  The port matches that reference bit for
bit, and the interpret kernel to 1 ulp with >= 99% of group ids equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import affinity as jaff
from mused_tpu.ops.pallas import blocked_select as jbs
from mused_tpu.utils.config import PipelineConfig
from mused_tpu_torch.ops import affinity as taff
from mused_tpu_torch.ops.kernels import blocked_select as tbs
from mused_tpu_torch.ops.kernels import cand_matvec as tcm
from mused_tpu_torch.ops.kernels.affinity_kernel import location_to_unit_xyz
from torch_parity import n as tonp, t

N, BLOCK, START = 512, 128, 256


def _panel(metric, rng):
    """(numpy panel, JAX dtype, torch dtype, row sums or None)."""
    if metric == "jaccard":
        x = (rng.random((N, 128)) < 0.08).astype(np.int8)
        x[7] = x[7 + N // 4]            # duplicated rows: equal values in other groups
        return x, jnp.int8, torch.int8, x.astype(np.float32).sum(1)
    if metric in ("dot", "chord"):
        x = (rng.integers(-3, 4, (N, 128)) / 4).astype(np.float32)
        x[9] = x[9 + N // 2]
        sq = (x * x).sum(1) if metric == "chord" else None
        return x, jnp.bfloat16, torch.bfloat16, sq
    if metric == "chord3":
        ll = rng.uniform([-60, -150], [60, 150], size=(N, 2)).astype(np.float32)
        x = location_to_unit_xyz(t(ll)).numpy()
    else:
        x = rng.uniform(-5e3, 5e3, size=(N, 2)).astype(np.float32)
    x[11] = x[11 + N // 2]
    return x, jnp.float32, torch.float32, None


def _valid(rng):
    v = rng.random(N) > 0.1
    v[START + 3] = False
    return v


@pytest.mark.parametrize("nbins", [N, N // 2, N // 4])
@pytest.mark.parametrize("metric", ["jaccard", "dot", "chord", "chord3", "l1"])
def test_k2_matches_the_jax_kernel(metric, nbins):
    rng = np.random.default_rng(0)
    x, jdt, tdt, sums = _panel(metric, rng)
    valid = _valid(rng)
    jx = jnp.asarray(x).astype(jdt)
    want = jbs.binned_candidates_pallas(
        jx, jx[START:START + BLOCK], jnp.asarray(valid), jnp.int32(START), metric=metric,
        nbins=nbins, block=BLOCK, row_sums=None if sums is None else jnp.asarray(sums),
        tn=128, interpret=True)
    tx = t(x).to(tdt)
    before = tbs.launches
    got = tbs.binned_candidates(tx, tx[START:START + BLOCK], t(valid), START, metric=metric,
                                nbins=nbins, block=BLOCK,
                                row_sums=None if sums is None else t(sums))
    assert tbs.launches == before                     # CPU tensors: the plain version
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int8
    if metric == "chord3":
        xr = jx[START:START + BLOCK]
        strip = -((xr[:, 0][:, None] - jx[:, 0][None, :]) ** 2
                  + (xr[:, 1][:, None] - jx[:, 1][None, :]) ** 2
                  + (xr[:, 2][:, None] - jx[:, 2][None, :]) ** 2)
        ref = jbs.binned_candidates_reference(strip, jnp.asarray(valid), START, nbins)
        np.testing.assert_array_equal(tonp(got[0]), np.asarray(ref[0]))
        np.testing.assert_array_equal(tonp(got[1]), np.asarray(ref[1]))
        np.testing.assert_allclose(tonp(got[0]), np.asarray(want[0]), rtol=2.4e-7, atol=0)
        assert (tonp(got[1]) == np.asarray(want[1])).mean() >= 0.99
        return
    np.testing.assert_array_equal(tonp(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(tonp(got[1]), np.asarray(want[1]))


def test_k3_matches_the_jax_pair_kernel():
    rng = np.random.default_rng(1)
    xyz, *_ = _panel("chord3", rng)
    tim, *_ = _panel("l1", rng)
    va, vb = _valid(rng), _valid(rng)
    rows = slice(START, START + BLOCK)
    want = jbs.binned_candidates_pair_pallas(
        jnp.asarray(xyz), jnp.asarray(tim), jnp.asarray(xyz[rows]), jnp.asarray(tim[rows]),
        jnp.asarray(va), jnp.asarray(vb), jnp.int32(START), metricA="chord3",
        metricB="l1", nbins=N // 4, block=BLOCK, tn=128, interpret=True)
    got = tbs.binned_candidates_pair(t(xyz), t(tim), t(xyz[rows]), t(tim[rows]), t(va),
                                     t(vb), START, metricA="chord3", metricB="l1",
                                     nbins=N // 4, block=BLOCK)
    # l1 bit-equal; chord3 to the interpret kernel's 1-ulp FMA contraction
    np.testing.assert_array_equal(tonp(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(tonp(got[3]), np.asarray(want[3]))
    np.testing.assert_allclose(tonp(got[0]), np.asarray(want[0]), rtol=2.4e-7, atol=0)
    assert (tonp(got[1]) == np.asarray(want[1])).mean() >= 0.99
    for g, single in zip(got, (*tbs.binned_candidates(t(xyz), t(xyz[rows]), t(va), START,
                                                      metric="chord3", nbins=N // 4,
                                                      block=BLOCK),
                               *tbs.binned_candidates(t(tim), t(tim[rows]), t(vb), START,
                                                      metric="l1", nbins=N // 4,
                                                      block=BLOCK))):
        np.testing.assert_array_equal(tonp(g), tonp(single))


# shard-local starts: before the panel, overlapping its first columns, and
# overlapping / past its last ones (a column shard's view of another
# shard's row block)
SHARD_STARTS = [-BLOCK, -1, N - BLOCK + 1, N + 5]


@pytest.mark.parametrize("start", SHARD_STARTS)
@pytest.mark.parametrize("metric", ["jaccard", "chord", "chord3"])
def test_k2_row_stats_and_shard_local_start_match_the_jax_kernel(metric, start):
    """Rows that are not a slice of the panel, with their own statistics
    (``row_stats``) and a ``start`` outside [0, n - block]: the JAX kernel's
    colsharded contract (``_stat_operands``)."""
    rng = np.random.default_rng(6)
    x, jdt, tdt, sums = _panel(metric, rng)
    rows, *_, row_sums = _panel(metric, np.random.default_rng(7))
    rows = rows[:BLOCK]
    stats = None if row_sums is None else row_sums[:BLOCK]
    valid = _valid(rng)
    nbins = N // 4
    jx = jnp.asarray(x).astype(jdt)
    got = tbs.binned_candidates(t(x).to(tdt), t(rows).to(tdt), t(valid), start, metric=metric,
                                nbins=nbins, block=BLOCK,
                                row_sums=None if sums is None else t(sums),
                                row_stats=None if stats is None else t(stats))
    if metric == "chord3":      # the JAX reference emulation (see the module docstring)
        jr = jnp.asarray(rows)
        strip = -((jr[:, 0][:, None] - jx[:, 0][None, :]) ** 2
                  + (jr[:, 1][:, None] - jx[:, 1][None, :]) ** 2
                  + (jr[:, 2][:, None] - jx[:, 2][None, :]) ** 2)
        want = jbs.binned_candidates_reference(strip, jnp.asarray(valid), start, nbins)
    else:
        want = jbs.binned_candidates_pallas(
            jx, jnp.asarray(rows).astype(jdt), jnp.asarray(valid), jnp.int32(start),
            metric=metric, nbins=nbins, block=BLOCK, row_sums=jnp.asarray(sums),
            row_stats=jnp.asarray(stats), tn=128, interpret=True)
    np.testing.assert_array_equal(tonp(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(tonp(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("start", [START, -BLOCK, N - BLOCK + 1])
@pytest.mark.parametrize("pair", [("jaccard", "dot"), ("dot", "dot"), ("chord", "dot"),
                                  ("dot", "l1")], ids="+".join)
def test_k3_every_pair_matches_the_jax_pair_kernel(pair, start):
    """K3 on the tensor-core pairs (tags jaccard + text dot is the
    column-sharded sweep's) and a mixed pair, with each half's row_stats and
    a shard-local start, against the JAX pair kernel in interpret mode."""
    ma, mb = pair
    rng = np.random.default_rng(8)
    (xa, jda, tda, sa), (xb, jdb, tdb, sb) = _panel(ma, rng), _panel(mb, rng)
    rows_rng = np.random.default_rng(9)
    (ra, *_, rsa), (rb, *_, rsb) = _panel(ma, rows_rng), _panel(mb, rows_rng)
    ra, rb = ra[:BLOCK], rb[:BLOCK]
    sta = None if rsa is None else rsa[:BLOCK]
    stb = None if rsb is None else rsb[:BLOCK]
    va, vb = _valid(rng), _valid(rng)
    nbins = N // 4

    def opt(a):
        return None if a is None else jnp.asarray(a)

    def topt(a):
        return None if a is None else t(a)

    want = jbs.binned_candidates_pair_pallas(
        jnp.asarray(xa).astype(jda), jnp.asarray(xb).astype(jdb),
        jnp.asarray(ra).astype(jda), jnp.asarray(rb).astype(jdb), jnp.asarray(va),
        jnp.asarray(vb), jnp.int32(start), metricA=ma, metricB=mb, nbins=nbins,
        block=BLOCK, row_sumsA=opt(sa), row_statsA=opt(sta), row_sumsB=opt(sb),
        row_statsB=opt(stb), tn=128, interpret=True)
    got = tbs.binned_candidates_pair(
        t(xa).to(tda), t(xb).to(tdb), t(ra).to(tda), t(rb).to(tdb), t(va), t(vb), start,
        metricA=ma, metricB=mb, nbins=nbins, block=BLOCK, row_sumsA=topt(sa),
        row_statsA=topt(sta), row_sumsB=topt(sb), row_statsB=topt(stb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tonp(g), np.asarray(w))
    assert tbs.pair_route(ma, mb) == ("simple" if "l1" in pair else "mma")


def test_ties_go_to_the_lowest_group():
    """Every group holds the same column values: each bin keeps group 0,
    except where group 0's column is the row itself (masked), then group 1."""
    rng = np.random.default_rng(2)
    nbins, groups = 64, 4
    base = rng.uniform(0, 100, size=(nbins, 2)).astype(np.float32)
    x = np.tile(base, (groups, 1))
    valid = np.ones(nbins * groups, bool)
    start, block = 0, 32
    vals, grp = tbs.binned_candidates(t(x), t(x[:block]), t(valid), start, metric="l1",
                                      nbins=nbins, block=block)
    want_grp = np.zeros((block, nbins), np.int8)
    want_grp[np.arange(block), np.arange(block)] = 1       # self column is group 0's
    np.testing.assert_array_equal(tonp(grp), want_grp)
    jv, jg = jbs.binned_candidates_reference(
        jnp.asarray(tonp(tbs.sim_strip(t(x), t(x[:block]), "l1"))), jnp.asarray(valid),
        start, nbins)
    np.testing.assert_array_equal(tonp(grp), np.asarray(jg))
    np.testing.assert_array_equal(tonp(vals), np.asarray(jv))


def _tied_vals(rng, rows=48, nbins=64):
    vals = rng.integers(0, 6, (rows, nbins)).astype(np.float32) / 2
    vals[rng.random((rows, nbins)) < 0.2] = tbs.NEG
    vals[5] = tbs.NEG                                      # a row with no candidate
    return vals


@pytest.mark.parametrize("k", [1, 7, 64, 90])
def test_budgeted_keep_bit_equal(k):
    rng = np.random.default_rng(3)
    vals = _tied_vals(rng)
    row_valid = rng.random(vals.shape[0]) > 0.1
    want = np.asarray(jbs.budgeted_keep(jnp.asarray(vals), jnp.asarray(row_valid), k))
    got = tonp(tbs.budgeted_keep(t(vals), t(row_valid), k))
    np.testing.assert_array_equal(got, want)


def _union(keeps, grps, n: int, start: int = 0) -> torch.Tensor:
    """(block, n) bool union of per-modality kept candidates, through the
    candidate form (no username term)."""
    nbins = keeps[0].shape[1]
    slabs = torch.stack([tcm.pack_slab(k, g) for k, g in zip(keeps, grps)])
    uid_cols = torch.full((n // nbins, nbins), -2, dtype=torch.int32)
    return tbs.union_rowblock(tcm.CandBlock(slabs, None, uid_cols, start), torch.bool)


def test_adjacency_from_candidates_bit_equal():
    rng = np.random.default_rng(4)
    n, nbins = 256, 64
    keeps = [rng.random((32, nbins)) < 0.3 for _ in range(3)]
    grps = [rng.integers(0, n // nbins, (32, nbins)).astype(np.int8) for _ in range(3)]
    want = jbs.adjacency_from_candidates([jnp.asarray(k) for k in keeps],
                                         [jnp.asarray(g) for g in grps], n)
    got = _union([t(k) for k in keeps], [t(g) for g in grps], n)
    np.testing.assert_array_equal(tonp(got), np.asarray(want))


def test_binned_at_nbins_n_is_exact_knn():
    """nbins == n: one column per bin, so candidates + budgeted_keep equal the
    exact rectangular kNN, ties included (lowest index first)."""
    rng = np.random.default_rng(5)
    x = (rng.integers(-2, 3, (N, 128)) / 2).astype(np.float32)
    valid = _valid(rng)
    rows = slice(START, START + BLOCK)
    tx = t(x).to(torch.bfloat16)
    vals, grp = tbs.binned_candidates(tx, tx[rows], t(valid), START, metric="dot",
                                      nbins=N, block=BLOCK)
    adj = _union([tbs.budgeted_keep(vals, t(valid[rows]), 5)], [grp], N, START)
    sim = tbs.sim_strip(tx, tx[rows], "dot")
    want = taff.knn_adjacency_block(sim, t(valid[rows]), t(valid), 5, START,
                                    out_dtype=torch.bool)
    np.testing.assert_array_equal(tonp(adj), tonp(want))
    jwant = jaff.knn_adjacency_block(jnp.asarray(tonp(sim)), jnp.asarray(valid[rows]),
                                     jnp.asarray(valid), 5, jnp.int32(START), False,
                                     out_dtype=jnp.bool_)
    np.testing.assert_array_equal(tonp(want), np.asarray(jwant))


def test_sizing_rules_equal_the_jax_package():
    for n in list(range(128, 8193, 128)) + [98_304, 100_352, 131_072, 1000, 4095]:
        for k_max in (0, 9, 150):
            assert tbs.default_nbins(n, k_max=k_max) == jbs.default_nbins(n, k_max=k_max)
        nb = jbs.default_nbins(n)
        if nb:
            assert tbs.pick_tn(n, nb) == jbs.pick_tn(n, nb)
    assert tbs.default_nbins(98_304, k_max=150) == 1536


def test_resolve_select_on_cpu():
    cfg = PipelineConfig(window_size=98_304, k_basis=50)
    assert tbs.resolve_select(cfg, 98_304, "cpu") == ("strip", 0)
    assert tbs.resolve_select(cfg, 98_304, "cuda") == ("binned", 1536)
    assert tbs.resolve_select(cfg.replace(huge_window_fused_select=True), 98_304,
                              "cpu") == ("binned", 1536)
    assert tbs.resolve_select(cfg.replace(huge_window_fused_select=False), 98_304,
                              "cuda") == ("strip", 0)


def test_pad_features_128():
    x = torch.ones((4, 130))
    assert tbs.pad_features_128(x).shape == (4, 256)
    assert tbs.pad_features_128(torch.ones((4, 256))).shape == (4, 256)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((256, 128), dtype=torch.bfloat16)
    v = torch.ones(256, dtype=torch.bool)
    with pytest.raises(TypeError):      # jaccard takes int8 panels
        tbs.binned_candidates(x, x[:64], v, 0, metric="jaccard", nbins=64, block=64,
                              row_sums=torch.zeros(256))
    with pytest.raises(ValueError):     # nbins must divide n
        tbs.binned_candidates(x, x[:64], v, 0, metric="dot", nbins=100, block=64)
    with pytest.raises(ValueError):     # rows shape
        tbs.binned_candidates(x, x[:32], v, 0, metric="dot", nbins=64, block=64)
    with pytest.raises(TypeError):      # stat metrics need row sums
        tbs.binned_candidates(x, x[:64], v, 0, metric="chord", nbins=64, block=64)
    f = torch.zeros((256, 3))
    with pytest.raises(TypeError):      # K3 takes every pair, each half in its own type
        tbs.binned_candidates_pair(f, f, f[:64], f[:64], v, v, 0, metricA="chord3",
                                   metricB="dot", nbins=64, block=64)
    with pytest.raises(ValueError):     # the pair's panels share their rows
        tbs.binned_candidates_pair(f, f[:128], f[:64], f[:64], v, v[:128], 0,
                                   metricA="chord3", metricB="l1", nbins=64, block=64)
    with pytest.raises(ValueError):     # rows outside the panel need their row_stats
        tbs.binned_candidates(x.to(torch.int8), x[:64].to(torch.int8), v, -64,
                              metric="jaccard", nbins=64, block=64,
                              row_sums=torch.zeros(256))
    with pytest.raises(TypeError):      # row_stats are the rows' own (block,)
        tbs.binned_candidates(x.to(torch.int8), x[:64].to(torch.int8), v, 0,
                              metric="jaccard", nbins=64, block=64,
                              row_sums=torch.zeros(256), row_stats=torch.zeros(256))
