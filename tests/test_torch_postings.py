"""The postings route of K2 / K3 on the CPU: the postings layout of a sparse
column panel (``blocked_select.build_postings``) against a numpy build from
the dense panel, and K2's plain version fed from the postings
(``binned_candidates_postings_plain``, the kernel's summation order) against
the dense plain version and the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs.

Tolerances: bit-equal.  Tags are 0/1 counts and the dot panels multiples of
1/4, whose f32 sums are exact in any order; real-valued dot is held bit for
bit to a numpy emulation of the kernel's order (ascending features, one
rounding per step) and to the dense plain version within f32 reassociation
(1e-6 on rows of norm 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops.pallas import blocked_select as jbs
from mused_tpu_torch.data.ingest import to_device
from mused_tpu_torch.data.synthetic import make_stream
from mused_tpu_torch.engine import streaming
from mused_tpu_torch.ops import blocked_affinity as tba
from mused_tpu_torch.ops.kernels import blocked_select as tbs
from mused_tpu_torch.parallel import colsharded as tcs
from mused_tpu_torch.utils.config import FeatureConfig, PipelineConfig
from torch_parity import n as tonp, t

N, BLOCK = 1024, 128


def _window(n=N):
    """The port's featurized first window of a seeded synthetic stream, with
    a few valid rows whose tag list is empty (no ids) and its columns."""
    mods, _, _ = make_stream(n, noise_rate=0.95, binary=True, seed=0)
    cfg = PipelineConfig(seed=0, subset_size=n, window_size=n, k_basis=5,
                         approach="SWFDMC", force_blocked_window=True)
    engine = streaming.StreamingEngine(cfg, "cpu")
    host = engine.featurize([m[:n] for m in mods], streaming.STANDARD_TYPES)
    tags_ids = host.tags_ids.copy()
    tags_ids[3:9] = -1                           # empty tag lists ...
    tags_valid = host.tags_valid.copy()
    tags_valid[3:9] = True                       # ... that are valid rows
    host = host._replace(tags_ids=tags_ids, tags_valid=tags_valid)
    feats = to_device(host, torch.device("cpu"))
    return host, feats, engine.columns(host, feats, streaming.STANDARD_TYPES)


def _numpy_postings(panel: np.ndarray, unit: int = tbs.POSTINGS_UNIT):
    """(table, cols, vals) of a dense panel: each feature's nonzero columns in
    ascending order, and each feature's first entry at every unit step."""
    n, k = panel.shape
    cols, vals, table = [], [], np.zeros((k, -(-n // unit) + 1), np.int64)
    for f in range(k):
        c = np.nonzero(panel[:, f])[0]
        base = len(cols)
        table[f] = base + np.searchsorted(c, np.minimum(np.arange(table.shape[1]) * unit, n))
        cols.extend(c.tolist())
        vals.extend(panel[c, f].tolist())
    return table, np.asarray(cols, np.int64), np.asarray(vals, np.float32)


def _assert_postings_equal(post, panel):
    table, cols, vals = _numpy_postings(tonp(panel.float()))
    e = len(cols)
    np.testing.assert_array_equal(tonp(post.table), table)
    assert int(post.entries) == e
    np.testing.assert_array_equal(tonp(post.cols[:e]), cols)
    np.testing.assert_array_equal(tonp(post.vals[:e].float()), vals)
    assert post.vals.dtype == panel.dtype and post.n == panel.shape[0]


@pytest.mark.parametrize("kind", ["tags", "text_bf16"])
def test_window_postings_equal_a_numpy_build(kind):
    """The column builders' postings (from the token ids) of a make_stream
    window, empty tag lists included, against a numpy build from the
    dense panel."""
    host, _, cols = _window()
    i = cols.kinds.index(kind)
    panel = cols.tensors[i][0] if kind == "tags" else cols.tensors[i]
    post = cols.postings_of()[i]
    assert post.cols.numel() == N * (host.tags_ids if kind == "tags" else host.text_ids).shape[1]
    _assert_postings_equal(post, panel)
    if kind == "tags":                            # the empty tag lists hold no entry
        live = post.cols[:int(post.entries)]
        assert not bool(torch.any((live >= 3) & (live < 9)))


@pytest.mark.parametrize("kind, cap", [("tags", 24), ("text", 96)])
def test_a_row_at_the_token_cap(kind, cap):
    """A row of ``cap`` distinct tokens (the featurizer's cap) keeps every
    one; duplicates and -1 padding hold no entry; the dense build (no ids)
    gives the same layout."""
    rng = np.random.default_rng(3)
    k = 2048 if kind == "tags" else 4096
    n = 256
    ids = np.full((n, cap), -1, np.int64)
    for r in range(n):
        m = rng.integers(0, 4)
        ids[r, :m] = rng.choice(k, m, replace=False)
    ids[17] = rng.choice(k, cap, replace=False)     # the token cap
    ids[18, :3] = [5, 5, 9]                          # a duplicate
    panel = np.zeros((n, k), np.float32)
    for r in range(n):
        for f in ids[r][ids[r] >= 0]:
            panel[r, f] = 1.0 if kind == "tags" else rng.integers(1, 8) / 4
    tp = t(panel).to(torch.int8 if kind == "tags" else torch.bfloat16)
    post = tbs.build_postings(tp, t(ids))
    _assert_postings_equal(post, tp)
    assert int((post.cols[:int(post.entries)] == 17).sum()) == cap
    dense = tbs.build_postings(tp)
    assert dense.cols.numel() == n * k
    e = int(post.entries)
    assert torch.equal(dense.table, post.table)
    assert torch.equal(dense.cols[:e], post.cols[:e]) and torch.equal(dense.vals[:e], post.vals[:e])


def _sparse(metric, rng, n=N, k=256, integer=True):
    """A panel of 0-6 nonzeros per row (some rows empty, a duplicated row)
    and its token ids; jaccard 0/1 int8, dot multiples of 1/4 or real."""
    ids = np.full((n, 8), -1, np.int64)
    for r in range(n):
        m = rng.integers(0, 7)
        ids[r, :m] = rng.choice(k, m, replace=False)
    ids[9] = ids[9 + n // 2]
    panel = np.zeros((n, k), np.float32)
    for r in range(n):
        for f in ids[r][ids[r] >= 0]:
            if metric == "jaccard":
                panel[r, f] = 1.0
            else:
                panel[r, f] = rng.integers(1, 8) / 4 if integer else rng.random() + 0.05
    if metric == "dot" and not integer:
        panel /= np.maximum(np.linalg.norm(panel, axis=1, keepdims=True), 1e-12)
    return panel, ids


def _jax_k2(x, rows, valid, start, metric, nbins, sums, row_stats):
    jdt = jnp.int8 if metric == "jaccard" else jnp.bfloat16
    return jbs.binned_candidates_pallas(
        jnp.asarray(x).astype(jdt), jnp.asarray(rows).astype(jdt), jnp.asarray(valid),
        jnp.int32(start), metric=metric, nbins=nbins, block=BLOCK,
        row_sums=None if sums is None else jnp.asarray(sums),
        row_stats=None if row_stats is None else jnp.asarray(row_stats), tn=128,
        interpret=True)


@pytest.mark.parametrize("start", [256, -BLOCK, N - 3])
@pytest.mark.parametrize("nbins", [N, N // 4])
@pytest.mark.parametrize("metric", ["jaccard", "dot"])
def test_plain_k2_from_postings_equals_dense_plain_and_jax(metric, nbins, start):
    """The plain K2 fed from the postings equals the dense plain version and
    the JAX kernel (interpret mode) bit for bit; rows from another shard with
    their own statistics where ``start`` lies outside the panel."""
    rng = np.random.default_rng(5)
    panel, ids = _sparse(metric, rng, n=N + BLOCK)
    x, xr = panel[:N], (panel[start:start + BLOCK] if 0 <= start <= N - BLOCK
                        else panel[N:])
    valid = rng.random(N) > 0.1
    sums = x.sum(1) if metric == "jaccard" else None
    row_stats = xr.sum(1) if metric == "jaccard" and not 0 <= start <= N - BLOCK else None
    tdt = torch.int8 if metric == "jaccard" else torch.bfloat16
    tx, txr = t(x).to(tdt), t(np.ascontiguousarray(xr)).to(tdt)
    post = tbs.build_postings(tx, t(ids[:N]))
    kw = dict(metric=metric, nbins=nbins, block=BLOCK,
              row_sums=None if sums is None else t(sums),
              row_stats=None if row_stats is None else t(row_stats))
    got = tbs.binned_candidates_postings_plain(post, txr, t(valid), start, **kw)
    dense = tbs.binned_candidates_plain(tx, txr, t(valid), start, **kw)
    wrapped = tbs.binned_candidates(tx, txr, t(valid), start, postings=post, **kw)
    want = _jax_k2(x, xr, valid, start, metric, nbins, sums, row_stats)
    for a, b in ((got, dense), (got, wrapped)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    np.testing.assert_array_equal(tonp(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(tonp(got[1]), np.asarray(want[1]))


def test_postings_strip_sums_in_the_kernels_order():
    """Real-valued dot through the postings: bit-equal to numpy adding each
    row's products in ascending feature order with one f32 rounding per
    step, and within 1e-6 of the dense product."""
    rng = np.random.default_rng(6)
    panel, ids = _sparse("dot", rng, integer=False)
    tx = t(panel).to(torch.bfloat16)
    post = tbs.build_postings(tx, t(ids))
    rows = tx[:BLOCK]
    got = tonp(tbs.postings_sim_strip(post, rows, "dot"))
    xf, rf = tonp(tx.float()), tonp(rows.float())
    want = np.zeros((BLOCK, N), np.float32)
    for f in range(xf.shape[1]):
        prod = (rf[:, f][:, None] * xf[:, f][None, :]).astype(np.float32)   # exact
        live = (rf[:, f] != 0)[:, None] & (xf[:, f] != 0)[None, :]
        want = np.where(live, (want + prod).astype(np.float32), want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, rf @ xf.T, rtol=0, atol=1e-6)


def test_wrappers_check_the_postings():
    rng = np.random.default_rng(7)
    panel, ids = _sparse("jaccard", rng)
    x = t(panel).to(torch.int8)
    post = tbs.build_postings(x, t(ids))
    valid = torch.ones(N, dtype=torch.bool)
    sums = x.float().sum(1)
    kw = dict(nbins=256, block=BLOCK, row_sums=sums)
    with pytest.raises(ValueError, match="nbins"):
        tbs.binned_candidates(x, x[:BLOCK], valid, 0, metric="jaccard", postings=post,
                              **{**kw, "nbins": 64})
    with pytest.raises(ValueError, match="do not fit"):
        tbs.binned_candidates(x[:512], x[:BLOCK], valid[:512], 0, metric="jaccard",
                              postings=post, **{**kw, "row_sums": sums[:512]})
    with pytest.raises(ValueError, match="do not fit"):
        xb = x.to(torch.bfloat16)
        tbs.binned_candidates(xb, xb[:BLOCK], valid, 0, metric="dot", postings=post,
                              nbins=256, block=BLOCK)
    with pytest.raises(ValueError, match="postings route takes"):
        xb = x.to(torch.bfloat16)
        tbs.binned_candidates(xb, xb[:BLOCK], valid, 0, metric="chord", postings=post,
                              nbins=256, block=BLOCK, row_sums=sums)
    with pytest.raises(TypeError, match="Postings"):
        tbs.binned_candidates(x, x[:BLOCK], valid, 0, metric="jaccard", postings=(1, 2),
                              **kw)
    with pytest.raises(ValueError, match="both or neither"):
        tbs.binned_candidates_pair(x, x, x[:BLOCK], x[:BLOCK], valid, valid, 0,
                                   metricA="jaccard", metricB="jaccard", nbins=256,
                                   block=BLOCK, row_sumsA=sums, row_sumsB=sums,
                                   postingsA=post)


def test_routes_follow_the_operands():
    post = tbs.build_postings(torch.zeros((256, 128), dtype=torch.int8))
    assert tbs.route("jaccard", post) == "postings" and tbs.route("jaccard") == "mma"
    assert tbs.route("l1") == "coordinate"
    assert tbs.pair_route("jaccard", "dot", postings=True) == "postings"
    assert tbs.pair_route("jaccard", "dot") == "mma"
    assert [tbs.takes_postings(b) for b in (1536, 4096, 16384, 320, 32768, 0)] == [
        True, True, True, False, False, False]


def test_engine_columns_and_colsharded_prep_carry_the_same_postings():
    """The single-device column builder and the column-sharded sweep's prep
    (one shard) hold equal panels and postings for tags and text; a panel
    handed in on the CPU gains none (the plain versions read none)."""
    host, feats, cols = _window()
    mods = tcs._prep_local_modalities(tuple(feats), streaming.types_for(
        host, streaming.STANDARD_TYPES), 5, FeatureConfig().tags_hash_dim,
        FeatureConfig().text_hash_dim, _OneRank())
    by_metric = {m[0]: m for m in mods}
    for kind, metric in (("tags", "jaccard"), ("text_bf16", "dot")):
        i = cols.kinds.index(kind)
        panel = cols.tensors[i][0] if kind == "tags" else cols.tensors[i]
        assert torch.equal(by_metric[metric][1], panel)
        for a, b in zip(by_metric[metric][5], cols.postings_of()[i]):
            assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    bare = cols._replace(postings=None)
    assert tba.hoist_columns(bare).postings_of() == (None,) * len(cols.kinds)


class _OneRank:
    """World size 1 on the CPU: every collective is the identity."""

    size, index = 1, 0

    def psum(self, x):
        return x
