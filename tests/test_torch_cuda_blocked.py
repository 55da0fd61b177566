"""The huge-window kernels K2-K5 against their plain versions on a CUDA device.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_blocked.py

The union kernel (``bs.union_rowblock``) writes a rebuilt row block of
the fused adjacency; it is held to its plain version
(``cm.dense_rows_reference``) on the same candidates, and the blocked SVD
through it to the SVD of the plain version's blocks.

Tolerances: bit-equal.  Operands are multiples of 1/4 (dot, chord), small
integers (K4, K5) or 0/1 counts (jaccard), whose f32 sums are exact in any
order, and chord3 / l1 run unfused in the plain version's order; K5's live
columns against padded ones sum real values in the same order.  Random unit rows (dot) are
held to f32 reassociation: |error| <= 1e-5 on values in [-1, 1].  K2's
tensor-core metrics split the groups over the CTAs of a cluster; the ties
case checks that the merge keeps the lowest group.
"""
import functools

import pytest
import torch

from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.ops.kernels import cand_matvec as cm
from cand_cases import CASES as CAND_CASES, cand_case, torch_cand

# (n, nbins, block, start, K): an aligned case, a ragged one, and 64-byte
# int8 rows (narrower than one 128-byte TMA box)
SHAPES = [(1024, 256, 256, 256, 128), (960, 320, 200, 100, 192), (512, 128, 128, 0, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(metric, n, k, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    if metric == "jaccard":
        x = (torch.rand((n, k), generator=g) < 0.08).to(torch.int8)
        return x.to(device), x.float().sum(1).to(device)
    if metric in ("dot", "chord"):
        x = (torch.randint(-3, 4, (n, k), generator=g) / 4).to(torch.bfloat16)
        sq = x.float().pow(2).sum(1).to(device) if metric == "chord" else None
        return x.to(device), sq
    cols = 3 if metric == "chord3" else 2
    x = torch.rand((n, cols), generator=g) * 100
    x[5] = x[5 + n // 2]                     # equal values in two groups
    return x.to(device), None


def _valid(n, device):
    v = torch.rand(n, generator=torch.Generator().manual_seed(1)) > 0.1
    return v.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", ["jaccard", "dot", "chord", "chord3", "l1"])
def test_k2_matches_plain_on_cuda(metric, shape, cuda):
    n, nbins, block, start, k = shape
    x, sums = _operands(metric, n, k if metric in bs.MMA_METRICS else 0, cuda)
    valid = _valid(n, cuda)
    rows = x[start:start + block]
    before = bs.launches
    got = bs.binned_candidates(x, rows, valid, start, metric=metric, nbins=nbins,
                               block=block, row_sums=sums)
    want = bs.binned_candidates_plain(x, rows, valid, start, metric=metric, nbins=nbins,
                                      block=block, row_sums=sums)
    torch.cuda.synchronize()
    assert bs.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_k2_dot_on_random_unit_rows(cuda):
    n, nbins, block, start = 1024, 256, 256, 512
    x = torch.randn((n, 256), generator=torch.Generator().manual_seed(2))
    x = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16).to(cuda)
    valid = _valid(n, cuda)
    got = bs.binned_candidates(x, x[start:start + block], valid, start, metric="dot",
                               nbins=nbins, block=block)
    want = bs.binned_candidates_plain(x, x[start:start + block], valid, start,
                                      metric="dot", nbins=nbins, block=block)
    assert (got[0] - want[0]).abs().max().item() <= 1e-5
    assert (got[1] == want[1]).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_k3_equals_two_k2_launches(shape, cuda):
    n, nbins, block, start, _ = shape
    xyz, _ = _operands("chord3", n, 0, cuda, seed=3)
    tim, _ = _operands("l1", n, 0, cuda, seed=4)
    va, vb = _valid(n, cuda), _valid(n, cuda).roll(7)
    rows = slice(start, start + block)
    before = bs.pair_launches
    pair = bs.binned_candidates_pair(xyz, tim, xyz[rows], tim[rows], va, vb, start,
                                     metricA="chord3", metricB="l1", nbins=nbins,
                                     block=block)
    singles = (*bs.binned_candidates(xyz, xyz[rows], va, start, metric="chord3",
                                     nbins=nbins, block=block),
               *bs.binned_candidates(tim, tim[rows], vb, start, metric="l1",
                                     nbins=nbins, block=block))
    torch.cuda.synchronize()
    assert bs.pair_launches == before + 1
    for p, s in zip(pair, singles):
        assert torch.equal(p, s)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["dot", "jaccard"])
def test_k2_at_the_real_width_on_three_groups(metric, cuda):
    """Text (K = 4096 bf16) and tags (K = 2048 int8) widths on an 8190-column,
    3-group panel (2730 slots: a ragged slot tile), integer-valued."""
    n, nbins, block, start = 8190, 2730, 2048, 1000
    x, sums = _operands(metric, n, 4096 if metric == "dot" else 2048, cuda)
    valid = _valid(n, cuda)
    rows = x[start:start + block]
    got = bs.binned_candidates(x, rows, valid, start, metric=metric, nbins=nbins,
                               block=block, row_sums=sums)
    want = bs.binned_candidates_plain(x, rows, valid, start, metric=metric, nbins=nbins,
                                      block=block, row_sums=sums)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["dot", "jaccard", "chord"])
def test_k2_ties_keep_the_lowest_group_across_splits(metric, cuda):
    """Every group holds the same columns, so every slot ties across the four
    groups; the groups are split over the CTAs of a cluster, and the merge
    must keep the lowest group that is not masked (invalid or self)."""
    n, nbins, block, start = 1024, 256, 256, 256
    base, sums = _operands(metric, nbins, 128, cuda)
    x = base.repeat(4, 1).contiguous()
    sums = None if sums is None else sums.repeat(4).contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    valid[::7] = False
    assert bs.kernel_splits(n, block, nbins, metric) > 1
    rows = x[start:start + block]
    got = bs.binned_candidates(x, rows, valid, start, metric=metric, nbins=nbins,
                               block=block, row_sums=sums)
    want = bs.binned_candidates_plain(x, rows, valid, start, metric=metric, nbins=nbins,
                                      block=block, row_sums=sums)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1] == 0).float().mean().item() > 0.5


# CLIP ViT-L/14's width (K = 768 bf16 embeddings) on the tensor-core route: the
# crisis cell's window (98,304 columns, nbins 1536, its last block) and a
# ragged 3-group panel
CLIP_SHAPES = [(98_304, 1536, 2048, 96_256), (8190, 2730, 2048, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CLIP_SHAPES)
def test_k2_dot_at_the_clip_width(shape, cuda):
    """Integer-valued operands (multiples of 1/4): bit-equal to the plain
    version, on one launch of the tensor-core tiles."""
    n, nbins, block, start = shape
    x, _ = _operands("dot", n, 768, cuda, seed=6)
    valid = _valid(n, cuda)
    rows = x[start:start + block]
    before = bs.launches
    got = bs.binned_candidates(x, rows, valid, start, metric="dot", nbins=nbins, block=block)
    want = bs.binned_candidates_plain(x, rows, valid, start, metric="dot", nbins=nbins,
                                      block=block)
    torch.cuda.synchronize()
    assert bs.launches == before + 1 and bs.route("dot") == "mma"
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_k2_dot_on_random_clip_width_unit_rows(cuda):
    """Unit bf16 rows at K = 768, n = 98,304: f32 reassociation only."""
    n, nbins, block, start = 98_304, 1536, 2048, 47_104
    x = torch.randn((n, 768), generator=torch.Generator().manual_seed(7))
    x = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16).to(cuda)
    valid = _valid(n, cuda)
    rows = x[start:start + block]
    got = bs.binned_candidates(x, rows, valid, start, metric="dot", nbins=nbins, block=block)
    want = bs.binned_candidates_plain(x, rows, valid, start, metric="dot", nbins=nbins,
                                      block=block)
    assert (got[0] - want[0]).abs().max().item() <= 1e-5
    assert (got[1] == want[1]).float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CLIP_SHAPES)
def test_k3_dot_pair_at_the_clip_width_equals_two_k2_launches(shape, cuda):
    """Two 768-wide embedding panels in one K3 launch of the tensor-core
    tiles: each half bit-equal to its K2 launch and to the plain version."""
    n, nbins, block, start = shape
    a, _ = _operands("dot", n, 768, cuda, seed=8)
    b, _ = _operands("dot", n, 768, cuda, seed=9)
    va, vb = _valid(n, cuda), _valid(n, cuda).roll(5)
    rows = slice(start, start + block)
    before = bs.pair_launches
    pair = bs.binned_candidates_pair(a, b, a[rows], b[rows], va, vb, start, metricA="dot",
                                     metricB="dot", nbins=nbins, block=block)
    singles = (*bs.binned_candidates(a, a[rows], va, start, metric="dot", nbins=nbins,
                                     block=block),
               *bs.binned_candidates(b, b[rows], vb, start, metric="dot", nbins=nbins,
                                     block=block))
    plain = (*bs.binned_candidates_plain(a, a[rows], va, start, metric="dot", nbins=nbins,
                                         block=block),
             *bs.binned_candidates_plain(b, b[rows], vb, start, metric="dot", nbins=nbins,
                                         block=block))
    torch.cuda.synchronize()
    assert bs.pair_launches == before + 1 and bs.pair_route("dot", "dot") == "mma"
    for p, s, q in zip(pair, singles, plain):
        assert torch.equal(p, s) and torch.equal(p, q)


def _k3_all_three(xyz, tim, va, vb, start, nbins, block):
    """(pair, two K2 singles, plain) outputs of the location + time pair."""
    rows = slice(start, start + block)
    kw = dict(nbins=nbins, block=block)
    before = bs.pair_launches
    pair = bs.binned_candidates_pair(xyz, tim, xyz[rows], tim[rows], va, vb, start,
                                     metricA="chord3", metricB="l1", **kw)
    singles = (*bs.binned_candidates(xyz, xyz[rows], va, start, metric="chord3", **kw),
               *bs.binned_candidates(tim, tim[rows], vb, start, metric="l1", **kw))
    plain = (*bs.binned_candidates_plain(xyz, xyz[rows], va, start, metric="chord3", **kw),
             *bs.binned_candidates_plain(tim, tim[rows], vb, start, metric="l1", **kw))
    torch.cuda.synchronize()
    assert bs.pair_launches == before + 1
    return pair, singles, plain


# (n, nbins, block, start) per case
K3_CASES = {
    "self_columns_straddle_a_group_boundary": (1024, 256, 256, 200),
    "a_group_with_every_column_invalid": (1024, 256, 256, 512),
    "the_same_column_in_every_group": (1024, 256, 256, 300),
    "ragged_slot_tile": (1000, 200, 130, 37),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_edge_cases_equal_two_k2_and_plain(case, cuda):
    """Self columns in two groups of one 16-row tile, an all-invalid group,
    ties across every group (the lowest valid, not-self group must win) and
    a slot count that is no multiple of the kernel's slot tile: K3's four
    outputs bit-equal to two K2 launches and to the plain version."""
    n, nbins, block, start = K3_CASES[case]
    groups = n // nbins
    if case == "self_columns_straddle_a_group_boundary":
        assert (start + block) // nbins > start // nbins
    xyz, _ = _operands("chord3", n, 0, cuda, seed=3)
    tim, _ = _operands("l1", n, 0, cuda, seed=4)
    va, vb = _valid(n, cuda), _valid(n, cuda).roll(7)
    if case == "a_group_with_every_column_invalid":
        va[nbins:2 * nbins] = False
        vb[2 * nbins:3 * nbins] = False
    if case == "the_same_column_in_every_group":
        xyz = xyz[:nbins].repeat(groups, 1).contiguous()
        tim = tim[:nbins].repeat(groups, 1).contiguous()
    pair, singles, plain = _k3_all_three(xyz, tim, va, vb, start, nbins, block)
    for p, s, w in zip(pair, singles, plain):
        assert torch.equal(p, s) and torch.equal(p, w)
    if case == "the_same_column_in_every_group":
        assert (pair[1] == 0).float().mean().item() > 0.5


def _cand(device, block, nbins, groups, n_mod=4, with_user=True, seed=5):
    g = torch.Generator().manual_seed(seed)
    slabs = torch.randint(-1, groups, (n_mod, block, nbins), generator=g).to(torch.int8)
    slabs[torch.rand(slabs.shape, generator=g) < 0.7] = -1
    uid_r = (torch.randint(-1, 9, (block, 1), generator=g).to(torch.int32)
             if with_user else None)
    uid_c = (torch.randint(-2, 9, (groups, nbins), generator=g) if with_user
             else torch.full((groups, nbins), -2)).to(torch.int32)
    return cm.CandBlock(slabs.to(device), None if uid_r is None else uid_r.to(device),
                        uid_c.to(device), start=nbins // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("with_user", [True, False])
@pytest.mark.parametrize("dims", [(256, 256, 4, 128), (200, 320, 3, 100), (128, 128, 40, 256)])
def test_k4_k5_match_plain_on_cuda(dims, with_user, cuda):
    block, nbins, groups, r = dims
    cand = _cand(cuda, block, nbins, groups, with_user=with_user)
    g = torch.Generator().manual_seed(6)
    x_t = torch.randint(-4, 5, (r, block), generator=g).to(torch.bfloat16).to(cuda)
    y = torch.randint(-4, 5, (groups * nbins, r), generator=g).to(torch.bfloat16).to(cuda)
    before = (cm.launches_t, cm.launches)
    out_t, edges = cm.matvec_t(cand, x_t)
    out = cm.matvec(cand, y)
    want_t, want_edges = cm.matvec_t_reference(cand, x_t)
    want = cm.matvec_reference(cand, y)
    torch.cuda.synchronize()
    assert (cm.launches_t, cm.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out_t, want_t) and torch.equal(out, want)
    assert edges.item() == want_edges.item() == cm.dense_rows_reference(cand).sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(2048, 1536, 3, 72), (333, 101, 5, 72), (256, 256, 4, 66),
                                  (256, 256, 4, 132), (200, 320, 3, 300)])
def test_k4_tensor_core_shapes(dims, cuda):
    """K4 at the fold's live widths (r = 66, 72, 132), odd block / nbins (the
    unvectorised staging) and several r tiles (r = 300), integer-valued:
    bit-equal, with the edge count exact."""
    block, nbins, groups, r = dims
    cand = _cand(cuda, block, nbins, groups)
    g = torch.Generator().manual_seed(7)
    x_t = torch.randint(-4, 5, (r, block), generator=g).to(torch.bfloat16).to(cuda)
    out_t, edges = cm.matvec_t(cand, x_t)
    want_t, want_edges = cm.matvec_t_reference(cand, x_t)
    torch.cuda.synchronize()
    assert torch.equal(out_t, want_t)
    assert edges.item() == want_edges.item() == cm.dense_rows_reference(cand).sum().item()


@pytest.mark.cuda
def test_k4_live_rows_equal_padded_rows(cuda):
    """K4 on the fold's 66 live rows gives the same bits as on those rows
    zero-padded to 128 (the JAX package's operand width)."""
    cand = _cand(cuda, 512, 384, 4)
    x = torch.randn((66, 512), generator=torch.Generator().manual_seed(8))
    x_t = x.to(torch.bfloat16).to(cuda)
    live, _ = cm.matvec_t(cand, x_t)
    padded, _ = cm.matvec_t(cand, torch.nn.functional.pad(x_t, (0, 0, 0, 62)).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(live, padded[:66])
    assert not torch.any(padded[66:])


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((256, 128), dtype=torch.bfloat16, device=cuda)
    v = torch.ones(256, dtype=torch.bool, device=cuda)
    kw = dict(metric="dot", nbins=64, block=64)
    with pytest.raises(TypeError):                    # dtype
        bs.binned_candidates(x.float(), x[:64].float(), v, 0, **kw)
    with pytest.raises(ValueError):                   # device
        bs.binned_candidates(x, x[:64], v.cpu(), 0, **kw)
    with pytest.raises(ValueError):                   # shape
        bs.binned_candidates(x, x[:32], v, 0, **kw)
    with pytest.raises(ValueError):                   # contiguity
        wide = torch.zeros((256, 256), dtype=torch.bfloat16, device=cuda)
        bs.binned_candidates(wide[:, :128], wide[:64, :128], v, 0, **kw)
    with pytest.raises(ValueError):                   # feature width not 64 bytes
        odd = torch.zeros((256, 40), dtype=torch.bfloat16, device=cuda)
        bs.binned_candidates(odd, odd[:64], v, 0, **kw)
    cand = _cand(cuda, 64, 64, 4)
    with pytest.raises(TypeError):                    # dtype
        cm.matvec_t(cand, torch.zeros((128, 64), device=cuda))
    with pytest.raises(ValueError):                   # device
        cm.matvec_t(cand, torch.zeros((128, 64), dtype=torch.bfloat16))
    with pytest.raises(ValueError):                   # shape
        cm.matvec(cand, torch.zeros((100, 128), dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError):                   # contiguity
        cm.matvec(cand, torch.zeros((128, 256), dtype=torch.bfloat16, device=cuda).T)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(2048, 1536, 64, 66), (2048, 1536, 64, 72),
                                  (2048, 1536, 64, 132), (333, 101, 5, 66),
                                  (256, 256, 4, 67), (200, 320, 3, 300)])
def test_k5_tensor_core_shapes(dims, cuda):
    """K5 at the real block (2048 x 1536, 64 groups) at the fold's live
    r = 66 and at 72 / 132, odd block / nbins and odd r (the unvectorised
    staging) and several r tiles (r = 300), integer-valued: bit-equal."""
    block, nbins, groups, r = dims
    cand = _cand(cuda, block, nbins, groups)
    g = torch.Generator().manual_seed(9)
    y = torch.randint(-4, 5, (groups * nbins, r), generator=g).to(torch.bfloat16).to(cuda)
    before = cm.launches
    out = cm.matvec(cand, y)
    want = cm.matvec_reference(cand, y)
    torch.cuda.synchronize()
    assert cm.launches == before + 1
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_k5_live_columns_equal_padded_columns(cuda):
    """K5 on the fold's 66 live columns gives the same bits as on those
    columns zero-padded to 128 (the JAX package's operand width)."""
    cand = _cand(cuda, 512, 384, 4)
    y = torch.randn((4 * 384, 66), generator=torch.Generator().manual_seed(10))
    y = y.to(torch.bfloat16).to(cuda)
    live = cm.matvec(cand, y)
    padded = cm.matvec(cand, torch.nn.functional.pad(y, (0, 62)).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(live, padded[:, :66])
    assert not torch.any(padded[:, 66:])


@pytest.mark.cuda
@pytest.mark.parametrize("with_user", [True, False])
def test_k4_k5_self_columns_inside_the_block(with_user, cuda):
    """start and g0 put each row's own column inside the block's groups
    (local groups 1-3), and every valid uid equals the rows' uid, so only
    the self exclusion keeps those entries out: K4 and K5 bit-equal."""
    block, nbins, groups = 256, 128, 6
    cand = _cand(cuda, block, nbins, groups, with_user=with_user)
    cand = cand._replace(start=3 * nbins + 17, g0=2)
    if with_user:
        g = torch.Generator().manual_seed(11)
        uid_c = torch.where(torch.rand((groups, nbins), generator=g) < 0.2, -2, 5)
        cand = cand._replace(uid_rows=torch.full((block, 1), 5, dtype=torch.int32, device=cuda),
                             uid_cols=uid_c.to(torch.int32).to(cuda))
    g = torch.Generator().manual_seed(12)
    y = torch.randint(-4, 5, (groups * nbins, 66), generator=g).to(torch.bfloat16).to(cuda)
    x_t = torch.randint(-4, 5, (66, block), generator=g).to(torch.bfloat16).to(cuda)
    out = cm.matvec(cand, y)
    out_t, edges = cm.matvec_t(cand, x_t)
    want_t, want_edges = cm.matvec_t_reference(cand, x_t)
    want = cm.matvec_reference(cand, y)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(out_t, want_t)
    assert edges.item() == want_edges.item()


# ---------------------------------------------------------------------------
# the postings route (text dot, tags jaccard)
# ---------------------------------------------------------------------------

def _sparse_panel(metric, n, k, device, per_row=5, seed=11, integer=True):
    """A panel of ``per_row`` nonzeros or fewer per row (some rows empty, one
    row at 300 nonzeros: past the kernel's 128 terms held at once) and its
    token ids; jaccard 0/1 counts, dot multiples of 1/4 (``integer``) or
    random unit rows."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, k, (n, per_row), generator=g)
    ids[torch.rand((n, per_row), generator=g) < 0.3] = -1
    ids[::17] = -1                                    # empty rows
    wide = torch.randperm(k, generator=g)[:300]
    ids = torch.cat([ids, torch.full((n, 300 - per_row), -1, dtype=torch.long)], dim=1)
    ids[5] = wide                                     # a row of 300 terms
    x = torch.zeros((n, k))
    live = ids >= 0
    rows = torch.arange(n)[:, None].expand_as(ids)
    if metric == "jaccard":
        x[rows[live], ids[live]] = 1.0
        x = x.to(torch.int8)
        return x.to(device), ids.to(device), x.float().sum(1).to(device)
    if integer:
        x[rows[live], ids[live]] = (torch.randint(1, 8, (int(live.sum()),), generator=g) / 4)
    else:
        x[rows[live], ids[live]] = torch.rand(int(live.sum()), generator=g) + 0.05
        x = x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)
    return x.to(torch.bfloat16).to(device), ids.to(device), None


POSTINGS_SHAPES = [(1024, 256, 256, 256), (1536, 384, 200, 100), (2048, 2048, 128, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", POSTINGS_SHAPES)
@pytest.mark.parametrize("case", ["jaccard", "dot_integer", "dot_real"])
def test_k2_postings_route_matches_plain(case, shape, cuda):
    """Bit-equal to the postings plain version (the kernel's summation order)
    always, and to the dense plain version for jaccard and integer-valued
    dot; real dot within 1e-5 with >= 99.9% of groups and kept edges."""
    n, nbins, block, start = shape
    metric = "jaccard" if case == "jaccard" else "dot"
    x, ids, sums = _sparse_panel(metric, n, 2048 if metric == "jaccard" else 4096, cuda,
                                 integer=case != "dot_real")
    post = bs.build_postings(x, ids)
    valid = _valid(n, cuda)
    rows = x[start:start + block]
    kw = dict(metric=metric, nbins=nbins, block=block, row_sums=sums)
    before = (bs.launches, bs.postings_launches)
    got = bs.binned_candidates(x, rows, valid, start, postings=post, **kw)
    again = bs.binned_candidates(x, rows, valid, start, postings=post, **kw)
    same_order = bs.binned_candidates_postings_plain(post, rows, valid, start, **kw)
    want = bs.binned_candidates_plain(x, rows, valid, start, **kw)
    torch.cuda.synchronize()
    assert (bs.launches, bs.postings_launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[0], same_order[0]) and torch.equal(got[1], same_order[1])
    if case != "dot_real":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert (got[0] - want[0]).abs().max().item() <= 1e-5
        assert (got[1] == want[1]).float().mean().item() >= 0.999
        rv = valid[start:start + block]
        keep = [bs.budgeted_keep(v, rv, 5) for v in (got[0], want[0])]
        agree = (keep[0] & keep[1]).sum() / (keep[0] | keep[1]).sum().clamp(min=1)
        assert agree.item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["dot", "jaccard"])
def test_k2_postings_ties_keep_the_lowest_group(metric, cuda):
    """Every group holds the same columns, so every slot ties across the
    groups, which the kernel takes in steps of several groups: the lowest
    group that is not masked (invalid or self) must win."""
    n, nbins, block, start = 4096, 256, 256, 256
    base, ids, sums = _sparse_panel(metric, nbins, 2048, cuda, seed=12)
    x = base.repeat(n // nbins, 1).contiguous()
    ids = ids.repeat(n // nbins, 1).contiguous()
    sums = None if sums is None else sums.repeat(n // nbins).contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    valid[::7] = False
    post = bs.build_postings(x, ids)
    rows = x[start:start + block]
    kw = dict(metric=metric, nbins=nbins, block=block, row_sums=sums)
    got = bs.binned_candidates(x, rows, valid, start, postings=post, **kw)
    want = bs.binned_candidates_plain(x, rows, valid, start, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1] == 0).float().mean().item() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("start", [-256, 1536])
def test_k2_postings_shard_local_start_with_row_stats(start, cuda):
    """Rows of another shard (not a slice of the panel) with their own
    statistics, the start before this shard's columns or past them."""
    n, nbins, block = 1024, 256, 256
    x, ids, sums = _sparse_panel("jaccard", n + block, 2048, cuda, seed=13)
    cols, rows = x[:n].contiguous(), x[n:].contiguous()
    post = bs.build_postings(cols, ids[:n])
    valid = _valid(n, cuda)
    kw = dict(metric="jaccard", nbins=nbins, block=block, row_sums=sums[:n].contiguous(),
              row_stats=sums[n:].contiguous())
    got = bs.binned_candidates(cols, rows, valid, start, postings=post, **kw)
    want = bs.binned_candidates_plain(cols, rows, valid, start, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", POSTINGS_SHAPES)
def test_k3_postings_pair_equals_two_k2_launches(shape, cuda):
    """Tags jaccard + text dot (the column-sharded pair) in one launch on the
    postings route: each output bit-identical to its K2 launch."""
    n, nbins, block, start = shape
    tags, tids, sums = _sparse_panel("jaccard", n, 2048, cuda, seed=14)
    text, xids, _ = _sparse_panel("dot", n, 4096, cuda, seed=15, integer=False)
    pt, px = bs.build_postings(tags, tids), bs.build_postings(text, xids)
    va, vb = _valid(n, cuda), _valid(n, cuda).roll(5)
    rows = slice(start, start + block)
    before = (bs.pair_launches, bs.postings_pair_launches)
    pair = bs.binned_candidates_pair(tags, text, tags[rows], text[rows], va, vb, start,
                                     metricA="jaccard", metricB="dot", nbins=nbins,
                                     block=block, row_sumsA=sums, postingsA=pt, postingsB=px)
    singles = (*bs.binned_candidates(tags, tags[rows], va, start, metric="jaccard",
                                     nbins=nbins, block=block, row_sums=sums, postings=pt),
               *bs.binned_candidates(text, text[rows], vb, start, metric="dot", nbins=nbins,
                                     block=block, postings=px))
    torch.cuda.synchronize()
    assert (bs.pair_launches, bs.postings_pair_launches) == (before[0] + 1, before[1] + 1)
    for p, s in zip(pair, singles):
        assert torch.equal(p, s)


@pytest.mark.cuda
def test_k2_postings_route_against_the_dense_route_on_the_real_block(cuda):
    """The first 2048-row block of a 98,304-row window of the synthetic
    stream (the huge windows' shape, nbins 1536): the postings route keeps
    >= 99.9% of the dense tensor-core route's edges, tags bit-equal."""
    from mused_tpu_torch.data.ingest import to_device
    from mused_tpu_torch.data.synthetic import make_stream
    from mused_tpu_torch.engine import streaming
    from mused_tpu_torch.utils.config import PipelineConfig
    n, block, nbins, k = 98_304, 2048, 1536, 50
    mods, _, _ = make_stream(n, noise_rate=0.95, binary=True, seed=0)
    cfg = PipelineConfig(seed=0, subset_size=n, window_size=n, k_basis=k, approach="SWFDMC")
    engine = streaming.StreamingEngine(cfg, cuda)
    host = engine.featurize([m[:n] for m in mods], streaming.STANDARD_TYPES)
    cols = engine.columns(host, to_device(host, cuda), streaming.STANDARD_TYPES)
    by_kind = dict(zip(cols.kinds, zip(cols.tensors, cols.valids, cols.postings_of())))
    for kind, metric in (("tags", "jaccard"), ("text_bf16", "dot")):
        t, valid, post = by_kind[kind]
        x, sums = t if isinstance(t, tuple) else (t, None)
        kw = dict(metric=metric, nbins=nbins, block=block, row_sums=sums)
        got = bs.binned_candidates(x, x[:block], valid, 0, postings=post, **kw)
        dense = bs.binned_candidates(x, x[:block], valid, 0, **kw)
        torch.cuda.synchronize()
        keep = [bs.budgeted_keep(v, valid[:block], k) for v in (got[0], dense[0])]
        agree = (keep[0] & keep[1]).sum() / (keep[0] | keep[1]).sum().clamp(min=1)
        assert agree.item() >= 0.999, (kind, agree.item())
        if metric == "jaccard":
            assert torch.equal(got[0], dense[0]) and torch.equal(got[1], dense[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned_validity", "nbins_16384"])
def test_k2_postings_staging_paths(case, cuda):
    """The column validity staged byte by byte: a validity view at an odd
    address, and a step of one group wider than 8192 columns."""
    n, nbins, block, start = (2048, 512, 128, 640) if case == "unaligned_validity" else \
        (32_768, 16_384, 64, 20_000)
    x, ids, sums = _sparse_panel("jaccard", n, 2048, cuda, seed=16)
    post = bs.build_postings(x, ids)
    base = torch.rand(n + 1, generator=torch.Generator().manual_seed(3)) > 0.1
    valid = base.to(cuda)[1:] if case == "unaligned_validity" else base[:n].to(cuda)
    assert (valid.data_ptr() % 4 != 0) == (case == "unaligned_validity")
    rows = x[start:start + block]
    kw = dict(metric="jaccard", nbins=nbins, block=block, row_sums=sums)
    got = bs.binned_candidates(x, rows, valid, start, postings=post, **kw)
    want = bs.binned_candidates_plain(x, rows, valid, start, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the union kernel: (block, nbins, groups, planes, start); the two cells'
# shapes at a middle block, then odd widths (the scalar path), eight planes,
# a start before the shard's columns
UNION_SHAPES = [(2048, 4096, 37, 4, 75_776), (2048, 1536, 64, 4, 49_152), (333, 40, 5, 3, 17),
                (200, 101, 7, 8, -50), (64, 48, 3, 1, 0)]
UNION_DTYPES = [torch.bool, torch.bfloat16, torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("with_user", [True, False])
@pytest.mark.parametrize("dims", UNION_SHAPES)
def test_union_rowblock_matches_plain_on_cuda(dims, with_user, cuda):
    block, nbins, groups, planes, start = dims
    cand = _cand(cuda, block, nbins, groups, n_mod=planes, with_user=with_user)._replace(
        start=start)
    want = cm.dense_rows_reference(cand)
    before = bs.union_launches
    for dtype in UNION_DTYPES:
        got = bs.union_rowblock(cand, dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want.to(dtype)), dtype
    assert bs.union_launches == before + len(UNION_DTYPES)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CAND_CASES)
def test_union_rowblock_on_the_candidate_cases(name, cuda):
    """Every rule of the fused tile (tests/cand_cases.py: two planes on one
    group, uids on slab edges and on the own column, self inside and outside
    the block, g0, one user, empty slabs) at nbins 40, and on 16-wide slots
    from slabs at an odd address (the scalar path)."""
    for c in (torch_cand(cm, cand_case(name), cuda),
              torch_cand(cm, cand_case(name, nbins=48), cuda)):
        shifted = torch.empty(c.slabs.numel() + 1, dtype=torch.int8, device=cuda)[1:]
        odd = c._replace(slabs=shifted.view(c.slabs.shape).copy_(c.slabs))
        for dtype in UNION_DTYPES:
            want = cm.dense_rows_reference(c).to(dtype)
            assert torch.equal(bs.union_rowblock(c, dtype), want), (name, dtype)
            assert torch.equal(bs.union_rowblock(odd, dtype), want), (name, dtype, "odd")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_union_rowblock_refuses_what_the_kernel_does_not_take(cuda):
    """Past the kernel's eight slabs the wrapper launches it once per group
    of eight, the username term in the first, and ORs the groups: 9 and 17
    slabs (the second group at a 16-byte and at an 8-byte offset), with and
    without uids, are bit-equal to the plain version in every dtype, each
    call one block written.  A dtype it cannot write raises."""
    for (block, nbins, groups, planes), with_user in [((64, 48, 3, 9), True),
                                                      ((64, 48, 3, 9), False),
                                                      ((63, 45, 5, 17), True)]:
        cand = _cand(cuda, block, nbins, groups, n_mod=planes, with_user=with_user)
        want = cm.dense_rows_reference(cand)
        launches, written = bs.union_launches, bs.union_blocks_written()
        for dtype in UNION_DTYPES:
            got = bs.union_rowblock(cand, dtype)
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got, want.to(dtype)), (planes, dtype)
        per_call = -(-planes // bs.UNION_MAX_PLANES)
        assert bs.union_launches - launches == per_call * len(UNION_DTYPES)
        assert bs.union_blocks_written() - written == len(UNION_DTYPES)
    with pytest.raises(TypeError):
        bs.union_rowblock(cand._replace(slabs=cand.slabs[:4]), torch.int8)


def _host_columns(cols):
    """The same column panels on the CPU, where the wrappers run their plain
    versions (without the postings, which pick only the card's K2 route)."""
    from mused_tpu_torch.ops import blocked_affinity as ba
    return ba.Columns(kinds=cols.kinds,
                      tensors=tuple(tuple(x.cpu() for x in t) if isinstance(t, tuple)
                                    else t.cpu() for t in cols.tensors),
                      valids=tuple(v.cpu() for v in cols.valids),
                      idf=None if cols.idf is None else cols.idf.cpu())


@functools.lru_cache(maxsize=None)
def _real_columns(n: int, device: str):
    """The column panels of an n-row window of the synthetic stream (the
    benchmark's records at noise 0.95), built by the engine on the card."""
    from mused_tpu_torch.data.ingest import to_device
    from mused_tpu_torch.data.synthetic import make_stream
    from mused_tpu_torch.engine import streaming
    from mused_tpu_torch.utils.config import PipelineConfig
    dev = torch.device(device)
    mods, _, _ = make_stream(n, noise_rate=0.95, binary=True, seed=0)
    cfg = PipelineConfig(seed=0, subset_size=n, window_size=n, k_basis=50, approach="SWFDMC")
    engine = streaming.StreamingEngine(cfg, dev)
    host = engine.featurize([m[:n] for m in mods], streaming.STANDARD_TYPES)
    return engine.columns(host, to_device(host, dev), streaming.STANDARD_TYPES)


@pytest.mark.cuda
@pytest.mark.parametrize("n, nbins", [(151_552, 4096), (98_304, 1536)])
def test_union_rowblock_on_the_real_middle_block_equals_the_plain_rows_and_the_cpu_block(
        n, nbins, cuda):
    """The cells' shapes: the middle 2048-row block's candidates from K2 / K3
    written by the union kernel equal the plain version's rows of the same
    candidates; ``fused_rowblock`` is that one kernel write, and equals
    ``fused_rowblock`` of the same columns on the CPU (the plain K2 / K3
    and union, held to the JAX package by test_torch_union_rowblock.py)."""
    from mused_tpu_torch.ops import blocked_affinity as ba
    block, k_basis = 2048, 50
    cols = _real_columns(n, str(cuda))
    start = n // block // 2 * block
    assert all(ba._cand_held(cols.kinds, cols.tensors))
    cand = ba.candidate_rowblock(cols, start, block, k_basis, nbins)
    want = cm.dense_rows_reference(cand)
    before = bs.union_launches
    for dtype in UNION_DTYPES:
        assert torch.equal(bs.union_rowblock(cand, dtype), want.to(dtype)), dtype
    fused = ba.fused_rowblock(cols, start, block, k_basis, select="binned", nbins=nbins)
    torch.cuda.synchronize()
    assert bs.union_launches == before + len(UNION_DTYPES) + 1
    assert torch.equal(fused, want.float())
    assert want.sum().item() > block * k_basis
    host = ba.fused_rowblock(_host_columns(cols), start, block, k_basis, select="binned",
                             nbins=nbins)
    assert bs.union_launches == before + len(UNION_DTYPES) + 1
    assert torch.equal(fused.cpu(), host)


@pytest.mark.cuda
def test_blocked_svd_reduce_through_the_union_equals_the_composed_blocks(cuda, monkeypatch):
    """The blocked SVD of a 98,304-row window with an injected omega: the
    union kernel's f32 blocks give the plain version's blocks' result to the
    last bit, through 6 sweeps of 48 blocks, each written by the kernel."""
    from mused_tpu_torch.ops import blocked_affinity as ba
    n, nbins, block, rank = 98_304, 1536, 2048, 50
    cols = _real_columns(n, str(cuda))
    g = torch.Generator(device=cuda).manual_seed(0)
    omega = torch.randn((n, rank + 8), generator=g, device=cuda)
    kw = dict(rank=rank, block=block, k_basis=50, select="binned", nbins=nbins, omega=omega)
    before = bs.union_launches
    got = ba.blocked_svd_reduce(cols, None, **kw)
    torch.cuda.synchronize()
    assert bs.union_launches - before == 6 * n // block
    monkeypatch.setattr(bs, "union_rowblock",
                        lambda cand, out_dtype: cm.dense_rows_reference(cand).to(out_dtype))
    want = ba.blocked_svd_reduce(cols, None, **kw)
    torch.cuda.synchronize()
    assert bs.union_launches - before == 6 * n // block
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_a_block_through_the_union_makes_no_host_wait(cuda):
    """The candidates, their slabs and the union enqueue without a host
    wait, so the sweep runs ahead of the card."""
    from mused_tpu_torch.ops import blocked_affinity as ba
    n, nbins, block = 98_304, 1536, 2048
    cols = ba.hoist_columns(_real_columns(n, str(cuda)))
    ba.fused_rowblock(cols, block, block, 50, select="binned", nbins=nbins)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ba.fused_rowblock(cols, block, block, 50, select="binned", nbins=nbins)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
