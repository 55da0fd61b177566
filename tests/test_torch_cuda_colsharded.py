"""Slice 4a on a CUDA device: K3 on every pair of metrics, the shard-local
operands of K2 / K3 (``row_stats``, a ``start`` outside the panel), K4 / K5
on a column shard's candidate block, and the column-sharded entry points at
world size 1 against the single-device path.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_colsharded.py

Tolerances, K2's rules: operands are multiples of 1/4 (dot, chord) or small
integer counts (jaccard), whose f32 sums are exact in any order, and chord3
/ l1 run unfused in the plain version's order, so every output is held
bit-equal to the plain version; the tensor-core pairs are also bit-equal to
two K2 launches (the same tile program).
"""
import socket

import pytest
import torch

from mused_tpu_torch.ops import blocked_affinity as ba
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.ops.kernels import cand_matvec as cm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(metric, n, k, device, seed=0):
    """(panel, row_sums) of ``metric``: integer-valued, exact in any order."""
    g = torch.Generator().manual_seed(seed)
    if metric == "jaccard":
        x = (torch.rand((n, k), generator=g) < 0.08).to(torch.int8)
        return x.to(device), x.float().sum(1).to(device)
    if metric in ("dot", "chord"):
        x = (torch.randint(-3, 4, (n, k), generator=g) / 4).to(torch.bfloat16)
        sq = x.float().pow(2).sum(1).to(device) if metric == "chord" else None
        return x.to(device), sq
    x = torch.rand((n, 3 if metric == "chord3" else 2), generator=g) * 100
    x[5] = x[5 + n // 2]                     # equal values in two groups
    return x.to(device), None


def _valid(n, device, seed=1):
    return (torch.rand(n, generator=torch.Generator().manual_seed(seed)) > 0.1).to(device)


def _pair_three_ways(ops_a, ops_b, start, nbins, block, rows_a=None, rows_b=None,
                     stats_a=None, stats_b=None):
    """(K3, two K2 launches, the plain versions) on the same operands."""
    out = []
    (ma, xa, sa, va), (mb, xb, sb, vb) = ops_a, ops_b
    ra = xa[start:start + block] if rows_a is None else rows_a
    rb = xb[start:start + block] if rows_b is None else rows_b
    kw = dict(nbins=nbins, block=block)
    before = bs.pair_launches, bs.launches
    out.append(bs.binned_candidates_pair(
        xa, xb, ra, rb, va, vb, start, metricA=ma, metricB=mb, row_sumsA=sa,
        row_statsA=stats_a, row_sumsB=sb, row_statsB=stats_b, **kw))
    for fn in (bs.binned_candidates, bs.binned_candidates_plain):
        out.append((*fn(xa, ra, va, start, metric=ma, row_sums=sa, row_stats=stats_a, **kw),
                    *fn(xb, rb, vb, start, metric=mb, row_sums=sb, row_stats=stats_b, **kw)))
    torch.cuda.synchronize()
    assert (bs.pair_launches, bs.launches) == (before[0] + 1, before[1] + 2)
    return out


def _ops(metric, n, k, device, seed):
    x, sums = _operands(metric, n, k, device, seed)
    return metric, x, sums, _valid(n, device, seed)


# (metricA, metricB, n, nbins, block, start, K): the production pair (tags
# jaccard + text dot), dot + dot (embedding streams), chord + dot, and mixed
# pairs, at ragged shapes (slot tiles and row tiles cut short)
PAIRS = [("jaccard", "dot", 1000, 200, 130, 37, 128),
         ("dot", "dot", 960, 320, 200, 100, 192),
         ("chord", "dot", 1024, 256, 256, 256, 64),
         ("dot", "chord3", 1000, 200, 130, 37, 128),
         ("l1", "jaccard", 960, 320, 200, 100, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAIRS, ids=lambda c: f"{c[0]}+{c[1]}")
def test_k3_pair_matches_two_k2_and_plain(case, cuda):
    ma, mb, n, nbins, block, start, k = case
    pair, singles, plain = _pair_three_ways(_ops(ma, n, k, cuda, 3), _ops(mb, n, 2 * k, cuda, 4),
                                            start, nbins, block)
    assert bs.pair_route(ma, mb) == ("mma" if mb == "dot" else "simple")
    for p, s, w in zip(pair, singles, plain):
        assert torch.equal(p, s) and torch.equal(p, w)


K3_MMA_CASES = {   # (n, nbins, block, start)
    "self_columns_straddle_a_group_boundary": (1024, 256, 256, 200),
    "a_group_with_every_column_invalid": (1024, 256, 256, 512),
    "the_same_column_in_every_group": (1024, 256, 256, 300),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K3_MMA_CASES))
@pytest.mark.parametrize("pair", [("jaccard", "dot"), ("dot", "chord3")], ids="+".join)
def test_k3_pair_edge_cases(case, pair, cuda):
    n, nbins, block, start = K3_MMA_CASES[case]
    ops = [_ops(m, n, 128, cuda, 5 + i) for i, m in enumerate(pair)]
    if case == "the_same_column_in_every_group":       # every slot ties over 4 groups
        ops = [(m, x[:nbins].repeat(4, 1).contiguous(),
                None if s is None else s[:nbins].repeat(4).contiguous(), v)
               for m, x, s, v in ops]
    if case == "a_group_with_every_column_invalid":
        for _, _, _, v in ops:
            v[nbins:2 * nbins] = False
    pair_out, singles, plain = _pair_three_ways(ops[0], ops[1], start, nbins, block)
    for p, s, w in zip(pair_out, singles, plain):
        assert torch.equal(p, s) and torch.equal(p, w)
    if case == "the_same_column_in_every_group":
        assert (pair_out[1] == 0).float().mean().item() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["chord3", "l1"])
def test_coordinate_self_columns_with_fewer_bins_than_tile_rows(metric, cuda):
    """nbins 4: a 16-row tile of the coordinate kernel spans 4 groups, and
    every one of them holds some row's own column, which must stay masked
    (the kernel once tested only the first and last group of the range)."""
    n, nbins, block, start = 64, 4, 32, 0
    x, _ = _operands(metric, n, 0, cuda, 13)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    kw = dict(metric=metric, nbins=nbins, block=block)
    got = bs.binned_candidates(x, x[start:start + block], valid, start, **kw)
    want = bs.binned_candidates_plain(x, x[start:start + block], valid, start, **kw)
    pair = bs.binned_candidates_pair(x, x, x[:block], x[:block], valid, valid, start,
                                     metricA=metric, metricB=metric, nbins=nbins,
                                     block=block)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(pair, (*want, *want)))


def _shard_rows(metric, n, k, block, device, seed):
    """A row block from another shard: its own rows and statistics."""
    rows, sums = _operands(metric, block, k, device, seed)
    return rows, sums


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["minus_block", "minus_one", "n_minus_block_plus_one",
                                   "past_n"])
@pytest.mark.parametrize("metric", ["jaccard", "dot", "chord", "chord3", "l1"])
def test_k2_shard_local_start_and_row_stats(metric, where, cuda):
    """K2 on rows that are not the panel's slice: ``row_stats`` given, and
    ``start`` outside [0, n - block] (the self test still runs by index)."""
    n, nbins, block = 1024, 256, 128
    start = {"minus_block": -block, "minus_one": -1, "n_minus_block_plus_one": n - block + 1,
             "past_n": n + 3}[where]
    x, sums = _operands(metric, n, 128, cuda, 11)
    rows, row_stats = _shard_rows(metric, n, 128, block, cuda, 12)
    valid = _valid(n, cuda)
    kw = dict(metric=metric, nbins=nbins, block=block, row_sums=sums, row_stats=row_stats)
    got = bs.binned_candidates(x, rows, valid, start, **kw)
    want = bs.binned_candidates_plain(x, rows, valid, start, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("start", [-128, -1, 897, 1027])
@pytest.mark.parametrize("pair", [("chord3", "l1"), ("jaccard", "dot")], ids="+".join)
def test_k3_shard_local_start_and_row_stats(pair, start, cuda):
    n, nbins, block = 1024, 256, 128
    ops, rows, stats = [], [], []
    for i, m in enumerate(pair):
        ops.append(_ops(m, n, 128, cuda, 20 + i))
        r, s = _shard_rows(m, n, 128, block, cuda, 30 + i)
        rows.append(r)
        stats.append(s)
    pair_out, singles, plain = _pair_three_ways(ops[0], ops[1], start, nbins, block,
                                                rows[0], rows[1], stats[0], stats[1])
    for p, s, w in zip(pair_out, singles, plain):
        assert torch.equal(p, s) and torch.equal(p, w)


@pytest.mark.cuda
def test_k4_k5_on_a_column_shards_candidate_block(cuda):
    """A shard's candidate block: local int8 group ids, global offset g0 != 0,
    the row block's global start inside another shard's range and inside
    this one's (self columns), integer operands: exact."""
    g = torch.Generator().manual_seed(40)
    groups, nbins, block, g0 = 6, 128, 256, 6
    for start in (0, g0 * nbins + 64):
        slabs = torch.randint(-1, groups, (2, block, nbins), generator=g).to(torch.int8)
        slabs[torch.rand(slabs.shape, generator=g) < 0.7] = -1
        uid_rows = torch.randint(-1, 5, (block, 1), generator=g).to(torch.int32)
        uid_cols = torch.randint(-2, 5, (groups, nbins), generator=g).to(torch.int32)
        cand = cm.CandBlock(slabs.to(cuda), uid_rows.to(cuda), uid_cols.to(cuda), start, g0)
        x_t = torch.randint(-4, 5, (66, block), generator=g).to(torch.bfloat16).to(cuda)
        y = torch.randint(-4, 5, (groups * nbins, 66), generator=g).to(torch.bfloat16).to(cuda)
        (ot, et), (wt, we) = cm.matvec_t(cand, x_t), cm.matvec_t_reference(cand, x_t)
        o, w = cm.matvec(cand, y), cm.matvec_reference(cand, y)
        torch.cuda.synchronize()
        assert torch.equal(ot, wt) and float(et) == float(we) and torch.equal(o, w)


# ---------------------------------------------------------------------------
# the column-sharded entry points at world size 1 (one NCCL rank)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_group(cuda):
    """A process group of one NCCL rank on this card, and its (1, 1) mesh."""
    import torch.distributed as dist
    from mused_tpu_torch.parallel import mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    yield mesh.make_mesh(1, 1, "cuda")
    dist.destroy_process_group()


def _window(n, device, seed=0):
    from mused_tpu_torch.data import features as feat
    g = torch.Generator().manual_seed(seed)
    loc = torch.rand((n, 2), generator=g) * torch.tensor([120.0, 340.0]) - torch.tensor(
        [60.0, 170.0])
    loc[torch.rand(n, generator=g) < 0.1] = float("nan")
    tim = torch.rand((n, 2), generator=g) * 1e5 + 1.0
    tim[torch.rand(n, generator=g) < 0.1] = 0.0
    uid = torch.randint(0, 40, (n,), generator=g).to(torch.int32)
    uid[torch.rand(n, generator=g) < 0.1] = -1
    tags = (torch.rand((n, 256), generator=g) < 0.02).to(torch.uint8)
    text = (torch.rand((n, 512), generator=g) < 0.05).to(torch.uint8)
    tags_valid = torch.rand(n, generator=g) < 0.9
    wf = feat.WindowFeatures(location=loc.numpy(), times=tim.numpy(), user_ids=uid.numpy(),
                             tags=tags.numpy(), text=text.numpy(),
                             tags_valid=tags_valid.numpy())
    return wf


@pytest.mark.cuda
def test_world_size_one_entry_points_match_the_single_device_path(nccl_group, cuda):
    from mused_tpu_torch.parallel import colsharded as cs
    n, block, nbins, kb, ell = 4096, 512, 1024, 3, 16
    wf = _window(n, cuda)
    cols = ba.standard_columns(type(wf)(*(torch.from_numpy(a).to(cuda) for a in wf)))
    feats = tuple(torch.from_numpy(a) for a in wf)
    for start in (0, 1536, n - block):
        got = cs.colsharded_fused_rows(feats, ("standard",), start=start, block=block,
                                       k_basis=kb, mesh=nccl_group, nbins=nbins)
        want = ba.fused_rowblock(cols, start, block, kb, select="binned", nbins=nbins,
                                 out_dtype=torch.bool)
        assert torch.equal(got, want)
    bs.reset_launches()
    cm.reset_launches()
    _, sq, _ = cs.colsharded_blocked_fd_sketch(feats, ("standard",), ell=ell, block=block,
                                               k_basis=kb, mesh=nccl_group, nbins=nbins)
    blocks = n // block
    assert (bs.launches, bs.pair_launches, cm.launches_t, cm.launches) == (
        0, 2 * blocks, 2 * blocks, blocks)
    _, sq1, _ = ba.blocked_fd_sketch(cols, ell=ell, block=block, k_basis=kb, select="binned",
                                     nbins=nbins, cand_fold=True)
    assert float(sq) == float(sq1)
