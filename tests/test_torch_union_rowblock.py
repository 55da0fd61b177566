"""The union of a rebuilt row block: the fused (block, n) rows written once
from the kept candidates (``blocked_select.union_rowblock``) against the
plain composition of ``fused_rowblock``, on CPU tensors (the wrapper's plain
version, ``cand_matvec.dense_rows_reference``), and the routing that gives
the kernel its blocks.

Seeded columns of the five standard kinds, built here with torch alone,
with invalid rows and columns in every modality.  Tolerances: bit-equal in
bool, bf16 and f32 (0 / 1 are exact in each).  The kernel itself runs in
``tests/test_torch_cuda_blocked.py``.
"""
import pytest
import torch

from mused_tpu_torch.ops import blocked_affinity as ba
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.ops.kernels import cand_matvec as cm
from mused_tpu_torch.utils import profiling

N, BLOCK, NBINS = 256, 64, 64
DTYPES = [torch.bool, torch.bfloat16, torch.float32]


def _columns(seed: int = 0, n: int = N, users: int = 12) -> ba.Columns:
    """Location, time, username, tags and text columns of ``n`` rows, about
    a tenth of each modality invalid."""
    g = torch.Generator().manual_seed(seed)

    def invalid():
        return torch.rand(n, generator=g) < 0.1

    latlon = torch.rand((n, 2), generator=g) * torch.tensor([60.0, 120.0]) - 30.0
    loc_valid = ~invalid()
    tim = torch.rand((n, 2), generator=g) * 1e3 + 1.0
    tim[invalid()] = 0.0
    uid = torch.randint(0, users, (n,), generator=g, dtype=torch.int32)
    uid[invalid()] = -1
    tags = (torch.rand((n, 128), generator=g) < 0.05).to(torch.int8)
    tags_valid = (tags.sum(1) > 0) & ~invalid()
    text = torch.rand((n, 128), generator=g) * (torch.rand((n, 128), generator=g) < 0.06)
    text[invalid()] = 0.0
    text = text / torch.clamp(torch.linalg.norm(text, dim=1, keepdim=True), min=1e-12)
    return ba.Columns(
        kinds=("location_xyz", "time", "username", "tags", "text_bf16"),
        tensors=(ba._unit_xyz(latlon, loc_valid), tim, uid,
                 (tags, tags.float().sum(1)), text.to(torch.bfloat16)),
        valids=(loc_valid, ba.affinity.time_valid(tim), uid >= 0, tags_valid,
                text.sum(1) > 0),
        idf=None)


def _only(cols: ba.Columns, kinds) -> ba.Columns:
    keep = [i for i, k in enumerate(cols.kinds) if k in kinds]
    return ba.Columns(kinds=tuple(cols.kinds[i] for i in keep),
                      tensors=tuple(cols.tensors[i] for i in keep),
                      valids=tuple(cols.valids[i] for i in keep), idf=None)


def _with_default(cols: ba.Columns) -> ba.Columns:
    """``cols`` and a ``default_safe`` panel, which takes k_basis - 1
    neighbours: at k_basis 1 it clamps to k = 0 and adds no edge."""
    g = torch.Generator().manual_seed(7)
    x = (torch.randint(-3, 4, (N, 128), generator=g) / 4).to(torch.bfloat16)
    return ba.Columns(kinds=cols.kinds + ("default_safe",),
                      tensors=cols.tensors + ((x, x.float().pow(2).sum(1)),),
                      valids=cols.valids + (torch.ones(N, dtype=torch.bool),), idf=None)


# (columns, block start, k_basis)
CASES = {
    "invalid_rows_and_columns": (lambda: _columns(0), 0, 3),
    "username_only": (lambda: _only(_columns(1, users=4), ("username",)), 64, 3),
    "a_modality_clamped_to_k0": (lambda: _with_default(_columns(2)), 0, 1),
    "a_block_past_the_start": (lambda: _columns(3), N - BLOCK, 3),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_union_of_the_candidates_equals_the_plain_composition(case, dtype):
    make, start, k_basis = CASES[case]
    cols = make()
    want = ba.fused_rowblock(cols, start, BLOCK, k_basis, select="binned", nbins=NBINS,
                             out_dtype=dtype, use_kernel=False)
    cand = ba.candidate_rowblock(cols, start, BLOCK, k_basis, NBINS, use_kernel=False)
    before = bs.union_launches
    got = bs.union_rowblock(cand, dtype)
    assert bs.union_launches == before          # the plain version on the CPU
    assert want.dtype == got.dtype == dtype and want.shape == (BLOCK, N)
    assert torch.equal(cm.dense_rows_reference(cand).to(dtype), want)
    assert torch.equal(got, want)
    assert want.float().sum() > 0               # the case holds edges


def test_the_union_keeps_the_username_term_off_the_own_column():
    cols = _only(_columns(4, users=1), ("username",))
    fused = bs.union_rowblock(ba.candidate_rowblock(cols, 64, BLOCK, 3, NBINS), torch.bool)
    rows = torch.arange(BLOCK)
    assert not fused[rows, 64 + rows].any()
    valid = cols.valids[0]
    assert torch.equal(fused.sum(1), torch.where(valid[64:128], valid.sum() - 1, 0))


def test_union_rowblock_refuses_what_it_does_not_take():
    cand = ba.candidate_rowblock(_columns(5), 0, BLOCK, 3, NBINS)
    with pytest.raises(TypeError):
        bs.union_rowblock(cand, torch.float16)
    with pytest.raises(TypeError):
        bs.union_rowblock(cand._replace(slabs=cand.slabs.to(torch.int32)))


class _OnCuda:
    """A validity stand-in that reports a CUDA device (the routing reads only
    the device of the first validity)."""

    device = torch.device("cuda")


def _on_cuda(cols: ba.Columns) -> ba.Columns:
    return cols._replace(valids=(_OnCuda(),) + cols.valids[1:])


def test_the_kernel_takes_only_cuda_binned_eligible_blocks():
    cols = ba.hoist_columns(_columns(6))
    cuda = _on_cuda(cols)
    assert ba.union_kernel_ok(cuda, "binned", NBINS)
    assert ba.union_kernel_ok(_on_cuda(_only(cols, ("username",))), "binned", NBINS)
    assert not ba.union_kernel_ok(cols, "binned", NBINS)            # the CPU
    assert not ba.union_kernel_ok(cuda, "strip", NBINS)             # the strip route
    assert not ba.union_kernel_ok(cuda, "binned", 0)
    assert not ba.union_kernel_ok(cuda, "binned", 96)               # nbins does not divide n
    assert not ba.union_kernel_ok(cuda, "binned", 2)                # 128 groups: no int8 id
    legacy = cuda._replace(kinds=cuda.kinds[:4] + ("text_norm",))
    assert not ba.union_kernel_ok(legacy, "binned", NBINS)          # a strip-only kind
    narrow = cuda._replace(tensors=cuda.tensors[:4] + (cuda.tensors[4][:, :96],))
    assert not ba.union_kernel_ok(narrow, "binned", NBINS)          # no tile width
    two_users = cuda._replace(kinds=cuda.kinds + ("username",),
                              tensors=cuda.tensors + (cuda.tensors[2],),
                              valids=cuda.valids + (cuda.valids[2],))
    assert not ba.union_kernel_ok(two_users, "binned", NBINS)
    float_users = cuda._replace(tensors=cuda.tensors[:2] + (cuda.tensors[2].float(),)
                                + cuda.tensors[3:])
    assert not ba.union_kernel_ok(float_users, "binned", NBINS)
    nine = cuda._replace(kinds=cuda.kinds + ("time",) * 5, tensors=cuda.tensors
                         + (cuda.tensors[1],) * 5, valids=cuda.valids + (cuda.valids[1],) * 5)
    assert not ba.union_kernel_ok(nine, "binned", NBINS)            # 9 candidate slabs


def test_fused_rowblock_routes_eligible_blocks_through_the_union(monkeypatch):
    cols = _columns(8)
    want = ba.fused_rowblock(cols, 64, BLOCK, 3, select="binned", nbins=NBINS)
    calls = []
    union = bs.union_rowblock

    def spy(cand, out_dtype=torch.float32):
        calls.append(out_dtype)
        return union(cand, out_dtype)

    monkeypatch.setattr(bs, "union_rowblock", spy)
    assert torch.equal(ba.fused_rowblock(cols, 64, BLOCK, 3, select="binned", nbins=NBINS),
                       want)
    assert calls == []                                           # the CPU composes
    monkeypatch.setattr(ba, "union_kernel_ok", lambda *a: True)
    got = ba.fused_rowblock(cols, 64, BLOCK, 3, select="binned", nbins=NBINS,
                            out_dtype=torch.bfloat16)
    assert calls == [torch.bfloat16] and torch.equal(got, want.to(torch.bfloat16))
    ba.fused_rowblock(cols, 64, BLOCK, 3, select="binned", nbins=NBINS, use_kernel=False)
    assert calls == [torch.bfloat16]                             # the reference route


@pytest.mark.parametrize("routed", [False, True])
def test_each_sweep_counts_the_blocks_the_union_wrote(routed, monkeypatch):
    cols = _columns(9)
    if routed:
        monkeypatch.setattr(ba, "union_kernel_ok", lambda *a: True)
    omega = torch.randn((N, 10), generator=torch.Generator().manual_seed(0))
    profiling.clear()
    with profiling.recording():
        ba.blocked_svd_reduce(cols, None, rank=2, block=BLOCK, k_basis=3, select="binned",
                              nbins=NBINS, omega=omega)
        ba.blocked_fd_sketch(cols, ell=8, block=BLOCK, k_basis=3, select="binned",
                             nbins=NBINS, cand_fold=False)
    counts = [r.counters["blocked.union_blocks"] for r in profiling.recorded()
              if r.name == "blocked.union_blocks"]
    profiling.clear()
    per_sweep = N // BLOCK if routed else 0
    assert counts == [per_sweep] * 7      # 2 + 2 * n_iter SVD sweeps, then the fold


def test_blocked_svd_reduce_multiplies_f32_blocks(monkeypatch):
    cols = _columns(10)
    seen = []
    fused_rowblock = ba.fused_rowblock

    def spy(*a, **kw):
        out = fused_rowblock(*a, **kw)
        seen.append(out.dtype)
        return out

    monkeypatch.setattr(ba, "fused_rowblock", spy)
    omega = torch.randn((N, 10), generator=torch.Generator().manual_seed(1))
    ba.blocked_svd_reduce(cols, None, rank=2, block=BLOCK, k_basis=3, select="binned",
                          nbins=NBINS, omega=omega)
    assert seen == [torch.float32] * (6 * N // BLOCK)
