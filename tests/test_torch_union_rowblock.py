"""The union of a rebuilt row block: the fused (block, n) rows written once
from the kept candidates (``blocked_select.union_rowblock``, on CPU tensors
its plain version ``cand_matvec.dense_rows_reference``), the one route of
``fused_rowblock(select="binned")``, against the JAX package's
``fused_rowblock`` on the same columns; the blocks whose modalities the
candidate form cannot all hold (their strips OR-ed in); and the per-sweep
count of the blocks the union kernel wrote.

Seeded columns of the five standard kinds, built here with torch, with
invalid rows and columns in every modality.  Tolerances: bit-equal in bool,
bf16 and f32 (0 / 1 are exact in each).  The kernel itself runs in
``tests/test_torch_cuda_blocked.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import blocked_affinity as jba
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


def _with_default(cols: ba.Columns, seed: int = 7) -> ba.Columns:
    """``cols`` and a ``default_safe`` panel, which takes k_basis - 1
    neighbours: at k_basis 1 it clamps to k = 0 and adds no edge."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randint(-3, 4, (N, 128), generator=g) / 4).to(torch.bfloat16)
    return ba.Columns(kinds=cols.kinds + ("default_safe",),
                      tensors=cols.tensors + ((x, x.float().pow(2).sum(1)),),
                      valids=cols.valids + (torch.ones(N, dtype=torch.bool),), idf=None)


def _jnp(x):
    """A CPU tensor (bf16 included) as a JAX array of the same dtype."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _jax_rows(cols: ba.Columns, start: int, k_basis: int) -> np.ndarray:
    """The JAX package's binned (BLOCK, n) f32 rows of the same columns."""
    jcols = jba.Columns(
        kinds=cols.kinds,
        tensors=tuple(tuple(_jnp(y) for y in x) if isinstance(x, tuple) else _jnp(x)
                      for x in cols.tensors),
        valids=tuple(_jnp(v) for v in cols.valids), idf=None)
    return np.asarray(jba.fused_rowblock(jcols, jnp.int32(start), BLOCK, k_basis,
                                         select="binned", nbins=NBINS))


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
    want = _jax_rows(cols, start, k_basis)
    cand = ba.candidate_rowblock(cols, start, BLOCK, k_basis, NBINS)
    before = bs.union_launches, bs.union_blocks_written()
    got = bs.union_rowblock(cand, dtype)
    assert (bs.union_launches, bs.union_blocks_written()) == before   # the plain version
    assert got.dtype == dtype and want.shape == got.shape == (BLOCK, N)
    assert torch.equal(cm.dense_rows_reference(cand).to(dtype), got)
    np.testing.assert_array_equal(got.float().numpy(), want)
    fused = ba.fused_rowblock(cols, start, BLOCK, k_basis, select="binned", nbins=NBINS,
                              out_dtype=dtype)
    assert torch.equal(fused, got)
    assert want.sum() > 0                       # the case holds edges


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


def _two_users(cols: ba.Columns) -> ba.Columns:
    uid = torch.where(cols.tensors[2] >= 0, cols.tensors[2] % 5, -1)
    return cols._replace(kinds=cols.kinds + ("username",), tensors=cols.tensors + (uid,),
                         valids=cols.valids + (uid >= 0,))


def _nine_slabs(cols: ba.Columns) -> ba.Columns:
    for seed in range(5):
        cols = _with_default(cols, seed=20 + seed)
    return cols


# blocks the candidate form cannot hold whole: (columns, the modalities it holds)
UNHELD = {
    "legacy_text_norm": (lambda c: c._replace(kinds=c.kinds[:4] + ("text_norm",)), 4),
    "panel_96_wide": (lambda c: c._replace(tensors=c.tensors[:4] + (c.tensors[4][:, :96],)),
                      4),
    "two_username_panels": (_two_users, 5),
    "float_uids": (lambda c: c._replace(tensors=c.tensors[:2] + (c.tensors[2].float(),)
                                        + c.tensors[3:]), 4),
    "nine_slabs": (_nine_slabs, 10),
}


@pytest.mark.parametrize("case", sorted(UNHELD))
def test_blocks_the_candidate_form_cannot_hold_whole_equal_jax(case):
    """The held modalities go through the union (one call per block, nine
    slabs included: past the kernel's planes its plain version writes
    them), the others are OR-ed in from their strips; the rows equal the
    JAX package's bit for bit."""
    make, held = UNHELD[case]
    cols = make(_columns(6))
    assert sum(ba._cand_held(cols.kinds, cols.tensors)) == held
    assert not ba.cand_fold_supported(cols.kinds, cols.tensors, NBINS, N) \
        or case == "nine_slabs"
    for start in (0, 128):
        want = _jax_rows(cols, start, 3)
        got = ba.fused_rowblock(cols, start, BLOCK, 3, select="binned", nbins=NBINS)
        assert got.dtype == torch.float32 and want.sum() > 0
        np.testing.assert_array_equal(got.numpy(), want)


def test_fused_rowblock_routes_eligible_blocks_through_the_union(monkeypatch):
    """On the CPU too, each binned block is one union call in the consumer's
    dtype (bool where strips are OR-ed in); the strip route makes none."""
    cols = _columns(8)
    want = ba.fused_rowblock(cols, 64, BLOCK, 3, select="binned", nbins=NBINS)
    calls = []
    union = bs.union_rowblock

    def spy(cand, out_dtype=torch.float32):
        calls.append(out_dtype)
        return union(cand, out_dtype)

    monkeypatch.setattr(bs, "union_rowblock", spy)
    got = ba.fused_rowblock(cols, 64, BLOCK, 3, select="binned", nbins=NBINS,
                            out_dtype=torch.bfloat16)
    assert calls == [torch.bfloat16] and torch.equal(got, want.to(torch.bfloat16))
    legacy = cols._replace(kinds=cols.kinds[:4] + ("text_norm",))
    ba.fused_rowblock(legacy, 64, BLOCK, 3, select="binned", nbins=NBINS)
    assert calls == [torch.bfloat16, torch.bool]
    strip = ba.fused_rowblock(cols, 64, BLOCK, 3, select="strip")
    assert calls == [torch.bfloat16, torch.bool]                 # the strip route
    assert strip.sum() > 0


@pytest.mark.parametrize("routed", [False, True])
def test_each_sweep_counts_the_blocks_the_union_wrote(routed, monkeypatch):
    cols = _columns(9)
    if routed:          # each union call stands in for a kernel write
        union, calls = bs.union_rowblock, [0]

        def written(cand, out_dtype=torch.float32):
            calls[0] += 1
            return union(cand, out_dtype)

        monkeypatch.setattr(bs, "union_rowblock", written)
        monkeypatch.setattr(bs, "union_blocks_written", lambda: calls[0])
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
