"""Candidate-form products (K4 / K5) and the candidate-native FD shrink: the
port's wrappers on CPU tensors (their plain versions) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances: products are bit-equal on integer-valued bf16 operands (0/1
tiles times small integers sum exactly in f32 in any order) and the edge
count is exact.  ``shrink_rr_cands`` with the JAX side's probe injected:
the same edge count, B^T B and delta to rtol 1e-4 (fp32 LAPACK vs XLA QR /
eigh rounding, as tests/test_torch_fd_swfd.py holds the dense shrink).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import fd as jfd
from mused_tpu.ops.pallas import cand_matvec as jcm
from mused_tpu_torch.ops import fd as tfd
from mused_tpu_torch.ops.kernels import cand_matvec as tcm
from mused_tpu_torch.utils.convert import cand_block_from_jax
from cand_cases import CASES, cand_case, products_from_lists, torch_cand
from torch_parity import jax_probe, n as tonp, t

RTOL = 1e-4
BLOCK, NBINS, GROUPS, START = 64, 128, 4, 64


def _jax_cand(rng, n_mod=3, with_user=True, fill=None):
    slabs = rng.integers(-1, GROUPS, (n_mod, BLOCK, NBINS)).astype(np.int8)
    if fill is not None:
        slabs[:] = fill
    uid_r = (jnp.asarray(rng.integers(-1, 6, (BLOCK, 1)).astype(np.int32))
             if with_user else None)
    uid_c = (rng.integers(-2, 6, (GROUPS, NBINS)) if with_user
             else np.full((GROUPS, NBINS), -2)).astype(np.int32)
    return jcm.CandBlock(jnp.asarray(slabs), uid_r, jnp.asarray(uid_c), jnp.int32(START))


def _both(rng, **kw):
    jc = _jax_cand(rng, **kw)
    return jc, cand_block_from_jax(jc, "cpu")


@pytest.mark.parametrize("with_user", [True, False])
def test_k4_matches_the_jax_kernel(with_user):
    rng = np.random.default_rng(0)
    jc, tc = _both(rng, with_user=with_user)
    for r in (128, 256):
        x = rng.integers(-4, 5, (r, BLOCK)).astype(np.float32)
        want, wedges = jcm.matvec_t_pallas(jc, jnp.asarray(x).astype(jnp.bfloat16),
                                           interpret=True)
        before = tcm.launches_t
        got, edges = tcm.matvec_t(tc, t(x).to(torch.bfloat16))
        assert tcm.launches_t == before
        np.testing.assert_array_equal(tonp(got), np.asarray(want))
        assert float(edges) == float(wedges)


@pytest.mark.parametrize("with_user", [True, False])
def test_k5_matches_the_jax_kernel(with_user):
    rng = np.random.default_rng(1)
    jc, tc = _both(rng, with_user=with_user)
    y = rng.integers(-4, 5, (GROUPS * NBINS, 128)).astype(np.float32)
    want = jcm.matvec_pallas(jc, jnp.asarray(y).astype(jnp.bfloat16), interpret=True)
    before = tcm.launches
    got = tcm.matvec(tc, t(y).to(torch.bfloat16))
    assert tcm.launches == before
    np.testing.assert_array_equal(tonp(got), np.asarray(want))


@pytest.mark.parametrize("with_user", [True, False])
def test_k5_at_the_live_width_matches_the_padded_jax_kernel(with_user):
    """The fold's live r = 66 against the JAX kernel on the same columns
    zero-padded to its 128 lanes, sliced back to 66."""
    rng = np.random.default_rng(7)
    jc, tc = _both(rng, with_user=with_user)
    y = rng.integers(-4, 5, (GROUPS * NBINS, 66)).astype(np.float32)
    padded = np.pad(y, ((0, 0), (0, 128 - 66)))
    want = jcm.matvec_pallas(jc, jnp.asarray(padded).astype(jnp.bfloat16), interpret=True)
    got = tcm.matvec(tc, t(y).to(torch.bfloat16))
    assert tuple(got.shape) == (BLOCK, 66)
    np.testing.assert_array_equal(tonp(got), np.asarray(want)[:, :66])


def test_dense_rows_and_products_match_jax_and_dense_matmuls():
    rng = np.random.default_rng(2)
    jc, tc = _both(rng)
    dense = tonp(tcm.dense_rows_reference(tc))
    np.testing.assert_array_equal(dense, np.asarray(jcm.dense_rows_reference(jc)))
    x = rng.integers(-4, 5, (128, BLOCK)).astype(np.float32)
    out, edges = tcm.matvec_t_reference(tc, t(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tonp(out), x @ dense.astype(np.float32))
    assert float(edges) == dense.sum()


def test_pack_slab_and_mask_uids_match_jax():
    rng = np.random.default_rng(3)
    keep = rng.random((BLOCK, NBINS)) < 0.3
    grp = rng.integers(0, GROUPS, (BLOCK, NBINS)).astype(np.int8)
    np.testing.assert_array_equal(tonp(tcm.pack_slab(t(keep), t(grp))),
                                  np.asarray(jcm.pack_slab(jnp.asarray(keep),
                                                           jnp.asarray(grp))))
    uid = rng.integers(0, 9, GROUPS * NBINS).astype(np.int32)
    valid = rng.random(GROUPS * NBINS) > 0.2
    want = jcm.mask_uids(jnp.asarray(uid), jnp.asarray(valid), NBINS, 64, BLOCK)
    got = tcm.mask_uids(t(uid), t(valid), NBINS, 64, BLOCK)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(tonp(g), np.asarray(w))


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(4)
    _, tc = _both(rng)
    with pytest.raises(TypeError):          # operands are bf16
        tcm.matvec_t(tc, torch.zeros((128, BLOCK)))
    with pytest.raises(ValueError):         # x_t is (r, block)
        tcm.matvec_t(tc, torch.zeros((128, BLOCK + 1), dtype=torch.bfloat16))
    with pytest.raises(ValueError):         # y is (groups * nbins, r)
        tcm.matvec(tc, torch.zeros((NBINS, 128), dtype=torch.bfloat16))
    with pytest.raises(TypeError):          # int8 slabs
        tcm.matvec(tc._replace(slabs=tc.slabs.int()),
                   torch.zeros((GROUPS * NBINS, 128), dtype=torch.bfloat16))


def _sketch(rng, ell, d):
    basis = np.linalg.qr(rng.normal(size=(d, ell)))[0]
    return (rng.normal(size=(ell, ell)) * np.geomspace(8, 1, ell)) @ basis.T


@pytest.mark.parametrize("with_user", [True, False])
def test_shrink_rr_cands_matches_jax_with_injected_probe(with_user, monkeypatch):
    rng = np.random.default_rng(5)
    ell = 8
    jc = _jax_cand(rng, with_user=with_user)
    # a sparse block: most slots keep no candidate
    slabs = np.asarray(jc.slabs).copy()
    slabs[rng.random(slabs.shape) < 0.9] = -1
    jc = jc._replace(slabs=jnp.asarray(slabs))
    tc = cand_block_from_jax(jc, "cpu")
    sketch = _sketch(rng, ell, GROUPS * NBINS).astype(np.float32)
    jb, jd, je = jfd.shrink_rr_cands(jnp.asarray(sketch), jc, ell, use_kernel=False,
                                     interpret=True)
    monkeypatch.setattr(tfd, "default_probe",
                        lambda m2, r, device: t(jax_probe(m2, r)).to(device))
    tb, td, te = tfd.shrink_rr_cands(t(sketch), tc, ell)
    assert float(te) == float(je) == tonp(tcm.dense_rows_reference(tc)).sum()
    ga, gb = np.asarray(jb).T @ np.asarray(jb), tonp(tb).T @ tonp(tb)
    np.testing.assert_allclose(gb, ga, rtol=RTOL, atol=RTOL * np.abs(ga).max())
    np.testing.assert_allclose(float(td), float(jd), rtol=RTOL, atol=RTOL * float(je))


def test_shrink_rr_cands_empty_block_is_a_no_op():
    rng = np.random.default_rng(6)
    _, tc = _both(rng, fill=-1)
    tc = tc._replace(uid_rows=torch.full((BLOCK, 1), -1, dtype=torch.int32))
    sketch = t(_sketch(rng, 8, GROUPS * NBINS).astype(np.float32))
    b, delta, edges = tfd.shrink_rr_cands(sketch, tc, 8)
    assert b is sketch and float(delta) == 0.0 and float(edges) == 0.0
    # one valid uid row makes it a real absorb
    tc = tc._replace(uid_rows=torch.where(torch.arange(BLOCK)[:, None] == 0, 3, -1)
                     .to(torch.int32))
    b, _, edges = tfd.shrink_rr_cands(sketch, tc, 8)
    assert b is not sketch and float(edges) == tonp(tcm.dense_rows_reference(tc)).sum()


# ---------------------------------------------------------------------------
# the candidate lists (the kernels' operand): plain version against JAX
# ---------------------------------------------------------------------------

def _lists_case(name):
    case = cand_case(name)
    slabs, uid_rows, uid_cols, start, g0 = case
    jc = jcm.CandBlock(jnp.asarray(slabs), None if uid_rows is None else jnp.asarray(uid_rows),
                       jnp.asarray(uid_cols), jnp.int32(start), g0)
    tc = torch_cand(tcm, case)
    lists = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in tcm.lists_reference(tc).items()}
    return tc, lists, np.asarray(jcm.dense_rows_reference(jc))


@pytest.mark.parametrize("name", CASES)
def test_lists_rebuild_the_jax_fused_rows(name):
    """The row lists and the username term are disjoint and together give
    the JAX package's fused rows bit for bit; the edge count is exact; the
    column, user and user-column lists are the row lists' transposes in
    ascending order."""
    tc, lists, dense = _lists_case(name)
    block, n, nbins = tc.block, tc.groups * tc.nbins, tc.nbins
    listed = np.zeros((block, n), bool)
    rows = np.repeat(np.arange(block), np.diff(lists["rowptr"]))
    listed[rows, lists["rowcols"]] = True
    assert listed.sum() == lists["rowcols"].size       # each column once per row
    user = np.zeros_like(listed)
    if "row_user" in lists:
        ru, cu = lists["row_user"], lists["col_user"]
        self_col = tc.start + np.arange(block) - tc.g0 * nbins
        user = (ru[:, None] == cu[None, :]) & (cu[None, :] >= 0) \
            & (np.arange(n)[None, :] != self_col[:, None])
        nu = int(lists["nu"][0])
        assert np.array_equal(lists["uids"], np.unique(tc.uid_rows.numpy()))
        for u in range(nu):
            got = lists["userrows"][lists["userptr"][u]:lists["userptr"][u + 1]]
            assert np.array_equal(got, np.nonzero(ru == u)[0])
            got = lists["ucols"][lists["ucolptr"][u]:lists["ucolptr"][u + 1]]
            assert np.array_equal(got, np.nonzero(cu == u)[0])
    assert not np.any(listed & user)
    np.testing.assert_array_equal(listed | user, dense)
    assert lists["edges"] == int(dense.sum())
    for c in range(n):
        got = lists["colrows"][lists["colptr"][c]:lists["colptr"][c + 1]]
        assert np.array_equal(got, np.nonzero(listed[:, c])[0])
    order = [np.nonzero(listed[i])[0] for i in range(block)]
    slots = [lists["rowcols"][lists["rowptr"][i]:lists["rowptr"][i + 1]] % nbins
             for i in range(block)]
    assert all(np.all(np.diff(s) >= 0) for s in slots)        # slot order
    assert all(np.array_equal(np.sort(g), o) for g, o in
               zip((lists["rowcols"][lists["rowptr"][i]:lists["rowptr"][i + 1]]
                    for i in range(block)), order))


@pytest.mark.parametrize("name", CASES)
def test_products_from_the_lists_equal_the_jax_kernels(name):
    """The kernels' formula (list gathers plus per-user sums less the self
    pair) on the plain lists equals the JAX kernels on integer operands."""
    tc, lists, _ = _lists_case(name)
    block, n = tc.block, tc.groups * tc.nbins
    rng = np.random.default_rng(11)
    x = rng.integers(-4, 5, (66, block)).astype(np.float32)
    y = rng.integers(-4, 5, (n, 66)).astype(np.float32)
    out_t, out = products_from_lists(lists, x, y, block=block, n=n, start=tc.start,
                                     g0=tc.g0, nbins=tc.nbins)
    slabs, uid_rows, uid_cols, start, g0 = cand_case(name)
    jc = jcm.CandBlock(jnp.asarray(slabs), None if uid_rows is None else jnp.asarray(uid_rows),
                       jnp.asarray(uid_cols), jnp.int32(start), g0)
    want_t, _ = jcm.matvec_t_reference(jc, jnp.asarray(x).astype(jnp.bfloat16))
    want = jcm.matvec_reference(jc, jnp.asarray(y).astype(jnp.bfloat16))
    np.testing.assert_array_equal(out_t, np.asarray(want_t))
    np.testing.assert_array_equal(out, np.asarray(want))


def test_lists_are_for_the_card():
    """On the CPU the products read the slabs: with_lists leaves a block as
    it is and build_lists refuses; the plain products ignore lists."""
    tc = torch_cand(tcm, cand_case("random"))
    assert tcm.with_lists(tc) is tc
    with pytest.raises(ValueError):
        tcm.build_lists(tc)
    before = tcm.launches_lists
    x = torch.ones((8, tc.block), dtype=torch.bfloat16)
    tcm.matvec_t(tc, x)
    assert tcm.launches_lists == before


# a field of the block replaced after its lists were built
STALE = {"slabs": lambda c: c.slabs.clone(), "uid_rows": lambda c: None,
         "uid_cols": lambda c: c.uid_cols.clone(), "start": lambda c: c.start + 1,
         "g0": lambda c: c.g0 + 1}


@pytest.mark.parametrize("field", sorted(STALE))
def test_products_refuse_the_lists_of_another_block(field):
    """A block's lists record the tensors and offsets they were built from.
    A block that replaced one of them and kept the lists raises in both
    products (lists built with uids leave out the entries the username term
    counts, so without uids they would sum wrong); the block they were
    built from runs.  On the CPU the lists are a stand-in: the check runs
    before any product."""
    tc = torch_cand(tcm, cand_case("self_inside"))
    lists = tcm.CandLists(torch.zeros(4, dtype=torch.int32), (), (), (), 1,
                          tcm._lists_source(tc))
    own = tc._replace(lists=lists)
    x = torch.ones((8, tc.block), dtype=torch.bfloat16)
    y = torch.ones((tc.groups * tc.nbins, 8), dtype=torch.bfloat16)
    assert torch.equal(tcm.matvec_t(own, x)[0], tcm.matvec_t(tc, x)[0])
    assert torch.equal(tcm.matvec(own, y), tcm.matvec(tc, y))
    stale = own._replace(**{field: STALE[field](tc)})
    with pytest.raises(ValueError, match="lists were built"):
        tcm.matvec_t(stale, x)
    with pytest.raises(ValueError, match="lists were built"):
        tcm.matvec(stale, y)
    assert tcm.with_lists(stale._replace(lists=None)).lists is None   # CPU: no lists
