"""K4 / K5 as gathers over a block's candidate lists, and the list kernels,
against their plain versions on a CUDA device.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_cand_matvec.py

Tolerances: bit-equal.  The lists are integers and must equal the plain
lists exactly; the products run on small-integer bf16 operands, whose f32
sums are exact in any order, and the edge count is an exact integer.  Two
launches on real-valued operands must give the same bits (no float
atomics).  The cases (``cand_cases``): a group kept by two planes, slab
edges whose column has the row's uid, the self pair inside and outside the
block, g0 != 0, one user owning most of the window, empty slabs with valid
uids, nbins % 16 != 0 (40), no usernames; and the huge window's real block
(2048 x 1536, 64 groups, four planes, about 300 kept entries per row).
A block that replaced a field and kept its lists must raise.
"""
import numpy as np
import pytest
import torch

from cand_cases import CASES, cand_case, torch_cand
from mused_tpu_torch.ops.kernels import cand_matvec as cm

WIDTHS = (66, 132, 128, 256)     # the fold's live r and the JAX package's padded ones


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _real_block(device, one_user=False):
    """The huge window's block shape: about 300 kept entries per row over
    four planes, uids of ~50 rows each (or one user owning 90%)."""
    case = cand_case("one_user" if one_user else "random", block=2048, nbins=1536,
                     groups=64, n_mod=4, seed=3, keep=0.05)
    slabs, uid_rows, uid_cols, start, g0 = case
    if not one_user:
        rng = np.random.default_rng(4)
        uid_rows = rng.integers(0, 2000, uid_rows.shape).astype(np.int32)
        uid_cols = rng.integers(0, 2000, uid_cols.shape).astype(np.int32)
    return torch_cand(cm, (slabs, uid_rows, uid_cols, 4 * 1536, 0), device)


def _ints(shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-4, 5, shape, generator=g).to(torch.bfloat16).to(device)


def _assert_lists_equal(cand, lists):
    want = {k: v.long() if isinstance(v, torch.Tensor) else v
            for k, v in cm.lists_reference(cand).items()}
    e = want["rowcols"].numel()
    for name in ("rowptr", "colptr"):
        assert torch.equal(lists.array(name).long(), want[name]), name
    for name in ("rowcols", "colrows"):
        assert torch.equal(lists.array(name)[:e].long(), want[name]), name
    assert int(lists.edges[0]) == want["edges"]
    if cand.uid_rows is None:
        return
    nu = int(lists.array("nu")[0])
    assert nu == int(want["nu"][0])
    assert torch.equal(lists.array("uids")[:nu].long(), want["uids"])
    assert torch.equal(lists.array("userptr")[:nu + 1].long(), want["userptr"])
    for name in ("userrows", "row_user", "col_user"):
        assert torch.equal(lists.array(name).long(), want[name]), name
    ucolptr = lists.array("hoff")[torch.arange(nu + 1, device=want["uids"].device) * lists.q]
    assert torch.equal(ucolptr.long(), want["ucolptr"])
    t = want["ucols"].numel()
    assert torch.equal(lists.array("ucols")[:t].long(), want["ucols"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_lists_equal_the_plain_lists(name, cuda):
    cand = torch_cand(cm, cand_case(name), cuda)
    before = cm.launches_lists
    lists = cm.build_lists(cand)
    torch.cuda.synchronize()
    assert cm.launches_lists == before + 1
    _assert_lists_equal(cand, lists)


@pytest.mark.cuda
@pytest.mark.parametrize("one_user", [False, True])
def test_lists_of_the_real_block(one_user, cuda):
    cand = _real_block(cuda, one_user)
    lists = cm.build_lists(cand)
    torch.cuda.synchronize()
    _assert_lists_equal(cand, lists)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("r", WIDTHS)
def test_k4_k5_equal_plain(name, r, cuda):
    """Integer operands: K4, K5 and the edge count equal the plain versions
    bit for bit, with the lists built once and shared (one list launch)."""
    cand = cm.with_lists(torch_cand(cm, cand_case(name), cuda))
    x_t = _ints((r, cand.block), 1, cuda)
    y = _ints((cand.groups * cand.nbins, r), 2, cuda)
    before = (cm.launches_t, cm.launches, cm.launches_lists)
    out_t, edges = cm.matvec_t(cand, x_t)
    out = cm.matvec(cand, y)
    torch.cuda.synchronize()
    assert (cm.launches_t, cm.launches, cm.launches_lists) == (before[0] + 1, before[1] + 1,
                                                               before[2])
    want_t, want_edges = cm.matvec_t_reference(cand, x_t)
    assert torch.equal(out_t, want_t)
    assert torch.equal(out, cm.matvec_reference(cand, y))
    assert edges.item() == want_edges.item() == cm.dense_rows_reference(cand).sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("one_user", [False, True])
@pytest.mark.parametrize("r", WIDTHS)
def test_k4_k5_at_the_real_block(one_user, r, cuda):
    cand = cm.with_lists(_real_block(cuda, one_user))
    x_t = _ints((r, cand.block), 5, cuda)
    y = _ints((cand.groups * cand.nbins, r), 6, cuda)
    out_t, edges = cm.matvec_t(cand, x_t)
    out = cm.matvec(cand, y)
    want_t, want_edges = cm.matvec_t_reference(cand, x_t)
    torch.cuda.synchronize()
    assert torch.equal(out_t, want_t)
    assert torch.equal(out, cm.matvec_reference(cand, y))
    # one user's 90% makes 163 M edges, past f32's exact integers: the count
    # is exact in the lists, and K4 returns it rounded to f32 once
    dense = int(cm.dense_rows_reference(cand).sum())
    assert int(cand.lists.edges[0]) == cm.lists_reference(cand)["edges"] == dense
    assert edges.item() == torch.tensor(float(dense), dtype=torch.float32).item()


@pytest.mark.cuda
@pytest.mark.parametrize("with_user", [True, False])
@pytest.mark.parametrize("r", WIDTHS)
def test_two_launches_give_the_same_bits(with_user, r, cuda):
    """Real-valued operands, where the summation order shows: the lists and
    both products are bit-identical over two launches."""
    cand = _real_block(cuda)
    if not with_user:
        cand = cand._replace(uid_rows=None)
    g = torch.Generator().manual_seed(7)
    x_t = torch.randn((r, cand.block), generator=g).to(torch.bfloat16).to(cuda)
    y = torch.randn((cand.groups * cand.nbins, r), generator=g).to(torch.bfloat16).to(cuda)
    runs = []
    for _ in range(2):
        c = cm.with_lists(cand)
        runs.append((c.lists.workspace.clone(), *cm.matvec_t(c, x_t), cm.matvec(c, y)))
    torch.cuda.synchronize()
    lists = cm.with_lists(cand).lists
    e = int(lists.array("colptr")[-1])
    for name in ("rowcols", "colrows"):
        k = lists.names.index(name)
        a, b = (w[lists.offsets[k]:lists.offsets[k] + e] for w, *_ in runs)
        assert torch.equal(a, b), name
    for a, b in zip(runs[0][1:], runs[1][1:]):
        assert torch.equal(a, b)
    want_t, _ = cm.matvec_t_reference(cand, x_t)
    scale = want_t.abs().max().item()
    assert (runs[0][1] - want_t).abs().max().item() <= 1e-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["slabs", "uid_rows", "uid_cols", "start", "g0"])
def test_stale_lists_raise(field, cuda):
    """A block that replaced a field and kept its lists raises in K4 and K5
    and launches nothing; dropping the lists builds them anew, equal to the
    plain products."""
    cand = cm.with_lists(torch_cand(cm, cand_case("uid_on_slab_edges"), cuda))
    other = {"slabs": cand.slabs.clone(), "uid_rows": None, "uid_cols": cand.uid_cols.clone(),
             "start": cand.start + 1, "g0": cand.g0 + 1}[field]
    stale = cand._replace(**{field: other})
    x_t = _ints((66, cand.block), 8, cuda)
    y = _ints((cand.groups * cand.nbins, 66), 9, cuda)
    before = (cm.launches_t, cm.launches, cm.launches_lists)
    with pytest.raises(ValueError, match="lists were built"):
        cm.matvec_t(stale, x_t)
    with pytest.raises(ValueError, match="lists were built"):
        cm.matvec(stale, y)
    assert (cm.launches_t, cm.launches, cm.launches_lists) == before
    fresh = cm.with_lists(stale._replace(lists=None))
    out_t, edges = cm.matvec_t(fresh, x_t)
    want_t, want_edges = cm.matvec_t_reference(fresh, x_t)
    torch.cuda.synchronize()
    assert torch.equal(out_t, want_t) and edges.item() == want_edges.item()
    assert torch.equal(cm.matvec(fresh, y), cm.matvec_reference(fresh, y))
