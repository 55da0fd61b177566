"""Slice 2f's sketches against the JAX package: the Newton-Schulz shrink
(``fd._ns_inv_sqrt``, ``fd._subspace_basis``, ``fd.shrink_fast``, the
``"subspace"`` modes of ``update_stream``) and row-granular SWFD
(``swfd.update`` and the ``SeqBasedSWFD`` drop-in).

Tolerances.  ``_ns_inv_sqrt``: 1e-5 of the largest entry.  With the JAX
probe injected, ``_subspace_basis`` gives the same health verdict on the
fixtures of ``tests/test_fd.py`` and a basis within 1e-4; ``shrink_fast``
B'^T B' within 1e-4 of its largest entry on a stack with a spectral gap at
ell (56 sequential small products amplify summation-order differences, so
nothing here is bit-equal).  SWFD in eigh mode: counters, ``block_end`` and
the seal cursor exactly equal, each block's and the query's B^T B within
1e-5 (a sketch row's sign is LAPACK's choice, so Grams are compared).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import fd as jfd
from mused_tpu.ops import swfd as jswfd
from mused_tpu_torch.ops import fd as tfd
from mused_tpu_torch.ops import swfd as tswfd
from torch_parity import jax_probe, n, t


def _gram(x) -> np.ndarray:
    x = n(x).astype(np.float64)
    return x.T @ x


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _gap_stack(rng, rows, d, ell, gap=3.0):
    """Rows whose top ell directions are at least ``gap`` times stronger than
    the rest (a gap the Newton-Schulz basis resolves: the gate passes)."""
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
    scales = np.concatenate([np.linspace(2.0 * gap, gap, ell), np.ones(d - ell)])
    return ((rng.normal(size=(rows, d)) * scales) @ basis.T).astype(np.float32)


def _fixtures(rng):
    """tests/test_fd.py's health-gate fixtures: full rank, tie-degenerate,
    rank-deficient (64 x 128, ell 16)."""
    gauss = rng.normal(size=(64, 128)).astype(np.float32)
    base = rng.normal(size=(24, 128)).astype(np.float32)
    ties = np.concatenate([base, base, base[:16]])
    rankdef = (rng.normal(size=(64, 8)).astype(np.float32)
               @ rng.normal(size=(8, 128)).astype(np.float32))
    return {"gauss": (gauss, True), "ties": (ties, False), "rankdef": (rankdef, False)}


# ---------------------------------------------------------------------------
# Newton-Schulz shrink
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [8, 32, 66])
def test_ns_inv_sqrt_matches_jax(m, rng):
    a = rng.normal(size=(m, m + 4)).astype(np.float32)
    z = a @ a.T
    want = np.asarray(jfd._ns_inv_sqrt(jnp.asarray(z)))
    _close(n(tfd._ns_inv_sqrt(t(z))), want, 1e-5)


@pytest.mark.parametrize("name", ["gauss", "ties", "rankdef"])
def test_subspace_basis_health_and_basis_match_jax(name, rng):
    """The same verdict on all three; the same basis where it is defined.  On
    the rank-deficient stack the iterate's null-space columns are rounding
    noise amplified by the near-singular inverse square root (either side's
    summation order gives other noise); the gate discards that basis."""
    x, healthy = _fixtures(rng)[name]
    jh, jv = jfd._subspace_basis(jnp.asarray(x), 16, oversample=16, sub_iters=4)
    th, tv = tfd._subspace_basis(t(x), 16, oversample=16, sub_iters=4,
                                 probe=t(jax_probe(64, 32)))
    assert bool(th) == bool(jh) == healthy
    if name != "rankdef":
        _close(n(tv), np.asarray(jv), 1e-4)


def test_subspace_basis_clamps_the_oversample():
    """oversample = min(oversample, m2 - ell): a 20-row stack at ell 16 keeps
    a 20-column basis (the JAX package's clamp)."""
    x = np.random.default_rng(1).normal(size=(20, 40)).astype(np.float32)
    _, v = tfd._subspace_basis(t(x), 16, oversample=16, sub_iters=4)
    _, jv = jfd._subspace_basis(jnp.asarray(x), 16, oversample=16, sub_iters=4)
    assert tuple(v.shape) == tuple(jv.shape) == (20, 20)


def test_shrink_fast_matches_jax_on_a_spectral_gap(rng):
    ell = 12
    s = _gap_stack(rng, 160, 256, ell)
    jb, jd = jfd.shrink_fast(jnp.asarray(s), ell)
    before = tfd.fast_shrinks
    tb, td = tfd.shrink_fast(t(s), ell, probe=t(jax_probe(160, ell + 16)))
    assert tfd.fast_shrinks == before + 1
    _close(_gram(tb), _gram(jb), 1e-4)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-4)


@pytest.mark.parametrize("mode", ["subspace", "subspace_ns"])
def test_update_stream_subspace_matches_jax(mode, rng):
    """Two Newton-Schulz blocks (the default block is 16 ell) with the JAX
    probe injected: B'^T B', the shrink loss and the counters."""
    ell, m, d = 8, 200, 256
    a = _gap_stack(rng, m, d, ell)
    js = jfd.update_stream(jfd.init(ell, d), jnp.asarray(a), mode=mode)
    ts = tfd.update_stream(tfd.init(ell, d, "cpu"), t(a), mode=mode,
                           probe=t(jax_probe(ell + 16 * ell, ell + 16)))
    _close(_gram(ts.sketch), _gram(js.sketch), 1e-4)
    np.testing.assert_allclose(float(ts.shrink_loss), float(js.shrink_loss), rtol=1e-4)
    np.testing.assert_allclose(float(ts.sq_frobenius), float(js.sq_frobenius), rtol=1e-6)
    assert int(ts.count) == int(js.count) == m


@pytest.mark.parametrize("name", ["gauss", "duplicates", "rankdef"])
def test_subspace_never_overestimates_and_loss_bounds_the_error(name, rng):
    """On the port alone: B^T B <= A^T A, and the summed trace residuals
    bound ||A^T A - B^T B||_2 (tests/test_fd.py's honest-bound streams)."""
    if name == "gauss":
        a = rng.normal(size=(400, 64)).astype(np.float32)
    elif name == "duplicates":
        distinct = rng.normal(size=(40, 64)).astype(np.float32)
        a = distinct[rng.integers(0, 40, 600)] + 0.01 * rng.normal(size=(600, 64)).astype(
            np.float32)
    else:
        a = rng.normal(size=(400, 5)).astype(np.float32) @ rng.normal(size=(5, 64)).astype(
            np.float32)
    st = tfd.update_stream(tfd.init(16, 64, "cpu"), t(a), mode="subspace")
    diff = a.T.astype(np.float64) @ a - _gram(st.sketch)
    scale = float(np.linalg.norm(a.T.astype(np.float64) @ a, 2))
    assert np.linalg.eigvalsh(diff).min() >= -max(1e-2 * np.abs(diff).max(), 1e-5 * scale)
    assert float(np.linalg.norm(diff, 2)) <= float(st.shrink_loss) * 1.01 + 1e-5 * scale


def test_health_gate_routes_degenerate_stacks_to_eigh(rng):
    """A rank-deficient block takes the exact shrink (counted), and matches
    it; a healthy one takes the fast branch."""
    fx = _fixtures(rng)
    fast, slow = tfd.fast_shrinks, tfd.fallback_shrinks
    b, d = tfd.shrink_fast(t(fx["rankdef"][0]), 16)
    want_b, want_d = tfd.shrink(t(fx["rankdef"][0]), 16)
    assert (tfd.fast_shrinks, tfd.fallback_shrinks) == (fast, slow + 1)
    assert torch.equal(b, want_b) and torch.equal(d, want_d)
    tfd.shrink_fast(t(fx["gauss"][0]), 16)
    assert tfd.fast_shrinks == fast + 1


# ---------------------------------------------------------------------------
# row-granular SWFD
# ---------------------------------------------------------------------------

def _swfd_equal(ts, js, rtol=1e-5):
    assert ts.count == int(js.count) and ts.seal_cursor == int(js.seal_cursor)
    assert ts.active_rows == int(js.active.count) == int(ts.active.count)
    np.testing.assert_array_equal(n(ts.block_end), np.asarray(js.block_end))
    for got, want in zip(n(ts.blocks), np.asarray(js.blocks)):
        _close(_gram(got), _gram(want), rtol)
    _close(_gram(ts.active.sketch), _gram(js.active.sketch), rtol)
    np.testing.assert_allclose(n(ts.block_sqfro), np.asarray(js.block_sqfro), rtol=1e-6)
    np.testing.assert_allclose(n(ts.block_loss), np.asarray(js.block_loss), rtol=1e-4,
                               atol=1e-4 * float(np.asarray(js.block_sqfro).max()))


@pytest.mark.parametrize("sizes", [(16, 16, 16, 16), (3, 4, 1, 7, 5, 4, 8, 6, 2), (40, 9)])
def test_swfd_update_matches_jax(sizes, rng):
    """Aligned and unaligned calls: the seal test (decided on the host from
    the valid counts) seals where the JAX scan's device test does."""
    window, d, ell, block_rows = 16, 12, 4, 4
    rows = rng.normal(size=(sum(sizes), d)).astype(np.float32)
    js = jswfd.init(window, d, ell, block_rows=block_rows)
    ts = tswfd.init(window, d, ell, block_rows=block_rows, device="cpu")
    fed = 0
    for sz in sizes:
        js = jswfd.update(js, jnp.asarray(rows[fed:fed + sz]), window=window,
                          block_rows=block_rows)
        ts = tswfd.update(ts, t(rows[fed:fed + sz]), window=window, block_rows=block_rows)
        fed += sz
        _swfd_equal(ts, js)
    jq = jswfd.query(js, window=window, sketch_dim=ell)
    tq = tswfd.query(ts, window=window, sketch_dim=ell)
    _close(_gram(tq[0]), _gram(jq[0]), 1e-5)
    np.testing.assert_allclose([float(tq[1]), float(tq[2])], [float(jq[1]), float(jq[2])],
                               rtol=1e-5)
    assert tq[3] == int(jq[3])


def test_swfd_update_n_valid_masks_the_padding(rng):
    window, d, ell = 12, 8, 4
    rows = np.zeros((6, d), np.float32)
    rows[:3] = rng.normal(size=(3, d))
    js = jswfd.update(jswfd.init(window, d, ell), jnp.asarray(rows), window=window,
                      block_rows=3, n_valid=jnp.int32(3))
    ts = tswfd.update(tswfd.init(window, d, ell, device="cpu"), t(rows), window=window,
                      block_rows=3, n_valid=3)
    _swfd_equal(ts, js)
    assert ts.count == 3 and ts.seal_cursor == 1


@pytest.mark.parametrize("fits", ["rows", "blocks", "unaligned"])
def test_seq_based_swfd_matches_jax(fits, rng):
    """The drop-in's fit / get on both packages: same ring, same query."""
    N, d, sk = 32, 20, 6
    stream = rng.normal(size=(100, d)).astype(np.float32)
    sizes = {"rows": [1] * 100, "blocks": [25] * 4,
             "unaligned": [3, 11, 1, 30, 7, 19, 29]}[fits]
    jd = jswfd.SeqBasedSWFD(N=N, R=1.0, d=d, sketch_dim=sk)
    td = tswfd.SeqBasedSWFD(N=N, R=1.0, d=d, sketch_dim=sk, device="cpu")
    assert (td.ell, td.block_rows, td.chunk) == (jd.ell, jd.block_rows, jd.chunk)
    fed = 0
    for i, sz in enumerate(sizes):
        jd.fit(stream[fed:fed + sz])
        td.fit(stream[fed:fed + sz])
        fed += sz
        assert td._pending_n == jd._pending_n
        if i % 7 == 6 or i == len(sizes) - 1:
            jq, tq = jd.get(), td.get()
            _close(_gram(tq[0]), _gram(jq[0]), 1e-5)
            np.testing.assert_allclose(float(tq[1]), float(jq[1]), rtol=1e-5)
            assert tq[3] == int(jq[3])
    _swfd_equal(td.state, jd.state)


def _window_cov_error(stream: np.ndarray, sketch, window: int) -> float:
    w = stream[-window:].astype(np.float64)
    return float(np.linalg.norm(w.T @ w - _gram(sketch), 2))


def test_swfd_tumbling_coverage_and_expiry(rng):
    """tests/test_swfd.py's coverage (window-aligned queries obey the FD
    bound over the window's rows) and expiry (old mass is gone)."""
    n_, d, ell = 64, 48, 16
    st = tswfd.init(n_, d, ell, device="cpu")
    br = tswfd.choose_block_rows(n_, ell)
    seen = []
    for w in range(5):
        rows = rng.normal(size=(n_, d)).astype(np.float32) * (w + 1)
        seen.append(rows)
        st = tswfd.update(st, t(rows), window=n_, block_rows=br)
        sketch, _, _, count = tswfd.query(st, window=n_, sketch_dim=ell)
        assert count == n_
        bound = np.linalg.norm(rows, "fro") ** 2 / ell * 2.0
        assert _window_cov_error(np.concatenate(seen), sketch, n_) <= bound
    n_, d, ell = 32, 32, 8
    br = tswfd.choose_block_rows(n_, ell)
    st = tswfd.update(tswfd.init(n_, d, ell, device="cpu"),
                      t(rng.normal(size=(3 * n_, d)).astype(np.float32) * 1e3),
                      window=n_, block_rows=br)
    small = rng.normal(size=(n_, d)).astype(np.float32)
    st = tswfd.update(st, t(small), window=n_, block_rows=br)
    sketch = tswfd.query(st, window=n_, sketch_dim=ell)[0]
    assert float(torch.sum(sketch * sketch)) <= np.linalg.norm(small, "fro") ** 2 * 1.05


def test_seq_based_swfd_reference_contract_and_unaligned_seals(rng):
    """Reference main.py:60-76: constructor, row-wise fit, a 4-tuple get with
    a (sketch_dim, d) first element; mixed-size fits seal exactly every
    block_rows rows."""
    n_, d, ell = 16, 24, 4
    fused = rng.integers(0, 2, size=(n_, d)).astype(np.float32)
    sk = tswfd.SeqBasedSWFD(N=n_, R=float(np.max(np.sum(fused ** 2, 1))), d=d,
                            sketch_dim=ell, device="cpu")
    for i in range(n_):
        sk.fit(fused[i, :].reshape(1, -1))
    out = sk.get()
    assert len(out) == 4 and tuple(out[0].shape) == (ell, d)
    assert _window_cov_error(fused, out[0], n_) <= np.linalg.norm(fused, "fro") ** 2 / ell * 2

    sk = tswfd.SeqBasedSWFD(N=16, R=1.0, d=12, sketch_dim=4, device="cpu")
    rows = rng.normal(size=(40, 12)).astype(np.float32)
    fed = 0
    for sz in (3, 4, 1, 7, 5, 4, 8, 6, 2):
        sk.fit(rows[fed:fed + sz])
        fed += sz
    ends = n(sk.state.block_end)
    assert len(ends[ends >= 0]) and all(int(e) % sk.block_rows == 0 for e in ends[ends >= 0])
    w = rows[fed - 16:fed].astype(np.float64)
    assert float(np.linalg.norm(w.T @ w - _gram(sk.get()[0]), 2)) <= \
        np.linalg.norm(w, "fro") ** 2 / 4 * 2.5


@pytest.mark.parametrize("mode", ["eigh", "subspace_ns", "rr"])
def test_query_err_bounds_the_live_window_error(mode, rng):
    """swfd.query's err bounds the true covariance error of the live window,
    with whole-window folds sealed through absorb_summary."""
    window, d, ell = 128, 64, 16
    state = tswfd.init(window, d, ell, block_rows=window, device="cpu")
    for _ in range(4):
        rows = rng.normal(size=(window, d)).astype(np.float32)
        blk, sq_fro, loss = tfd.fold_sketch(t(rows), ell=ell, mode=mode)
        state = tswfd.absorb_summary(state, blk, window, sq_fro, loss)
        sketch, err, _, _ = tswfd.query(state, window=window, sketch_dim=ell)
        assert _window_cov_error(rows, sketch, window) <= float(err) * 1.01


def test_seq_based_swfd_headroom_improves_accuracy(rng):
    N, d, sk_dim = 128, 64, 8
    u, _ = np.linalg.qr(rng.normal(size=(d, d)))
    stream = ((rng.normal(size=(4 * N, d)) * np.exp(-np.arange(d) / 8.0)) @ u.T).astype(
        np.float32)

    def run(headroom):
        s = tswfd.SeqBasedSWFD(N=N, R=1.0, d=d, sketch_dim=sk_dim, headroom=headroom,
                               device="cpu")
        assert s.ell == sk_dim + headroom
        errs = []
        for i in range(0, len(stream), N):
            s.fit(stream[i:i + N])
            errs.append(_window_cov_error(stream[i:i + N], s.get()[0], N))
        return float(np.mean(errs))

    plain, slack = run(0), run(8)
    assert slack < plain * 0.98
    assert tswfd.SeqBasedSWFD(N=N, R=1.0, d=d, sketch_dim=4, device="cpu").ell == 8


def test_seq_based_swfd_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tswfd.SeqBasedSWFD(N=8, R=1.0, d=4, sketch_dim=2)


def test_shrink_retries_eigh_in_float64_where_float32_fails(rng, monkeypatch):
    """CPU LAPACK's float32 eigh can fail to converge on a query's stack of
    mostly empty ring slots; the shrink then takes the float64 solver."""
    s = np.zeros((40, 12), np.float32)
    s[:10] = rng.normal(size=(10, 12))
    want = tfd.shrink(t(s), 4)
    eigh = torch.linalg.eigh

    def flaky(g):
        if g.dtype == torch.float32:
            raise torch.linalg.LinAlgError("linalg.eigh: The algorithm failed to converge")
        return eigh(g)

    monkeypatch.setattr(torch.linalg, "eigh", flaky)
    got = tfd.shrink(t(s), 4)
    assert got[0].dtype == torch.float32
    _close(_gram(got[0]), _gram(want[0]), 1e-5)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-4, atol=1e-6)
