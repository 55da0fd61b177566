"""Port's FD / SWFD sketch vs the JAX package, and the state carried across.

Tolerances: with the JAX side's random probe injected, B^T B, delta and
sq_frobenius agree to rtol 1e-4 (fp32 LAPACK vs XLA eigh / QR rounding; the
sketch rows themselves are only defined up to sign, so Grams are compared).
The FD bound and the never-overestimate invariant are checked on the port
alone.
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

RTOL = 1e-4


def _gram_close(a, b, rtol=RTOL):
    ga, gb = n(a).T @ n(a), n(b).T @ n(b)
    np.testing.assert_allclose(gb, ga, rtol=rtol, atol=rtol * np.abs(ga).max())


def _spiked(rng, rows, d, rank=6):
    """Rows with a clearly decaying spectrum (well-separated top directions)."""
    basis = np.linalg.qr(rng.normal(size=(d, rank)))[0]
    scales = np.geomspace(10.0, 1.0, rank)
    a = (rng.normal(size=(rows, rank)) * scales) @ basis.T
    return (a + 0.05 * rng.normal(size=(rows, d))).astype(np.float32)


def test_shrink_eigh_matches_jax(rng):
    s = _spiked(rng, 24, 40)
    jb, jd = jfd.shrink(jnp.asarray(s), 8)
    tb, td = tfd.shrink(t(s), 8)
    _gram_close(jb, tb)
    np.testing.assert_allclose(float(td), float(jd), rtol=RTOL)


def test_shrink_rr_pair_matches_jax_with_injected_probe(rng):
    ell = 8
    sketch = _spiked(rng, ell, 48)
    rows = (rng.random((40, 48)) < 0.2).astype(np.float32)
    r = min(ell + 16, ell + 40)
    probe = jax_probe(ell + 40, r)
    jb, jd = jfd.shrink_rr_pair(jnp.asarray(sketch), jnp.asarray(rows), ell)
    tb, td = tfd.shrink_rr_pair(t(sketch), t(rows), ell, probe=t(probe))
    _gram_close(jb, tb)
    np.testing.assert_allclose(float(td), float(jd), rtol=RTOL)
    # the single-operand form agrees with the split one
    sb, sd = tfd.shrink_rr(torch.cat([t(sketch), t(rows)]), ell, probe=t(probe))
    _gram_close(tb, sb)
    np.testing.assert_allclose(float(sd), float(td), rtol=RTOL)


@pytest.mark.parametrize("mode", ["rr", "eigh"])
def test_fold_sketch_matches_jax(mode, rng):
    a = (rng.random((64, 64)) < 0.15).astype(np.float32)
    ell = 8
    probe = t(jax_probe(ell + 64, ell + 16)) if mode == "rr" else None
    jb, jsq, jl = jfd.fold_sketch(jnp.asarray(a), ell=ell, mode=mode)
    tb, tsq, tl = tfd.fold_sketch(t(a), ell=ell, mode=mode, probe=probe)
    _gram_close(jb, tb)
    np.testing.assert_allclose(float(tsq), float(jsq), rtol=RTOL)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)


@pytest.mark.parametrize("mode", ["rr", "eigh"])
def test_fd_bound_and_never_overestimate(mode, rng):
    a = _spiked(rng, 300, 32, rank=12)
    st = tfd.update_stream(tfd.init(8, 32, "cpu"), t(a), block_rows=40, mode=mode)
    err = float(tfd.covariance_error(t(a), st.sketch))
    assert err <= float(tfd.error_bound(st)) * (1 + 1e-4) + 1e-3
    assert err <= float(st.sq_frobenius) / 8 * (1 + 1e-4)
    diff = (t(a).T @ t(a) - st.sketch.T @ st.sketch).double()
    assert float(torch.linalg.eigvalsh(diff).min()) >= -1e-3 * float(st.sq_frobenius)
    assert int(st.count) == 300
    np.testing.assert_allclose(float(st.sq_frobenius), float((a.astype(np.float64) ** 2).sum()),
                               rtol=1e-5)


def test_zero_block_is_a_noop_and_modes_outside_the_slice_raise():
    """An all-zero block is a no-op in every mode; the Newton-Schulz modes run
    since slice 2f ("subspace" folds route to rr, "subspace_ns" stays NS);
    what remains refused is an unknown mode and power_iters = 0."""
    st = tfd.init(4, 8, "cpu")
    for mode in tfd.MODES:
        out = tfd.update_block(st, torch.zeros((5, 8)), mode=mode)
        assert torch.equal(out.sketch, st.sketch) and float(out.shrink_loss) == 0.0
        assert int(out.count) == 5
    with pytest.raises(ValueError):
        tfd.shrink_rr(torch.ones((12, 4)), 4, power_iters=0)
    with pytest.raises(ValueError, match="unknown fd shrink mode"):
        tfd.update_block(st, torch.ones((5, 8)), mode="nope")
    rows = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32))
    for mode in ("subspace", "subspace_ns"):
        out = tfd.update_block(st, rows, mode=mode)
        assert torch.isfinite(out.sketch).all() and int(out.count) == 5
    assert tfd.resolve_fold_mode("subspace") == "rr"
    assert tfd.resolve_fold_mode("subspace_ns") == "subspace_ns"
    b, delta = tfd.shrink_fast(torch.ones((12, 4)), 4)
    assert b.shape == (4, 4) and float(delta) >= 0.0


def test_swfd_absorb_and_query_match_jax(rng):
    window, d, ell = 32, 24, 6
    js = jswfd.init(window, d, ell, block_rows=window)
    ts = tswfd.init(window, d, ell, block_rows=window, device="cpu")
    for w in range(3):                  # 3 windows through a 2-slot ring
        blk = _spiked(rng, ell, d)
        sq, loss = float((blk ** 2).sum()) + 1.0, 0.5 * w
        js = jswfd.absorb_summary(js, jnp.asarray(blk), jnp.int32(window),
                                  jnp.float32(sq), jnp.float32(loss))
        ts = tswfd.absorb_summary(ts, t(blk), window, torch.tensor(sq), loss)
        jq = jswfd.query(js, window=window, sketch_dim=4)
        tq = tswfd.query(ts, window=window, sketch_dim=4)
        _gram_close(jq[0], tq[0])
        for a, b in zip(jq[1:3], tq[1:3]):
            np.testing.assert_allclose(float(b), float(a), rtol=RTOL)
        assert int(jq[3]) == tq[3]
    np.testing.assert_array_equal(n(ts.block_end), n(js.block_end))


def test_stream_state_from_jax_continues_a_jax_stream(rng, monkeypatch):
    """Two SWFDMC windows in the JAX engine, the state carried over, the
    third window in the port: the query sketch Gram matches the JAX engine's
    own third window."""
    import jax
    from mused_tpu.engine import streaming as js
    from mused_tpu_torch.engine import streaming as ts
    from mused_tpu_torch.utils.convert import stream_state_from_jax
    from mused_tpu.ops import kmeans as jkm
    monkeypatch.setattr(tfd, "default_probe", lambda m2, r, device: t(jax_probe(m2, r)))
    window, reduced = 48, 6
    jstate = js.StreamState(swfd=jswfd.init(window, window, reduced, block_rows=window),
                            minibatch=jkm.minibatch_init(2, reduced))
    fused = [(rng.random((window, window)) < 0.15).astype(np.float32) for _ in range(3)]
    kw = dict(approach="SWFDMC", k_basis=3, reduced_dim=reduced, k_max=2, window=window)
    for w in range(2):
        jstate, _, _ = js._window_step(jstate, jnp.asarray(fused[w]), jnp.int32(2),
                                       jax.random.key(w), **kw)
    tstate = stream_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    assert tstate.swfd.count == 2 * window and tstate.swfd.seal_cursor == 2
    j3, jred, _ = js._window_step(jstate, jnp.asarray(fused[2]), jnp.int32(2),
                                  jax.random.key(2), **kw)
    t3, tred, _ = ts._window_step_impl(tstate, t(fused[2]), 2,
                                       ts.window_generator(0, 2, "cpu"), **kw)
    _gram_close(n(jred).T, n(tred).T)
    jq = jswfd.query(j3.swfd, window=window, sketch_dim=reduced)[0]
    tq = tswfd.query(t3.swfd, window=window, sketch_dim=reduced)[0]
    _gram_close(jq, tq)
