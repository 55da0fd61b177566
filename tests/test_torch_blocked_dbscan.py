"""The port's blocked DBSCAN and Borůvka HDBSCAN vs the JAX package's
``ops/blocked_dbscan`` / ``ops/blocked_hdbscan`` and the port's dense
versions, on the CPU.

Every fixture is checked to hold no pair within 1e-4 relative of eps (the
eps test sits on expanded-norm products, which two BLAS builds may round
apart).  Tolerances: labels bit-equal to the JAX package's blocked
functions; ``dbscan_blocked`` bit-equal to the port's dense ``dbscan``;
``hdbscan_blocked`` equal in partition to the host Prim path (Borůvka and
Prim may pick different equal-weight MST edges, and label numbering
follows the tree); ``_min_outgoing``'s columns bit-equal to the JAX
package's on exact ties (the lowest column wins on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import blocked_dbscan as jbd
from mused_tpu.ops import blocked_hdbscan as jbh
from mused_tpu.ops import dbscan as jdb
from mused_tpu_torch.ops import blocked_dbscan as tbd
from mused_tpu_torch.ops import blocked_hdbscan as tbh
from mused_tpu_torch.ops import dbscan as tdb
from torch_parity import n as tonp, t


def _clear_of_eps(x, eps, rel=1e-4):
    d = np.sqrt(((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1))
    assert not np.any(np.abs(d - eps) <= rel * eps), "a pair sits at eps"
    return x


def blobs(seed, k=3, n_per=50, d=6, noise=10):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 8
    pts = np.concatenate([c + rng.normal(size=(n_per, d)) * 0.1 for c in centers])
    return np.concatenate([pts, rng.uniform(-15, 15, size=(noise, d))]).astype(np.float32)


def _same_partition(a, b) -> bool:
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


@pytest.mark.parametrize("seed,block", [(0, 32), (1, 64), (2, 37), (3, 160), (4, 2048)])
def test_dbscan_blocked_bit_equal(seed, block):
    """Blocks that divide n, blocks that force padding rows, and a block
    larger than n (clamped to n)."""
    x = _clear_of_eps(blobs(seed), 1.0)
    got = tbd.dbscan_blocked(x, eps=1.0, min_samples=3, block=block, device="cpu")
    want = jbd.dbscan_blocked(x, eps=1.0, min_samples=3, block=block)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tdb.dbscan(x, eps=1.0, min_samples=3, device="cpu"))
    # a tensor keeps its own device
    np.testing.assert_array_equal(tbd.dbscan_blocked(torch.from_numpy(x), 1.0, 3, block), got)


def test_dbscan_blocked_uniform_points_bit_equal():
    """Long branching core chains and many border points."""
    seed = 5
    while True:
        x = np.random.default_rng(seed).uniform(-4, 4, size=(300, 3)).astype(np.float32)
        try:
            _clear_of_eps(x, 0.9)
            break
        except AssertionError:
            seed += 1000
    got = tbd.dbscan_blocked(x, 0.9, 4, block=48, device="cpu")
    np.testing.assert_array_equal(got, jbd.dbscan_blocked(x, 0.9, 4, block=48))
    np.testing.assert_array_equal(got, tdb.dbscan(x, 0.9, 4, device="cpu"))


def test_chain_needs_pointer_jumping():
    """A 300-point chain (diameter 300) in far fewer than 300 rounds: its
    labels after 8 rounds are final, and equal the JAX package's."""
    x = np.stack([np.arange(300, dtype=np.float32) * 0.9, np.zeros(300, np.float32)], 1)
    got = tbd.dbscan_blocked(x, eps=1.0, min_samples=2, block=64, max_rounds=8,
                             device="cpu")
    assert (got == 0).all()
    np.testing.assert_array_equal(got, jbd.dbscan_blocked(x, 1.0, 2, block=64,
                                                          max_rounds=32))
    assert tbd.dbscan_blocked(x[:0], device="cpu").shape == (0,)


def test_pad_rows_far_but_finite():
    x = torch.zeros((5, 3))
    xp = tbd._pad_rows(x, 4)
    assert xp.shape == (8, 3) and torch.all(xp[5:] == 1e15)
    np.testing.assert_array_equal(tonp(xp), np.asarray(jbd._pad_rows(jnp.zeros((5, 3)), 4)))
    assert tbd._pad_rows(x[:4], 4).shape == (4, 3)


@pytest.mark.parametrize("seed,block,mcs,ms", [(0, 32, 5, 3), (1, 64, 5, 3), (2, 41, 5, 3),
                                               (3, 2048, 4, 2)])
def test_hdbscan_blocked_bit_equal_and_prim_partition(seed, block, mcs, ms):
    x = blobs(seed, d=5, noise=8)
    got = tbh.hdbscan_blocked(x, mcs, ms, block=block, device="cpu")
    np.testing.assert_array_equal(got, jbh.hdbscan_blocked(x, mcs, ms, block=block))
    prim = tdb.hdbscan(x, mcs, ms, device="cpu")
    assert _same_partition(got, prim)
    np.testing.assert_array_equal(got == -1, prim == -1)


def test_hdbscan_blocked_duplicates():
    """Exact duplicates: zero-distance MST edges and tied minimum edges."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(2, 4)) * 8
    x = np.concatenate([np.repeat(base[0][None], 12, axis=0),
                        base[1] + rng.normal(size=(12, 4)) * 0.05]).astype(np.float32)
    got = tbh.hdbscan_blocked(x, 4, 2, block=8, device="cpu")
    np.testing.assert_array_equal(got, jbh.hdbscan_blocked(x, 4, 2, block=8))
    assert _same_partition(got, tdb.hdbscan(x, 4, 2, device="cpu"))
    assert tbh.hdbscan_blocked(x[:0], device="cpu").shape == (0,)
    assert list(tbh.hdbscan_blocked(x[:1], device="cpu")) == [-1]


def test_min_outgoing_takes_the_lowest_column_on_ties():
    """With every core distance above every pairwise distance, each row's
    mutual-reachability edges all weigh the same: the minimum edge is the
    lowest column of another component, in both packages (``jnp.argmin``
    and ``torch.argmin`` both return the first minimal index)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=(6, 3)), np.repeat(rng.normal(size=(1, 3)), 6, 0)])
    x = x.astype(np.float32)
    core = np.full(len(x), 50.0, np.float32)
    comp = np.array([0, 0, 2, 2, 4, 4, 6, 6, 6, 9, 9, 9], np.int32)
    w_t, col_t = tbh._min_outgoing(t(x), t(core), t(comp).long(), block=4)
    w_j, col_j = jbh._min_outgoing(jnp.asarray(x), jnp.asarray(core), jnp.asarray(comp),
                                   block=4)
    np.testing.assert_array_equal(tonp(col_t), np.asarray(col_j))
    np.testing.assert_array_equal(tonp(w_t), np.asarray(w_j))
    want = [int(np.argmax(comp != c)) for c in comp]        # first other-component column
    assert tonp(col_t).tolist() == want


def test_core_distances_match_jax():
    """Squared core distances of the real rows within the expanded-norm
    form's rounding (a few ulps of the largest squared norm: small distances
    come out of a cancellation, which two BLAS builds round apart)."""
    x = blobs(6, d=4, noise=5)
    xp = tbd._pad_rows(t(x), 32)
    got = tonp(tbh._core_distances(xp, min_samples=3, block=32, n_real=len(x)))
    want = np.asarray(jbh._core_distances(jnp.asarray(tonp(xp)), min_samples=3,
                                          block=32, n_real=len(x)))
    scale = float((x.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(got[:len(x)] ** 2, want[:len(x)] ** 2, rtol=0,
                               atol=16 * 2.0 ** -24 * scale)
