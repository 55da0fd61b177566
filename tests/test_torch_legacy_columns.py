"""The legacy hand-assembled column kinds of ``ops/blocked_affinity``
(``text_split``, ``text``, ``text_norm``, ``embedding_unit``, ``embedding``
and raw ``default``) against the JAX package's ``fused_rowblock`` on the
same hand-built ``Columns``: the strip route only, on both select modes (a
legacy kind has no binned candidate route, so ``select="binned"`` takes the
strip too).  Each kind alone and beside a username modality.

Tolerance: the dot-product kinds sum in another order than XLA (the JAX
package's ``text`` is ``Precision.HIGH``, exact f32 on its CPU; the port's
true fp32), so edges agree on >= 99.9% with every row's degree equal;
on these inputs they are bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import blocked_affinity as jba
from mused_tpu_torch.ops import blocked_affinity as tba
from torch_parity import n as tonp, t

N, BLOCK, K = 128, 32, 4
STARTS = (0, 64, 96)
KINDS = tba.LEGACY_KINDS


def _panel(kind, rng):
    """(tensor as numpy, valid) of one legacy kind."""
    if kind == "text_split":
        x = rng.normal(size=(N, 64)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        # the bf16 [hi | lo] halves, held as the f32 values they are exactly
        return np.asarray(jba.split_bf16(jnp.asarray(x)), np.float32), np.ones(N, bool)
    if kind == "text":
        x = rng.poisson(0.3, size=(N, 96)).astype(np.float32)
        return x, x.sum(1) > 0
    if kind in ("text_norm", "embedding_unit"):
        x = rng.normal(size=(N, 24)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True), np.ones(N, bool)
    x = rng.normal(size=(N, 12)).astype(np.float32)
    x[::11] = np.nan if kind == "embedding" else np.inf
    return x, np.all(np.isfinite(x), axis=1)


def _columns(kind, with_user: bool, idf: bool):
    rng = np.random.default_rng(KINDS.index(kind))
    x, valid = _panel(kind, rng)
    idf_v = rng.uniform(1.0, 3.0, size=x.shape[1]).astype(np.float32) if idf else None
    kinds, tensors, valids = [kind], [x], [valid]
    if with_user:
        uid = rng.integers(-1, 20, size=N).astype(np.int32)
        kinds, tensors, valids = ["username"] + kinds, [uid] + tensors, [uid >= 0] + valids
    split = [kind == "text_split" and a.dtype == np.float32 for a in tensors]
    jcols = jba.Columns(kinds=tuple(kinds),
                        tensors=tuple(jnp.asarray(a, jnp.bfloat16) if b else jnp.asarray(a)
                                      for a, b in zip(tensors, split)),
                        valids=tuple(jnp.asarray(v) for v in valids),
                        idf=None if idf_v is None else jnp.asarray(idf_v))
    tcols = tba.Columns(kinds=tuple(kinds),
                        tensors=tuple(t(a).to(torch.bfloat16) if b else t(a)
                                      for a, b in zip(tensors, split)),
                        valids=tuple(t(v) for v in valids),
                        idf=None if idf_v is None else t(idf_v))
    return jcols, tcols


def _assert_rules(got, want):
    assert got.shape == want.shape
    assert np.mean(got == want) >= 0.999
    np.testing.assert_array_equal(got.sum(1), want.sum(1))


@pytest.mark.parametrize("select", ["strip", "binned"])
@pytest.mark.parametrize("with_user", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_legacy_kind_rowblock_matches_jax(kind, with_user, select):
    jcols, tcols = _columns(kind, with_user, idf=False)
    nbins = 32 if select == "binned" else 0
    for start in STARTS:
        want = np.asarray(jba.fused_rowblock(jcols, jnp.int32(start), BLOCK, K, select=select,
                                             nbins=nbins))
        got = tonp(tba.fused_rowblock(tcols, start, BLOCK, K, select=select, nbins=nbins))
        assert want.sum() > 0
        _assert_rules(got, want)


def test_text_kind_scales_by_the_columns_idf():
    jcols, tcols = _columns("text", False, idf=True)
    plain = tonp(tba.fused_rowblock(_columns("text", False, idf=False)[1], 0, BLOCK, K))
    want = np.asarray(jba.fused_rowblock(jcols, jnp.int32(0), BLOCK, K))
    got = tonp(tba.fused_rowblock(tcols, 0, BLOCK, K))
    _assert_rules(got, want)
    assert not np.array_equal(got, plain)


def test_legacy_kinds_have_no_candidate_route():
    _, tcols = _columns("embedding", True, idf=False)
    assert not tba.cand_fold_supported(tcols.kinds, tcols.tensors, 32, N)
    cand = tba.candidate_rowblock(tcols, 0, BLOCK, K, 32)      # the username only
    assert torch.equal(cand.slabs, torch.full((1, BLOCK, 32), -1, dtype=torch.int8))
    with pytest.raises(ValueError, match="cand_fold_supported"):
        tba.blocked_fd_sketch(tcols, ell=8, block=BLOCK, k_basis=K, select="binned",
                              nbins=32, cand_fold=True)


def test_unknown_kind_is_raw_default_as_in_jax():
    jcols, tcols = _columns("default", False, idf=False)
    want = np.asarray(jba.fused_rowblock(jcols._replace(kinds=("raw_pixels",)),
                                         jnp.int32(0), BLOCK, K))
    got = tonp(tba.fused_rowblock(tcols._replace(kinds=("raw_pixels",)), 0, BLOCK, K))
    np.testing.assert_array_equal(got, want)
