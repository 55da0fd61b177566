"""Frequent Directions (FD) matrix sketching — port of ``mused_tpu/ops/fd.py``.

Maintain a sketch B with ell rows; absorbing a block C stacks S = [B; C] and
shrinks its spectrum so at most ell rows remain.  After any number of
absorbs ``0 <= x^T(A^T A - B^T B)x <= ||A||_F^2 / ell`` for unit x (Liberty
2013; Ghashami et al. 2015).  Zero rows are FD no-ops, so partial blocks
are zero-padded and an all-zero block skips its shrink.

Shrinks:
  ``shrink``        exact, from the eigendecomposition of the small Gram S S^T
  ``shrink_fast``   Newton-Schulz subspace iteration (matmuls only) with a
                    health gate that routes degenerate stacks to ``shrink``;
                    the ``"subspace"`` / ``"subspace_ns"`` modes of a stream
  ``shrink_rr``     Rayleigh-Ritz: randomized subspace iteration with QR
                    orthonormalization and a small eigh; the engine's fold
  ``shrink_rr_pair`` shrink_rr on the implicit stack [sketch; rows]
  ``shrink_rr_cands`` the same with the rows in candidate form (the
                    huge-window fold; products through kernels K4 / K5)

Every shrink and update takes an ``allreduce``: the identity on one device;
a column-sharded fold (``parallel/colsharded``, the sketch's columns split
over ranks) passes the sum over the shards, and each contraction over the
sharded axis (the Gram, S y, y^T y, the norms) sums its partials, so the
shrink runs on every rank alike.

The randomized shrinks take an optional ``probe`` (m2, r) tensor.  Without
it the probe is drawn from a ``torch.Generator`` seeded 7 on the tensor's
device, the counterpart of the JAX package's fixed ``jax.random.key(7)``
(the two generators give different numbers; tests inject one draw into
both).  Products the JAX package marks ``Precision.HIGHEST`` are plain fp32
matmuls here: the engine turns TF32 off, so they run in true fp32.

``shrink_fast``'s health verdict is read on the host once per shrink (the
JAX package's ``lax.cond``), so the fallback's eigh runs only when taken;
``fast_shrinks`` / ``fallback_shrinks`` count the branches taken.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mused_tpu_torch.ops.kernels import cand_matvec as cm

PROBE_SEED = 7
fast_shrinks = 0        # shrink_fast calls that kept the Newton-Schulz basis
fallback_shrinks = 0    # shrink_fast calls routed to the exact eigh shrink


def _local(x: torch.Tensor) -> torch.Tensor:
    return x


class FDState(NamedTuple):
    """Frequent-Directions sketch state."""

    sketch: torch.Tensor        # (ell, d) float32 — current sketch B
    sq_frobenius: torch.Tensor  # () float32 — running ||A||_F^2 of absorbed rows
    shrink_loss: torch.Tensor   # () float32 — sum of shrink deltas
    count: torch.Tensor         # () int32 — rows absorbed

    @property
    def ell(self) -> int:
        return self.sketch.shape[0]

    @property
    def d(self) -> int:
        return self.sketch.shape[1]


def init(ell: int, d: int, device, dtype=torch.float32) -> FDState:
    """Fresh empty sketch of ``ell`` rows over ``d`` columns on ``device``."""
    return FDState(
        sketch=torch.zeros((ell, d), dtype=dtype, device=device),
        sq_frobenius=torch.zeros((), dtype=dtype, device=device),
        shrink_loss=torch.zeros((), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def default_probe(m2: int, r: int, device) -> torch.Tensor:
    """The fixed (m2, r) standard-normal probe of the randomized shrinks."""
    gen = torch.Generator(device=device)
    gen.manual_seed(PROBE_SEED)
    return torch.randn((m2, r), generator=gen, device=device, dtype=torch.float32)


def _eigh(gram: torch.Tensor):
    """``torch.linalg.eigh``, retried in float64 where the float32 solver
    does not converge (CPU LAPACK on some rank-deficient Grams, e.g. a
    sliding-window query's stack of mostly empty ring slots)."""
    try:
        return torch.linalg.eigh(gram)
    except torch.linalg.LinAlgError:
        lam, u = torch.linalg.eigh(gram.double())
        return lam.to(gram.dtype), u.to(gram.dtype)


def shrink(stacked: torch.Tensor, ell: int, *, eps: float = 1e-30, allreduce=_local):
    """Exact FD shrink of an (m, d) stack to ``ell`` rows -> (B', delta).

    A stack with m <= ell rows passes through unchanged."""
    m = stacked.shape[0]
    if m <= ell:
        return stacked, torch.zeros((), dtype=stacked.dtype, device=stacked.device)
    gram = allreduce(stacked @ stacked.T)
    lam, u = _eigh(gram)                          # ascending
    lam = torch.clamp(lam.flip(0), min=0.0)       # descending, clamped
    u = u.flip(1)
    delta = lam[ell]                              # (ell+1)-th squared singular value
    scale = torch.sqrt(torch.clamp(lam - delta, min=0.0) / torch.clamp(lam, min=eps))
    shrunk = (u.T * scale[:, None]) @ stacked     # rows >= ell are zero
    return shrunk[:ell].to(stacked.dtype), delta.to(stacked.dtype)


def _ns_inv_sqrt(z: torch.Tensor, iters: int = 14, eps: float = 1e-12) -> torch.Tensor:
    """Z^{-1/2} for PSD Z by the coupled Newton-Schulz iteration (matmuls
    only)."""
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    c = torch.trace(z)
    y, w = z / c + eps * eye, eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - w @ y)
        y, w = y @ t, t @ w
    return w / torch.sqrt(c)


def _subspace_basis(stacked: torch.Tensor, ell: int, *, oversample: int, sub_iters: int,
                    probe: torch.Tensor | None = None):
    """(healthy, v): the Newton-Schulz-iterated, Gershgorin-rescaled projection
    basis (m2, ell + oversample) and its health verdict, a () bool tensor
    (orthonormality error < 0.4).  ``probe`` is the (m2, ell + oversample)
    standard-normal start, scaled by 1/sqrt(m2) here."""
    m2 = stacked.shape[0]
    s = stacked.float()
    gram = s @ s.T
    eye = torch.eye(m2, dtype=gram.dtype, device=gram.device)
    g = gram + (1e-5 * torch.trace(gram) / m2) * eye
    # oversampling cannot exceed the row space, or NS never orthonormalizes
    oversample = min(oversample, m2 - ell)
    if probe is None:
        probe = default_probe(m2, ell + oversample, s.device)
    v = probe / torch.sqrt(torch.tensor(float(m2), device=s.device))
    for _ in range(sub_iters):
        y = g @ v
        v = y @ _ns_inv_sqrt(y.T @ y)
    vv = v.T @ v
    orth_err = torch.max(torch.abs(vv - torch.eye(vv.shape[0], dtype=vv.dtype,
                                                  device=vv.device)))
    gersh = torch.max(torch.sum(torch.abs(vv), dim=1))    # lambda_max(V^T V) bound
    v = v / torch.sqrt(torch.clamp(gersh, min=1.0))       # V V^T <= I: no overestimate
    lam = torch.sum(v * (g @ v), dim=0)
    return orth_err < 0.4, v[:, torch.argsort(-lam, stable=True)]


def shrink_fast(stacked: torch.Tensor, ell: int, *, oversample: int = 16,
                sub_iters: int = 4, probe: torch.Tensor | None = None):
    """Matmul-only rank-ell truncation of an (m2, d) stack -> (B', delta):
    Newton-Schulz subspace iteration, with the exact :func:`shrink` for
    stacks whose basis fails the health gate (tie-degenerate or
    rank-deficient spectra).  delta is the exact trace residual
    ||S||_F^2 - ||B'||_F^2, an upper bound on the step's spectral error, so
    summed deltas bound ||A^T A - B^T B||_2 as the classic FD deltas do.
    ``probe``: the (m2, min(ell + oversample, m2)) standard-normal start."""
    global fast_shrinks, fallback_shrinks
    if stacked.shape[0] <= ell:
        return stacked, torch.zeros((), dtype=stacked.dtype, device=stacked.device)
    healthy, v = _subspace_basis(stacked, ell, oversample=oversample, sub_iters=sub_iters,
                                 probe=probe)
    if not bool(healthy):                                 # one host read per shrink
        fallback_shrinks += 1
        return shrink(stacked, ell)
    fast_shrinks += 1
    s = stacked.float()
    b = v[:, :ell].T @ s
    delta = torch.clamp(torch.sum(s * s) - torch.sum(b * b), min=0.0)
    return b.to(stacked.dtype), delta.to(stacked.dtype)


def _check_power_iters(power_iters: int) -> None:
    if power_iters < 1:
        raise ValueError(
            "power_iters must be >= 1: the never-overestimate guarantee "
            "comes from the final iteration's orthonormal Q (Q Q^T <= I)")


def _rr_finish(y: torch.Tensor, ell: int, sq_total: torch.Tensor, allreduce=_local):
    """Rayleigh-Ritz tail shared by the rr shrinks: y = S^T Q (d, r)."""
    h = allreduce(y.T @ y)                        # == Q^T G Q
    h = 0.5 * (h + h.T)
    _, p = torch.linalg.eigh(h)                   # ascending
    b = p.flip(1)[:, :ell].T @ y.T                # (ell, d)
    delta = torch.clamp(sq_total - allreduce(torch.sum(b * b)), min=0.0)
    return b, delta


def shrink_rr(stacked: torch.Tensor, ell: int, *, oversample: int = 16,
              power_iters: int = 1, probe: torch.Tensor | None = None):
    """Rayleigh-Ritz shrink of an (m2, d) stack -> (B' (ell, d), delta).

    delta is the exact trace residual ||S||_F^2 - ||B'||_F^2, which upper
    bounds the step's spectral error (Q Q^T <= I), so summed deltas bound
    ||A^T A - B^T B||_2 like the classic FD deltas."""
    _check_power_iters(power_iters)
    m2 = stacked.shape[0]
    if m2 <= ell:
        return stacked, torch.zeros((), dtype=stacked.dtype, device=stacked.device)
    r = min(ell + oversample, m2)
    v = default_probe(m2, r, stacked.device) if probe is None else probe
    for _ in range(power_iters):
        # orthonormalize between applications of G = S S^T (no rank collapse)
        v = torch.linalg.qr(stacked @ (stacked.T @ v))[0]
    b, delta = _rr_finish(stacked.T @ v, ell, torch.sum(stacked * stacked))
    return b.to(stacked.dtype), delta.to(stacked.dtype)


def shrink_rr_pair(sketch: torch.Tensor, rows: torch.Tensor, ell: int, *,
                   oversample: int = 16, power_iters: int = 1,
                   probe: torch.Tensor | None = None, allreduce=_local):
    """shrink_rr on the implicit stack [sketch; rows]; the operands are never
    concatenated and ``rows`` may arrive in a narrower dtype."""
    _check_power_iters(power_iters)
    ellr = sketch.shape[0]
    m2 = ellr + rows.shape[0]
    r = min(ell + oversample, m2)
    rows_f = rows.float()

    def st(v):      # S^T v: (d, r)
        return sketch.T @ v[:ellr] + rows_f.T @ v[ellr:]

    def s(y):       # S y: (m2, r)
        return allreduce(torch.cat([sketch @ y, rows_f @ y], dim=0))

    v = default_probe(m2, r, sketch.device) if probe is None else probe
    for _ in range(power_iters):
        v = torch.linalg.qr(s(st(v)))[0]
    sq = allreduce(torch.sum(sketch * sketch) + torch.sum(rows_f * rows_f))
    b, delta = _rr_finish(st(v), ell, sq, allreduce)
    return b.to(sketch.dtype), delta.to(sketch.dtype)


def shrink_rr_cands(sketch: torch.Tensor, cand, ell: int, *, oversample: int = 16,
                    power_iters: int = 1, probe: torch.Tensor | None = None,
                    allreduce=_local):
    """shrink_rr_pair where the rows are a candidate-form block
    (``ops/kernels/cand_matvec.CandBlock``): every product with the rows
    runs off the int8 slabs (K4 / K5, gathers over the block's candidate
    lists, built once here on the card), the dense (block, n) block never
    exists.  Returns (B' (ell, d), delta, edges), edges the exact fused edge
    count (== ||rows||_F^2).

    Precisions follow the JAX package: the power products only pick the
    probe direction, so their row operands are bf16; the bound-carrying
    y = S^T Q splits the rows' operand into bf16 [hi | lo] halves (one K4
    launch, summed after), about 16 mantissa bits; the sketch's products
    are fp32.  K4 and K5 take the live r (2r for [hi | lo]); the JAX
    package pads them to its 128 lanes, which changes no value.  A block
    with no kept candidate and no valid uid row is an exact FD no-op and
    skips everything (one host sync per block; a column shard's slabs may be
    empty while the block has edges on another shard, so the test is summed
    too, and every rank takes the same branch)."""
    _check_power_iters(power_iters)
    nonzero = torch.any(cand.slabs != -1)
    if cand.uid_rows is not None:
        nonzero = nonzero | torch.any(cand.uid_rows >= 0)
    zero = torch.zeros((), dtype=torch.float32, device=sketch.device)
    if not bool(allreduce(nonzero.to(torch.int32)) > 0):
        return sketch, zero, zero
    cand = cm.with_lists(cand)           # the three products share one list build
    ellr = sketch.shape[0]
    m2 = ellr + cand.block
    r = min(ell + oversample, m2)

    def at_rows(v_r):                # probe-precision rows^T v_r: (m, r) -> (d, r)
        out_t, _ = cm.matvec_t(cand, v_r.T.to(torch.bfloat16).contiguous())
        return out_t.T

    def a_rows(y):                   # probe-precision rows @ y: (d, r) -> (m, r)
        return allreduce(cm.matvec(cand, y.to(torch.bfloat16).contiguous()))

    v = default_probe(m2, r, sketch.device) if probe is None else probe
    for _ in range(power_iters):
        y0 = sketch.T @ v[:ellr] + at_rows(v[ellr:])
        v = torch.linalg.qr(torch.cat([allreduce(sketch @ y0), a_rows(y0)], dim=0))[0]
    v_r = v[ellr:]
    v_hi = v_r.to(torch.bfloat16)
    v_lo = (v_r - v_hi.float()).to(torch.bfloat16)
    x_t = torch.cat([v_hi.T, v_lo.T], dim=0).contiguous()               # (2r, m)
    out_t, edges = cm.matvec_t(cand, x_t)
    edges = allreduce(edges)
    y = sketch.T @ v[:ellr] + (out_t[:r] + out_t[r:]).T                 # (d, r)
    b, delta = _rr_finish(y, ell, allreduce(torch.sum(sketch * sketch)) + edges, allreduce)
    return b.to(sketch.dtype), delta.float(), edges.float()


MODES = ("eigh", "subspace", "subspace_ns", "rr")


def resolve_fold_mode(mode: str) -> str:
    """Shrink mode for fold-scale consumers (the engine's whole-window
    summary sketch, the huge-window folds): "subspace" routes to the
    Rayleigh-Ritz shrink there; "subspace_ns" forces the Newton-Schulz
    shrink; "eigh" / "rr" pass through."""
    if mode not in MODES:
        raise ValueError(f"unknown fd shrink mode {mode!r}: expected one of {sorted(MODES)}")
    return "rr" if mode == "subspace" else mode


def update_block(state: FDState, rows: torch.Tensor, valid: torch.Tensor | None = None,
                 mode: str = "eigh", probe: torch.Tensor | None = None,
                 allreduce=_local) -> FDState:
    """Absorb a block of rows (c, d); ``valid`` (c,) bool zeroes padding rows.
    ``mode``: "eigh" (:func:`shrink`), "subspace" / "subspace_ns"
    (:func:`shrink_fast`) or "rr" (:func:`shrink_rr_pair`).

    An all-zero block is an exact no-op and skips the shrink (one host
    sync on the block's nonzero test)."""
    if mode not in MODES:
        raise ValueError(f"unknown fd shrink mode {mode!r}: expected one of {sorted(MODES)}")
    if mode != "rr":
        rows = rows.to(state.sketch.dtype)
    if valid is not None:
        rows = torch.where(valid[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
        n_new = torch.sum(valid.to(torch.int32))
    else:
        n_new = torch.tensor(rows.shape[0], dtype=torch.int32, device=rows.device)
    if bool(allreduce(torch.any(rows != 0).to(torch.int32)) > 0):
        if mode == "rr":
            sketch, delta = shrink_rr_pair(state.sketch, rows, state.ell, probe=probe,
                                           allreduce=allreduce)
        elif mode != "eigh":
            sketch, delta = shrink_fast(torch.cat([state.sketch, rows], dim=0),
                                        state.ell, probe=probe)
        else:
            sketch, delta = shrink(torch.cat([state.sketch, rows], dim=0), state.ell,
                                   allreduce=allreduce)
    else:
        sketch, delta = state.sketch, torch.zeros_like(state.shrink_loss)
    return FDState(
        sketch=sketch,
        sq_frobenius=state.sq_frobenius + allreduce(torch.sum(rows.float() ** 2)).to(
            state.sq_frobenius.dtype),
        shrink_loss=state.shrink_loss + delta,
        count=state.count + n_new,
    )


def update_stream(state: FDState, rows: torch.Tensor, *, block_rows: int | None = None,
                  mode: str = "eigh", probe: torch.Tensor | None = None,
                  allreduce=_local) -> FDState:
    """Absorb (m, d) rows in blocks of ``block_rows`` (zero-padded tail).

    Default block: ell for eigh (its cost grows with the stack); for rr the
    biggest block available, up to 4096, so a window's Gram-free products
    run once; for the Newton-Schulz modes up to 16 ell (at most 1024), whose
    fixed-size products then run fewer truncations."""
    m, d = rows.shape
    ell = state.ell
    if block_rows:
        block = block_rows
    elif mode == "eigh":
        block = ell
    elif mode == "rr":
        block = max(ell, min(m, 4096))
    else:
        block = max(ell, min(m, 16 * ell, 1024))
    n_blocks = -(-m // block)
    pad = n_blocks * block - m
    if pad:
        rows = torch.cat([rows, torch.zeros((pad, d), dtype=rows.dtype,
                                            device=rows.device)], dim=0)
    idx = torch.arange(n_blocks * block, device=rows.device).reshape(n_blocks, block)
    for i in range(n_blocks):
        state = update_block(state, rows[i * block:(i + 1) * block], idx[i] < m,
                             mode=mode, probe=probe, allreduce=allreduce)
    return state


def fold_sketch(rows: torch.Tensor, *, ell: int, mode: str = "eigh",
                probe: torch.Tensor | None = None):
    """One-shot FD sketch of (m, d) rows -> (sketch (ell, d), sq_frobenius,
    shrink_loss)."""
    st = update_stream(init(ell, rows.shape[1], rows.device), rows, mode=mode,
                       probe=probe)
    return st.sketch, st.sq_frobenius, st.shrink_loss


def error_bound(state: FDState) -> torch.Tensor:
    """Current upper bound on ||A^T A - B^T B||_2 (the tighter of the two)."""
    return torch.minimum(state.shrink_loss, state.sq_frobenius / state.ell)


def covariance_error(a: torch.Tensor, sketch: torch.Tensor) -> torch.Tensor:
    """Exact ||A^T A - B^T B||_2 (test-size inputs only)."""
    return torch.linalg.matrix_norm(a.T @ a - sketch.T @ sketch, ord=2)
