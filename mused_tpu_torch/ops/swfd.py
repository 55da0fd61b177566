"""Sliding-window Frequent Directions (SWFD) — port of ``mused_tpu/ops/swfd.py``.

The stream is cut into blocks; each sealed block's (ell, d) sketch sits in a
ring of ``num_slots`` slots with its end row index.  A query stacks the
sketches of every live block (end > count - window) plus the active sketch
and shrinks the stack to ``sketch_dim`` rows (dead slots contribute zero
rows, an FD no-op).  The engine seals one whole-window fold per window
(:func:`absorb_summary`), so for tumbling windows the live blocks tile the
window exactly and only FD shrink error remains.

Row-granular streaming (:func:`update`) absorbs rows into the open block's
FD sketch in chunks and seals it into the ring once it holds
``block_rows`` rows; :class:`SeqBasedSWFD` is the reference submodule's
drop-in (``SeqBasedSWFD(N, R, d, sketch_dim)``, ``.fit(row)``, ``.get()``;
reference main.py:60-76).  The ring counters (``count``, ``seal_cursor``)
and the open block's row count (``active_rows``, the host mirror of
``active.count``) are host ints: the host picks the slot and decides each
seal from the valid counts it already knows, with no device read.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mused_tpu_torch.ops import fd


class SWFDState(NamedTuple):
    """Sliding-window FD sketch state."""

    blocks: torch.Tensor       # (num_slots, ell, d) sealed per-block sketches
    block_end: torch.Tensor    # (num_slots,) int32 — row index one past block end; -1 empty
    block_sqfro: torch.Tensor  # (num_slots,) float32 — ||block rows||_F^2
    block_loss: torch.Tensor   # (num_slots,) float32 — shrink deltas of each block
    active: fd.FDState         # FD sketch of the open block
    count: int                 # rows seen so far
    seal_cursor: int           # next ring slot to overwrite
    active_rows: int = 0       # rows in the open block (== active.count)

    @property
    def ell(self) -> int:
        return self.blocks.shape[1]

    @property
    def d(self) -> int:
        return self.blocks.shape[2]

    @property
    def num_slots(self) -> int:
        return self.blocks.shape[0]


def choose_block_rows(window: int, ell: int, target_blocks: int = 8) -> int:
    """Smallest divisor of ``window`` at or above window / target_blocks."""
    if window <= target_blocks:
        return 1
    want = max(1, window // target_blocks)
    return next(b for b in range(want, window + 1) if window % b == 0)


def init(window: int, d: int, ell: int, *, device, block_rows: int | None = None,
         dtype=torch.float32) -> SWFDState:
    block_rows = block_rows or choose_block_rows(window, ell)
    num_slots = -(-window // block_rows) + 1   # the window plus one expiring block
    return SWFDState(
        blocks=torch.zeros((num_slots, ell, d), dtype=dtype, device=device),
        block_end=torch.full((num_slots,), -1, dtype=torch.int32, device=device),
        block_sqfro=torch.zeros((num_slots,), dtype=dtype, device=device),
        block_loss=torch.zeros((num_slots,), dtype=dtype, device=device),
        active=fd.init(ell, d, device, dtype),
        count=0,
        seal_cursor=0,
    )


def _seal(state: SWFDState) -> SWFDState:
    """Move the open block's sketch into the ring and reset the open FD."""
    slot = state.seal_cursor % state.num_slots
    blocks = state.blocks.clone()
    blocks[slot] = state.active.sketch
    block_end = state.block_end.clone()
    block_end[slot] = state.count
    block_sqfro = state.block_sqfro.clone()
    block_sqfro[slot] = state.active.sq_frobenius
    block_loss = state.block_loss.clone()
    block_loss[slot] = state.active.shrink_loss
    return SWFDState(blocks=blocks, block_end=block_end, block_sqfro=block_sqfro,
                     block_loss=block_loss,
                     active=fd.init(state.ell, state.d, state.blocks.device,
                                    state.blocks.dtype),
                     count=state.count, seal_cursor=state.seal_cursor + 1, active_rows=0)


def fd_chunk(block_rows: int, ell: int) -> int:
    """FD chunk of :func:`update`: the largest divisor of ``block_rows`` that
    is <= ell, so block boundaries land on chunk boundaries."""
    if block_rows <= ell:
        return block_rows
    return max(c for c in range(1, ell + 1) if block_rows % c == 0)


def update(state: SWFDState, rows: torch.Tensor, *, window: int, block_rows: int,
           n_valid: int | None = None) -> SWFDState:
    """Absorb (m, d) stream rows chunk by chunk into the open block; the open
    block persists across calls.  ``window`` is accepted for symmetry with
    :func:`query` (expiry happens at query time).  ``n_valid``: only the
    first n_valid rows are real (a caller padding to a fixed shape).

    A seal happens at the first chunk boundary at or past ``block_rows``
    rows, so blocks are exactly block_rows when every call's m is a multiple
    of the chunk (:func:`fd_chunk`), and up to chunk-1 rows larger
    otherwise; :class:`SeqBasedSWFD` feeds whole chunks."""
    del window
    m, d = rows.shape
    chunk = fd_chunk(block_rows, state.ell)
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, d))], dim=0)
    nv = m if n_valid is None else int(n_valid)
    idx = torch.arange(chunk, device=rows.device)
    for i in range(n_chunks):
        valid_c = min(max(nv - i * chunk, 0), chunk)     # host count of real rows
        active = fd.update_block(state.active, rows[i * chunk:(i + 1) * chunk],
                                 idx < valid_c)
        state = state._replace(active=active, count=state.count + valid_c,
                               active_rows=state.active_rows + valid_c)
        if state.active_rows >= block_rows:
            state = _seal(state)
    return state


def absorb_summary(state: SWFDState, sketch: torch.Tensor, n_rows: int,
                   sq_fro: torch.Tensor, loss: torch.Tensor | float = 0.0) -> SWFDState:
    """Seal a pre-sketched block of ``n_rows`` rows (e.g. one window folded
    by ``fd.fold_sketch``) into the ring as one block.  Returns a new state;
    the input state's tensors are left unchanged."""
    count = state.count + int(n_rows)
    slot = state.seal_cursor % state.num_slots
    blocks = state.blocks.clone()
    blocks[slot] = sketch.to(blocks.dtype)
    block_end = state.block_end.clone()
    block_end[slot] = count
    block_sqfro = state.block_sqfro.clone()
    block_sqfro[slot] = sq_fro
    block_loss = state.block_loss.clone()
    block_loss[slot] = loss
    return SWFDState(blocks=blocks, block_end=block_end, block_sqfro=block_sqfro,
                     block_loss=block_loss, active=state.active, count=count,
                     seal_cursor=state.seal_cursor + 1, active_rows=state.active_rows)


def query(state: SWFDState, *, window: int, sketch_dim: int):
    """Sketch of (approximately) the last ``window`` rows.

    Returns ``(sketch (sketch_dim, d), err_bound, sq_frobenius_live,
    n_live_rows)`` like the reference submodule's ``.get()``."""
    live = (state.block_end > state.count - window) & (state.block_end >= 0)
    masked = torch.where(live[:, None, None], state.blocks, 0.0)
    stacked = torch.cat([masked.reshape(-1, state.d), state.active.sketch], dim=0)
    sketch, delta = fd.shrink(stacked, sketch_dim)
    sq_fro = torch.sum(torch.where(live, state.block_sqfro, 0.0)) + state.active.sq_frobenius
    loss = torch.sum(torch.where(live, state.block_loss, 0.0)) + state.active.shrink_loss
    err = delta + torch.minimum(loss, sq_fro / state.ell)
    return sketch, err, sq_fro, min(state.count, window)


class SeqBasedSWFD:
    """Host-facing wrapper with the reference submodule's API:
    ``SeqBasedSWFD(N, R, d, sketch_dim)``, ``.fit(rows)``, ``.get()``
    (reference main.py:60-76), on ``device`` (the card unless the caller
    passes ``device="cpu"``).  ``R`` (the largest squared row norm) is kept
    for the signature only: the ring is sized by ``N`` and the error comes
    from the exact per-block shrink losses.

    ``fit`` takes one row or an (m, d) block; rows are buffered on the host
    up to whole FD chunks, so seals land exactly every ``block_rows`` rows.
    ``get`` absorbs the remainder into a copy of the state (one chunk,
    zero-padded) and returns ``(sketch (sketch_dim, d), err, sq_frobenius,
    n_live_rows)``.  ``headroom``: the internal rank is sketch_dim +
    headroom (None: min(sketch_dim, 8)); ``get`` still shrinks to
    sketch_dim."""

    def __init__(self, N: int, R: float, d: int, sketch_dim: int,
                 block_rows: int | None = None, dtype=torch.float32,
                 headroom: int | None = None, *, device="cuda"):
        self.N = int(N)
        self.R = float(R)
        self.d = int(d)
        self.sketch_dim = int(sketch_dim)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        if headroom is None:
            headroom = min(self.sketch_dim, 8)
        self.ell = self.sketch_dim + int(headroom)
        self.block_rows = block_rows or choose_block_rows(self.N, self.ell)
        self.chunk = fd_chunk(self.block_rows, self.ell)
        self._pending: list = []      # host-side remainder (< chunk rows)
        self._pending_n = 0
        self.state = init(self.N, self.d, self.ell, block_rows=self.block_rows,
                          device=self.device, dtype=dtype)

    def _update(self, state: SWFDState, rows: np.ndarray, n_valid: int | None = None):
        return update(state, torch.from_numpy(rows).to(self.device), window=self.N,
                      block_rows=self.block_rows, n_valid=n_valid)

    def fit(self, rows) -> "SeqBasedSWFD":
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        self._pending.append(rows)
        self._pending_n += rows.shape[0]
        flush = (self._pending_n // self.chunk) * self.chunk
        if flush:
            buf = np.concatenate(self._pending, axis=0)
            self.state = self._update(self.state, np.ascontiguousarray(buf[:flush]))
            rest = buf[flush:]
            self._pending = [rest] if len(rest) else []
            self._pending_n = len(rest)
        return self

    def get(self):
        state = self.state
        if self._pending_n:
            # the remainder goes into a copy, so the persistent block
            # boundaries stay exact; zero rows are FD no-ops
            buf = np.concatenate(self._pending, axis=0)
            padded = np.zeros((self.chunk, buf.shape[1]), np.float32)
            padded[:len(buf)] = buf
            state = self._update(state, padded, n_valid=len(buf))
        return query(state, window=self.N, sketch_dim=self.sketch_dim)
