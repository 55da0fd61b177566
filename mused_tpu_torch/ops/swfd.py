"""Sliding-window Frequent Directions (SWFD) — port of ``mused_tpu/ops/swfd.py``.

The stream is cut into blocks; each sealed block's (ell, d) sketch sits in a
ring of ``num_slots`` slots with its end row index.  A query stacks the
sketches of every live block (end > count - window) plus the active sketch
and shrinks the stack to ``sketch_dim`` rows (dead slots contribute zero
rows, an FD no-op).  The engine seals one whole-window fold per window
(:func:`absorb_summary`), so for tumbling windows the live blocks tile the
window exactly and only FD shrink error remains.

Slice 1 ports the state, ``init``, ``absorb_summary`` and ``query``.  The
row-granular ``update`` / ``_seal`` and the ``SeqBasedSWFD`` drop-in belong
to slice 2.  The ring counters (``count``, ``seal_cursor``) are host ints:
the host picks the slot, and no device sync is needed to do it.
"""
from __future__ import annotations

from typing import NamedTuple

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
                     seal_cursor=state.seal_cursor + 1)


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
