"""Blocked DBSCAN: density clustering beyond the dense (n, n) cap — port of
``mused_tpu/ops/blocked_dbscan.py``.

The dense DBSCAN (``ops/dbscan``) materializes the (n, n) eps-graph, which
is fine to about 32k rows.  This variant rebuilds (block, n) distance blocks
inside host loops over row blocks instead (the trade of
``ops/blocked_affinity``):

  1. degree sweep -> core mask (one n^2 / block sweep);
  2. min-label propagation over the core-core eps-graph, one sweep per
     round, each followed by three pointer jumps (labels <- labels[labels])
     on core rows, so the rounds grow with log(diameter), not the diameter;
  3. border sweep -> the minimum-labelled core neighbour's root within eps.

The labels equal the dense DBSCAN's: the same definition, the same unique
fixed point and the same first-occurrence compaction.  eps is squared in
float32 and distances use the expanded-norm form, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from mused_tpu_torch.ops.dbscan import _as_points, _eps2, _first_occurrence_compaction
from mused_tpu_torch.ops.kmeans import _sq_dists


def _pad_rows(x: torch.Tensor, block: int) -> torch.Tensor:
    """Pad rows to a block multiple with far-away points.  Padding must be
    float32-safe: inf coordinates would make the expanded-norm distances NaN
    (inf - inf); 1e15 keeps d2 near 1e30, finite and never within eps."""
    pad = (-x.shape[0]) % block
    if pad:
        x = torch.cat([x, torch.full((pad, x.shape[1]), 1e15, dtype=x.dtype,
                                     device=x.device)])
    return x


def _degree_sweep(x: torch.Tensor, eps2: float, *, block: int) -> torch.Tensor:
    """(n,) count of points within eps of each row (self included)."""
    deg = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], block):
        deg[s:s + block] = torch.sum(_sq_dists(x[s:s + block], x) <= eps2, dim=1)
    return deg


def _propagate_once(x: torch.Tensor, labels: torch.Tensor, core: torch.Tensor,
                    eps2: float, *, block: int):
    """One blocked min-label sweep over core-core edges + pointer jumping.
    Returns (labels, changed () bool tensor)."""
    n = x.shape[0]
    mins = torch.empty_like(labels)
    for s in range(0, n, block):
        edge = (_sq_dists(x[s:s + block], x) <= eps2) & core[s:s + block, None] \
            & core[None, :]
        mins[s:s + block] = torch.amin(torch.where(edge, labels[None, :], n), dim=1)
    new = torch.minimum(labels, mins)
    # labels are root row indices, so composing the map halves path lengths
    # per hop; only core rows jump (the "no label" sentinel n would clamp to
    # row n - 1 and keep non-core rows changing after the core converged)
    is_core_label = new < n
    for _ in range(3):
        jumped = torch.minimum(new, new[torch.clamp(new, 0, n - 1)])
        new = torch.where(is_core_label, jumped, new)
    return new, torch.any((new != labels) & is_core_label)


def _border_sweep(x: torch.Tensor, labels: torch.Tensor, core: torch.Tensor, eps2: float,
                  *, block: int) -> torch.Tensor:
    """(n,) the minimum label among each row's core neighbours (n if none)."""
    n = x.shape[0]
    mins = torch.empty_like(labels)
    for s in range(0, n, block):
        edge = (_sq_dists(x[s:s + block], x) <= eps2) & core[None, :]
        mins[s:s + block] = torch.amin(torch.where(edge, labels[None, :], n), dim=1)
    return mins


def dbscan_blocked(data, eps: float = 0.5, min_samples: int = 5, block: int = 2048,
                   max_rounds: int = 64, *, device="cuda") -> np.ndarray:
    """DBSCAN labels (int32, noise -1) of (n, d) points at any n, on
    ``device`` (a tensor's own device when ``data`` is one).  A host loop
    runs propagation rounds (one sweep each plus pointer jumps) until no
    core label changes, or ``max_rounds``."""
    x = _as_points(data, device)
    n = x.shape[0]
    if n == 0:
        return np.empty(0, np.int32)
    block = min(block, n)
    xp = _pad_rows(x, block)
    np_ = xp.shape[0]
    eps2 = _eps2(eps)

    deg = _degree_sweep(xp, eps2, block=block)
    core = (deg >= int(min_samples)) & (torch.arange(np_, device=x.device) < n)
    labels = torch.where(core, torch.arange(np_, device=x.device), np_)
    for _ in range(max_rounds):
        labels, changed = _propagate_once(xp, labels, core, eps2, block=block)
        if not bool(changed):
            break

    border_min = _border_sweep(xp, labels, core, eps2, block=block)
    is_border = ~core & (border_min < np_)
    roots = torch.where(core, labels, torch.where(is_border, border_min, 0))
    return _first_occurrence_compaction(roots, core | is_border).cpu().numpy()[:n]
