"""Blocked HDBSCAN: the mutual-reachability MST by Borůvka, beyond the dense
cap — port of ``mused_tpu/ops/blocked_hdbscan.py``.

The host path (``ops/dbscan.hdbscan``) runs Prim over the implicit
mutual-reachability graph in numpy.  Here the graph stays implicit on the
device:

  1. core distances: per row block, the min_samples-th smallest distance
     (one n^2 / block sweep of (block, n) distance blocks);
  2. Borůvka rounds: every component finds its minimum outgoing
     mutual-reachability edge (a blocked sweep taking, per row, the minimum
     over columns of other components, the lowest column on ties as
     ``jnp.argmin`` does: ``torch.argmin`` returns the first minimal index),
     then the components merge through a host union-find; O(log n) rounds;
  3. the MST edges feed the same condensed-tree / excess-of-mass
     extraction as the host path (``ops/dbscan._extract_labels``).

Borůvka gives an MST of the mutual-reachability graph; among equal-weight
edges the choice may differ from Prim's, but the single-linkage heights, and
so the condensed tree, are the same.  The host loops of ``_mst_boruvka``
walk all n rows in Python every round, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from mused_tpu_torch.ops import dbscan as dense
from mused_tpu_torch.ops.blocked_dbscan import _pad_rows
from mused_tpu_torch.ops.kmeans import _sq_dists


def _core_distances(x: torch.Tensor, *, min_samples: int, block: int,
                    n_real: int) -> torch.Tensor:
    """(n,) distance to the min_samples-th nearest neighbour (self counts).
    k clamps to the real row count, so a padding row (at 1e15) is never a
    real row's k-th neighbour."""
    k = min(min_samples, n_real)
    core = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], block):
        kth = torch.topk(_sq_dists(x[s:s + block], x), k, dim=1, largest=False).values
        core[s:s + block] = torch.sqrt(torch.clamp(kth[:, k - 1], min=0.0))
    return core


def _min_outgoing(x: torch.Tensor, core: torch.Tensor, comp: torch.Tensor, *,
                  block: int):
    """Per row: (weight, column) of its minimum mutual-reachability edge to
    any point of another component.  One blocked sweep."""
    n = x.shape[0]
    w_min = torch.empty(n, dtype=torch.float32, device=x.device)
    col = torch.empty(n, dtype=torch.int64, device=x.device)
    for s in range(0, n, block):
        d = torch.sqrt(torch.clamp(_sq_dists(x[s:s + block], x), min=0.0))
        mreach = torch.maximum(torch.maximum(core[s:s + block, None], core[None, :]), d)
        w = torch.where(comp[s:s + block, None] != comp[None, :], mreach, torch.inf)
        c = torch.argmin(w, dim=1)             # the first minimal column on ties
        col[s:s + block] = c
        w_min[s:s + block] = torch.gather(w, 1, c[:, None])[:, 0]
    return w_min, col


def _mst_boruvka(x: torch.Tensor, min_samples: int, block: int) -> list[tuple]:
    """Edges (w, a, b) of an MST of the implicit mutual-reachability graph
    of the (n, d) points ``x`` (on their device)."""
    n = x.shape[0]
    block = min(block, n)
    xp = _pad_rows(x, block)
    pad = xp.shape[0] - n
    core = _core_distances(xp, min_samples=min_samples, block=block, n_real=n)
    # padding rows: infinitely far, each its own component beyond n forever
    parent = np.arange(n + pad)
    pad_comp = torch.arange(n, n + pad, dtype=torch.int64, device=x.device)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    edges = []
    while True:
        comp = np.fromiter((find(i) for i in range(n)), np.int64, n)
        if len(np.unique(comp)) <= 1:
            break
        comp_t = torch.cat([torch.from_numpy(comp).to(x.device), pad_comp])
        w, col = _min_outgoing(xp, core, comp_t, block=block)
        w, col = w[:n].cpu().numpy(), col[:n].cpu().numpy()
        # per component: the minimum outgoing edge among its members' rows
        best: dict[int, tuple] = {}
        for i in range(n):
            c = comp[i]
            if np.isfinite(w[i]) and (c not in best or w[i] < best[c][0]):
                best[c] = (w[i], i, int(col[i]))
        merged = False
        for wgt, a, b in sorted(best.values()):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
                edges.append((float(wgt), a, b))
                merged = True
        if not merged:      # a disconnected graph cannot happen (mreach finite)
            break
    return edges


def hdbscan_blocked(data, min_cluster_size: int = 5, min_samples: int = 2,
                    block: int = 2048, *, device="cuda") -> np.ndarray:
    """HDBSCAN labels at any n on ``device`` (a tensor's own device when
    ``data`` is one): Borůvka MST over the implicit graph, then the host
    path's condensed-tree / eom extraction."""
    x = dense._as_points(data, device)
    n = x.shape[0]
    if n == 0:
        return np.empty(0, np.int64)
    if n == 1:
        return np.array([-1], np.int64)
    edges = sorted(_mst_boruvka(x, min_samples, block))
    return dense._extract_labels(edges, n, min_cluster_size)
