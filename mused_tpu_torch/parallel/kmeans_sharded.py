"""Row-sharded k-means: Lloyd iterations over the mesh's "data" axis — port
of ``mused_tpu/parallel/kmeans_sharded.py``.

Each rank owns a contiguous share of the points; per iteration it assigns
its rows locally and contributes the counts and the ``onehot.T @ x`` sums of
its share to an all-reduce, so the centroids stay replicated (k_max × d,
tiny).  The semantics are ``ops/kmeans.kmeans``'s (dead centres at +inf,
the shift tolerance, the empty-cluster relocation, the loop that reads the
device every ``kmeans.CHECK_EVERY`` steps), so one rank and p ranks agree
up to the all-reduce's summation order.

k-means++ seeding runs replicated on the replicated points, outside the
sharded loop: every rank draws the same centres from the caller's generator
(seeded alike on every rank), or takes the injected ``init``.  The
relocation of an empty live cluster gathers each rank's worst-fit rows in
rank order and takes the global worst fits, lowest index first among ties
(a stable descending sort, never ``torch.topk``).
"""
from __future__ import annotations

import torch

from mused_tpu_torch.ops import kmeans as km
from mused_tpu_torch.parallel.mesh import Axis


def _worst_fits(dist_own: torch.Tensor, count: int):
    """(values, indices) of the ``count`` largest entries, lowest index first
    among ties."""
    order = torch.sort(dist_own, descending=True, stable=True)[1][:count]
    return dist_own[order], order


def kmeans_sharded(x: torch.Tensor, k, generator: torch.Generator | None = None, *,
                   k_max: int, mesh, max_iters: int = 100, tol: float = 1e-4,
                   init: torch.Tensor | None = None):
    """Lloyd k-means of the replicated (n, d) points, rows sharded over the
    mesh's "data" axis (n divisible by its size).  Returns (labels (n,),
    centroids (k_max, d)), the same on every rank."""
    axis = Axis(mesh, "data")
    x = x.float()
    alive = torch.arange(k_max, device=x.device) < k      # k: int or device tensor
    c = km.kmeanspp_init(x, k_max, k, generator) if init is None else init.float()
    x_s = x[axis.share(x.shape[0])]
    m, d = x_s.shape
    arange_k = torch.arange(k_max, device=x.device)
    xn = torch.sum(x_s * x_s, dim=1)

    def assign(cent):
        return torch.argmin(
            torch.where(alive[None, :], km._sq_dists(x_s, cent, xn), torch.inf), dim=1)

    def step(c):
        labels = assign(c)
        onehot = (labels[:, None] == arange_k[None, :]).float()
        counts = axis.psum(torch.sum(onehot, dim=0))
        sums = axis.psum(onehot.T @ x_s)
        new_c = torch.where((counts > 0)[:, None],
                            sums / torch.clamp(counts, min=1.0)[:, None], c)
        # the relocation runs every step (its gathers on every rank) and is
        # selected only where a cluster is empty: the same on every rank,
        # since the counts are summed
        empty = alive & (counts == 0)
        dist_own = torch.gather(km._sq_dists(x_s, new_c, xn), 1, labels[:, None])[:, 0]
        vals, idx = _worst_fits(dist_own, min(k_max, m))
        cand_x = axis.all_gather(x_s[idx]).reshape(-1, d)
        cand_v = axis.all_gather(vals).reshape(-1)
        k_eff = min(k_max, cand_v.shape[0])
        _, gidx = _worst_fits(cand_v, k_eff)
        slot = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0, k_eff - 1)
        new_c = torch.where(empty[:, None], cand_x[gidx[slot]], new_c)
        return new_c, torch.sum((new_c - c) ** 2)

    c = km.lloyd_loop(c, step, max_iters, tol)
    return axis.all_gather(assign(c)).reshape(-1), c
