"""k-means family — port of ``mused_tpu/ops/kmeans.py``.

Replaces sklearn KMeans / MiniBatchKMeans (reference matrix_operations.py:
149-153; main.py:82-85).  The cluster count is dynamic per window (the
reference's unique-ground-truth-label count, main.py:41/97), so centroids
are padded to a static ``k_max`` and dead centres sit at +inf distance.
Lloyd iterates until the centre shift drops below ``tol``; an empty live
cluster moves to the worst-fit point, sklearn's relocation rule.  The loop
reads the device only every ``CHECK_EVERY`` iterations (see
:func:`lloyd_loop`), where the JAX package branches with ``lax.cond`` and
loops with ``lax.while_loop``.

Random draws come from the caller's ``torch.Generator``; ``init`` injects
the starting centroids instead.  ``mark_background`` is the label-free
background bucket over a clustering's residuals.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Lloyd steps between host reads of the convergence flag.  4 ran fastest of
# 4 / 8 / 16 on the H100 (chip_smoke.py phase m1): on the host-bound dense
# path a read costs a short round trip, a frozen step some 40 launches.
CHECK_EVERY = 4


def _sq_dists(x: torch.Tensor, centroids: torch.Tensor,
              xn: torch.Tensor | None = None) -> torch.Tensor:
    """(n, k) squared Euclidean distances via the expanded-norm form
    (``xn``: the rows' squared norms, when the caller keeps them)."""
    xn = torch.sum(x * x, dim=1) if xn is None else xn
    cn = torch.sum(centroids * centroids, dim=1)
    return torch.clamp(xn[:, None] + cn[None, :] - 2.0 * (x @ centroids.T), min=0.0)


def kmeanspp_init(x: torch.Tensor, k_max: int, k, generator: torch.Generator | None):
    """k-means++ seeding of ``k_max`` centres; centres at index >= k are zero.
    The live count is read on the host (a read of the device only when ``k``
    is a device tensor), so only the k - 1 live draws run (the JAX package
    scans all k_max - 1 steps and masks the dead ones; the live centres and
    the zeros are the same).  The draws index the rows on the device."""
    n = x.shape[0]
    live = max(1, min(int(k), k_max))
    first = torch.randint(n, (1,), generator=generator, device=x.device)
    cents = [x[first]]                                   # (1, d) each
    min_d2 = _sq_dists(x, cents[0])[:, 0]
    for _ in range(1, live):
        total = torch.sum(min_d2)
        probs = torch.where(total > 0, min_d2 / torch.clamp(total, min=1e-30),
                            torch.full_like(min_d2, 1.0 / n))
        c = x[torch.multinomial(probs, 1, generator=generator)]
        min_d2 = torch.minimum(min_d2, torch.sum((x - c) ** 2, dim=1))
        cents.append(c)
    out = torch.zeros((k_max, x.shape[1]), dtype=x.dtype, device=x.device)
    out[:live] = torch.cat(cents)
    return out


def lloyd_loop(c: torch.Tensor, step, max_iters: int, tol: float) -> torch.Tensor:
    """Iterate ``c = step(c)`` as ``lax.while_loop`` does while
    ``shift > tol`` and fewer than ``max_iters`` steps ran, with ``step``
    returning (new centres, shift).  Once a step's shift is not above
    ``tol`` the centres freeze (that step's centres kept, as the while loop
    stops right after it) and a device flag records it; the host reads the
    flag every ``CHECK_EVERY`` steps, so the loop runs up to
    ``CHECK_EVERY - 1`` frozen steps and reads the device at most
    ceil(steps / ``CHECK_EVERY``) times."""
    done = torch.zeros((), dtype=torch.bool, device=c.device)
    for it in range(max_iters):
        new_c, shift = step(c)
        c = torch.where(done, c, new_c)
        done = done | ~(shift > tol)
        if (it + 1) % CHECK_EVERY == 0 and it + 1 < max_iters and bool(done):
            break
    return c


def kmeans(x: torch.Tensor, k, generator: torch.Generator | None = None, *,
           k_max: int, max_iters: int = 100, tol: float = 1e-4,
           init: torch.Tensor | None = None):
    """Lloyd k-means on (n, d) points with cluster count ``k <= k_max``
    (int or () tensor).  Returns (labels (n,) int64 in [0, k),
    centroids (k_max, d))."""
    n = x.shape[0]
    x = x.float()
    alive = torch.arange(k_max, device=x.device) < k      # k: int or device tensor
    c = kmeanspp_init(x, k_max, k, generator) if init is None else init.float()
    arange_k = torch.arange(k_max, device=x.device)
    k_eff = min(k_max, n)
    xn = torch.sum(x * x, dim=1)

    def assign(cent):
        return torch.argmin(torch.where(alive[None, :], _sq_dists(x, cent, xn), torch.inf),
                            dim=1)

    def step(c):
        labels = assign(c)
        onehot = (labels[:, None] == arange_k[None, :]).float()
        counts = torch.sum(onehot, dim=0)
        new_c = torch.where((counts > 0)[:, None],
                            (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None], c)
        # the i-th empty live cluster moves to the i-th worst-fit point,
        # computed every step and selected only where a cluster is empty
        empty = alive & (counts == 0)
        dist_own = torch.gather(_sq_dists(x, new_c, xn), 1, labels[:, None])[:, 0]
        far = torch.sort(dist_own, descending=True, stable=True)[1][:k_eff]
        slot = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0, k_eff - 1)
        new_c = torch.where(empty[:, None], x[far[slot]], new_c)
        return new_c, torch.sum((new_c - c) ** 2)

    c = lloyd_loop(c, step, max_iters, tol)
    return assign(c), c


class MiniBatchState(NamedTuple):
    """Streaming MiniBatchKMeans state persisted across windows."""

    centroids: torch.Tensor   # (k, d)
    counts: torch.Tensor      # (k,) float32 — cumulative per-centre mass
    initialized: bool


def minibatch_init(k: int, d: int, device) -> MiniBatchState:
    return MiniBatchState(
        centroids=torch.zeros((k, d), dtype=torch.float32, device=device),
        counts=torch.zeros((k,), dtype=torch.float32, device=device),
        initialized=False)


def minibatch_step(state: MiniBatchState, x: torch.Tensor,
                   generator: torch.Generator | None = None):
    """partial_fit + predict on one window (per-centre rate 1/count).
    Returns (new_state, labels)."""
    k = state.centroids.shape[0]
    x = x.float()
    centroids = (state.centroids if state.initialized
                 else kmeanspp_init(x, k, k, generator))
    labels = torch.argmin(_sq_dists(x, centroids), dim=1)
    onehot = (labels[:, None] == torch.arange(k, device=x.device)[None, :]).float()
    batch_counts = torch.sum(onehot, dim=0)
    new_counts = state.counts + batch_counts
    eta = torch.where(new_counts > 0, batch_counts / torch.clamp(new_counts, min=1.0), 0.0)
    batch_mean = (onehot.T @ x) / torch.clamp(batch_counts, min=1.0)[:, None]
    new_centroids = centroids * (1.0 - eta[:, None]) + batch_mean * eta[:, None]
    new_state = MiniBatchState(new_centroids, new_counts, True)
    # labels re-predicted against the updated centres (.partial_fit().predict())
    return new_state, torch.argmin(_sq_dists(x, new_centroids), dim=1)


def mark_background(x: torch.Tensor, labels: torch.Tensor, *, k_max: int,
                    min_frac: float = 0.02, max_frac: float = 0.5, sep: float = 2.0,
                    min_far: float = 0.3) -> torch.Tensor:
    """Label-free background bucket over a clustering's residuals: rows in
    the far mode of the angular distance-to-cluster-mean distribution are
    re-labelled -1 (no reference analog; see the JAX package's docstring for
    the measurements behind the thresholds).

      * rows are unit-normalized and per-cluster member means recomputed;
      * an Otsu split of the sorted per-row distances (sort + cumsum) picks
        the split maximizing the between-mode variance;
      * the far mode counts only when mean(far) >= ``sep`` x mean(near),
        mean(far) >= ``min_far`` and its fraction is in
        [``min_frac``, ``max_frac``].

    Everything stays on the input's device: no host sync.  Returns int32."""
    n = x.shape[0]
    if n < 2:            # nothing to split
        return labels.to(torch.int32)
    labels = labels.long()
    xf = x.float()
    xn = xf / torch.clamp(torch.linalg.norm(xf, dim=1, keepdim=True), min=1e-12)
    onehot = (labels[:, None] == torch.arange(k_max, device=x.device)[None, :]).float()
    sums = onehot.T @ xn
    counts = torch.sum(onehot, dim=0)
    cents = sums / torch.clamp(counts, min=1.0)[:, None]
    dist = torch.linalg.norm(xn - cents[labels], dim=1)
    ds = torch.sort(dist)[0]
    csum = torch.cumsum(ds, dim=0)
    total = csum[-1]
    idx = torch.arange(1, n, dtype=torch.float32, device=x.device)   # split after idx rows
    m0 = csum[:-1] / idx
    m1 = (total - csum[:-1]) / (n - idx)
    w0 = idx / n
    between = w0 * (1.0 - w0) * (m0 - m1) ** 2
    i_star = torch.argmax(between) + 1                  # near group = ds[:i_star]
    thresh = 0.5 * (ds[i_star - 1] + ds[torch.clamp(i_star, max=n - 1)])
    near_mean = csum[i_star - 1] / i_star
    far_mean = (total - csum[i_star - 1]) / torch.clamp(n - i_star, min=1)
    far_frac = 1.0 - i_star / n
    ok = ((far_mean >= sep * torch.clamp(near_mean, min=1e-12))
          & (far_mean >= min_far) & (far_frac >= min_frac) & (far_frac <= max_frac))
    return torch.where(ok & (dist > thresh), -1, labels).to(torch.int32)
