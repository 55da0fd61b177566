"""Cross-window cluster matching: the port's copy of ``mused_tpu/ops/matching.py``.

Copied, not imported (the port runs where the JAX package is absent), with
the original's code and names: ``overlap_cost_matrix``, ``is_feasible``,
``sinkhorn`` and ``match_clusters`` (``CentroidMatcher`` is not copied: the
port's centroid matching is still to come and raises).  The original's note:

Hungarian assignment + Sinkhorn OT.  Reproduces reference
matrix_operations.py:155-233 — overlap cost matrix (-overlap where overlap
>= min_overlap else +inf), feasibility screen, then either scipy Hungarian
assignment or a Sinkhorn transport plan thresholded at half its maximum.
The cost matrices are tiny (<= unique labels squared), so both matchers run
on the host exactly like the reference: scipy Hungarian, and a numpy
Sinkhorn.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def overlap_cost_matrix(prev: np.ndarray, new: np.ndarray, min_overlap: int):
    """(-overlap | inf) cost over unique label pairs (ref :159-172).

    The pairwise overlap counts are a single confusion-matrix contraction
    instead of the reference's P*Q boolean scans.
    """
    uniq_prev, prev_idx = np.unique(prev, return_inverse=True)
    uniq_new, new_idx = np.unique(new, return_inverse=True)
    conf = np.zeros((len(uniq_prev), len(uniq_new)), np.int64)
    np.add.at(conf, (prev_idx, new_idx), 1)
    cost = np.where(conf >= min_overlap, -conf.astype(np.float64), np.inf)
    return cost, uniq_prev, uniq_new


def is_feasible(cost: np.ndarray) -> bool:
    """Reference feasibility screen (ref :226-233)."""
    if np.all(np.isinf(cost)):
        return False
    if np.any(np.all(np.isinf(cost), axis=1)):
        return False
    if np.any(np.all(np.isinf(cost), axis=0)):
        return False
    return True


def sinkhorn(a, b, cost, reg: float = 0.1, n_iters: int = 200):
    """Entropy-regularized OT plan (POT ``ot.sinkhorn`` equivalent, ref :198).

    a: (p,) row marginals, b: (q,) col marginals, cost: (p, q) in [0, 1].
    Host numpy (review r5): the only consumer is the host-side matcher on
    a <= uniques^2 matrix, and the jitted version recompiled for every
    distinct (p, q) — window-varying cluster counts turned microseconds
    of scaling into a fresh remote compile per shape.  200 row/col
    rescalings of a tiny matrix cost nothing on the host.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    kmat = np.exp(-np.asarray(cost, np.float64) / reg)
    u = np.ones(kmat.shape[0])
    v = np.ones(kmat.shape[1])
    for _ in range(n_iters):
        u = a / np.maximum(kmat @ v, 1e-30)
        v = b / np.maximum(kmat.T @ u, 1e-30)
    return u[:, None] * kmat * v[None, :]


def match_clusters(prev_clusters, new_clusters, method: str = "hungarian",
                   min_overlap: int = 5,
                   sinkhorn_reg: float = 0.1, sinkhorn_iters: int = 200):
    """Remap ``new_clusters`` labels onto the previous window's label space.

    Drop-in equivalent of reference matrix_operations.py:155-224, including:
    infeasible cost matrix -> return new labels unmatched (ref :176-178);
    unmatched new labels keep their own id (``mapping.get(c, c)``, ref :207/221).
    """
    if prev_clusters is None or len(prev_clusters) == 0:
        return new_clusters
    prev = np.asarray(prev_clusters)
    new = np.asarray(new_clusters)
    # the background bucket id (-1, PipelineConfig.background_bucket) is
    # reserved: background positions carry no event identity, so they are
    # excluded from the overlap counts and -1 passes through unchanged
    # (mapping.get(-1, -1) below).  Without the bucket this mask is empty
    # and the path is byte-identical to the reference semantics.
    bg = (prev == -1) | (new == -1)
    if bg.all():
        return new
    cost, uniq_prev, uniq_new = overlap_cost_matrix(prev[~bg], new[~bg],
                                                    min_overlap)
    if not is_feasible(cost):
        return new

    if method == "hungarian":
        try:
            row_ind, col_ind = linear_sum_assignment(cost)
        except ValueError:
            # fully infeasible assignment despite the screen — reference would
            # crash here; we fall back to unmatched labels (documented deviation)
            return new
        pairs = [(r, c) for r, c in zip(row_ind, col_ind) if np.isfinite(cost[r, c])]
    elif method == "pot":
        c = cost.copy()
        c[np.isinf(c)] = 1e9                     # ref :188
        c = np.abs(c)
        c /= np.max(c)                           # ref :191-192
        p, q = c.shape
        plan = sinkhorn(np.full(p, 1.0 / p), np.full(q, 1.0 / q), c,
                        reg=sinkhorn_reg, n_iters=sinkhorn_iters)
        rows, cols = np.where(plan > plan.max() * 0.5)   # ref :201
        pairs = list(zip(rows, cols))
    else:
        raise ValueError("Invalid method. Choose 'hungarian' or 'pot'.")

    mapping = {uniq_new[c]: uniq_prev[r] for r, c in pairs}
    return np.array([mapping.get(c, c) for c in new])

