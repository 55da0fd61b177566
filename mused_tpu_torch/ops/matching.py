"""Cross-window cluster matching: the port's copy of ``mused_tpu/ops/matching.py``.

Copied, not imported (the port runs where the JAX package is absent), with
the original's code and names: ``overlap_cost_matrix``, ``is_feasible``,
``sinkhorn``, ``match_clusters`` and ``CentroidMatcher`` (host numpy and
scipy, bit-equal to the original).  The original's note:

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


class CentroidMatcher:
    """Cross-window ID stabilization by nearest-centroid assignment in a
    stable feature space.

    Framework extension with no reference analog: the reference's
    positional-overlap matching (matrix_operations.py:159-172) counts
    same-position label agreements between consecutive windows, which is
    meaningful only when the stream is sorted so events persist across window
    boundaries.  On temporally-unsorted streams (e.g. the BASELINE.md #2
    crisis embedding stream) positional overlap is random and global metrics
    collapse even when every per-window clustering is good.  Matching by
    cluster centroids in the *input feature space* — which, unlike the
    per-window spectral/SVD embedding, does not rotate between windows —
    keeps IDs stable regardless of row order.

    Matched clusters inherit the registry ID (centroid refreshed to the new
    window's mean); unmatched clusters get fresh globally-unique IDs.
    "Unmatched" REQUIRES ``max_dist``: with the default None, the Hungarian
    assignment always accepts the nearest registry entry however far, so a
    genuinely new event inherits a stale ID whenever the registry has
    spare entries (review r5) — production streams where events are born
    and die should set ``centroid_max_dist`` to the feature-space scale
    beyond which windows are different events.  The
    registry is bounded: beyond ``max_registry`` entries the least recently
    matched clusters are evicted (their IDs stay retired — `next_id` never
    reuses them).
    """

    def __init__(self, max_dist: float | None = None,
                 max_registry: int = 4096):
        self.max_dist = max_dist
        self.max_registry = max_registry
        self.centroids: np.ndarray | None = None   # (P, d)
        self.ids: np.ndarray | None = None         # (P,)
        self.last_used: np.ndarray | None = None   # (P,) window stamp
        self.next_id: int = 0
        self.window: int = 0

    def snapshot(self) -> dict:
        # copies, not views: match() mutates the registry IN PLACE, so an
        # aliased snapshot held for rollback/deferred save silently drifts
        # to post-snapshot state (review r5)
        cp = lambda a: None if a is None else np.array(a)  # noqa: E731
        return {"centroids": cp(self.centroids), "ids": cp(self.ids),
                "next_id": self.next_id, "max_dist": self.max_dist,
                "max_registry": self.max_registry,
                "last_used": cp(self.last_used), "window": self.window}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "CentroidMatcher":
        m = cls(max_dist=snap.get("max_dist"),
                max_registry=snap.get("max_registry", 4096))
        m.centroids = (None if snap.get("centroids") is None
                       else np.array(snap["centroids"]))
        m.ids = None if snap.get("ids") is None else np.array(snap["ids"])
        m.next_id = int(snap.get("next_id", 0))
        m.window = int(snap.get("window", 0))
        m.last_used = snap.get("last_used")
        if m.last_used is None and m.ids is not None:
            m.last_used = np.zeros(len(m.ids), np.int64)
        return m

    def match(self, feats: np.ndarray, clusters: np.ndarray) -> np.ndarray:
        """Remap this window's cluster labels onto stable global IDs.

        feats: (n, d) stable per-row features; clusters: (n,) window-local
        cluster labels.  Returns (n,) globally-stable labels and updates the
        centroid registry.  Rows with non-finite features (the engine's
        invalid-row convention) are excluded from centroid estimation.
        """
        feats = np.asarray(feats, np.float64)
        clusters = np.asarray(clusters)
        # the background bucket id (-1) carries no event identity: those
        # rows are excluded from centroid estimation/registration and keep
        # -1 in the output — globally stable by construction
        active = clusters >= 0
        self.window += 1
        if not active.any():
            return clusters.astype(np.int64)
        sub = clusters[active]
        feats_a = feats[active]
        uniq, inv = np.unique(sub, return_inverse=True)
        row_ok = np.isfinite(feats_a).all(axis=1)
        cents = np.zeros((len(uniq), feats.shape[1]))
        np.add.at(cents, inv[row_ok], feats_a[row_ok])
        counts = np.bincount(inv[row_ok], minlength=len(uniq))
        # a cluster with no finite rows keeps a zero centroid (it can only
        # arise from all-invalid padding; zero keeps every distance finite)
        cents /= np.maximum(counts, 1)[:, None]

        if self.centroids is None or len(self.centroids) == 0:
            self.centroids = cents
            self.ids = uniq.astype(np.int64)
            self.last_used = np.full(len(uniq), self.window, np.int64)
            self.next_id = int(uniq.max()) + 1 if len(uniq) else 0
            return clusters

        # Hungarian on pairwise centroid distances (P x Q via the norm
        # identity - no (P, Q, d) broadcast temporary)
        p_sq = np.sum(self.centroids ** 2, axis=1)[:, None]
        q_sq = np.sum(cents ** 2, axis=1)[None, :]
        d2 = p_sq + q_sq - 2.0 * (self.centroids @ cents.T)
        dist = np.sqrt(np.maximum(d2, 0.0))
        row_ind, col_ind = linear_sum_assignment(dist)
        mapping: dict[int, int] = {}
        matched_rows: dict[int, int] = {}
        for r, c in zip(row_ind, col_ind):
            if self.max_dist is not None and dist[r, c] > self.max_dist:
                continue
            mapping[int(uniq[c])] = int(self.ids[r])
            matched_rows[int(c)] = int(r)

        new_cents, new_ids = [], []
        for c, lbl in enumerate(uniq):
            if c in matched_rows:                 # refresh matched centroid
                r = matched_rows[c]
                self.centroids[r] = cents[c]
                self.last_used[r] = self.window
            else:                                 # register a fresh cluster
                mapping[int(lbl)] = self.next_id
                new_cents.append(cents[c])
                new_ids.append(self.next_id)
                self.next_id += 1
        if new_ids:
            self.centroids = np.concatenate([self.centroids,
                                             np.asarray(new_cents)], axis=0)
            self.ids = np.concatenate([self.ids,
                                       np.asarray(new_ids, np.int64)])
            self.last_used = np.concatenate(
                [self.last_used, np.full(len(new_ids), self.window, np.int64)])
        if len(self.ids) > self.max_registry:     # evict stalest clusters
            keep = np.argsort(self.last_used)[len(self.ids)
                                              - self.max_registry:]
            keep.sort()
            self.centroids = self.centroids[keep]
            self.ids = self.ids[keep]
            self.last_used = self.last_used[keep]
        out = np.full(len(clusters), -1, np.int64)
        out[active] = [mapping[int(c)] for c in sub]
        return out
