"""Density clustering family: DBSCAN / HDBSCAN / incremental variants — port
of ``mused_tpu/ops/dbscan.py``.

Replaces the reference's sklearn DBSCAN, hdbscan.HDBSCAN, incdbscan
IncrementalDBSCAN and the centroid-matched incremental DBSCAN (reference
matrix_operations.py:235-243, 265-298; main.py:87-91).

  * The O(n^2) geometry (distance matrices, eps-graphs, core degrees) runs
    on the device as masked matrix products.
  * DBSCAN's connected components: min-label propagation over the core-core
    eps-graph, each step followed by a pointer jump (labels[labels]).  The
    propagation has one fixed point, each core component's minimum row
    index, so any schedule that reaches it gives the JAX package's labels
    bit for bit; the jump only cuts the steps from the graph's diameter to
    about its logarithm.  One host sync per step tests convergence.
  * HDBSCAN's MST and condensed tree are sequential host numpy (copied from
    the JAX package: Prim over the implicit mutual-reachability graph).
    Above ``_PRIM_DENSE_CAP`` rows on a card the sweeps move to the device
    Borůvka (``ops/blocked_hdbscan``), as in the JAX package.
  * ``IncrementalDBSCAN`` keeps its points in a capacity-doubling device
    buffer; each insert's new-rows x all-rows distances and exact
    eps-neighbour lists (a top-k whose order is ``lax.top_k``'s: nearest
    first, lowest index on ties) run on the device, and the monotone
    union-find over core transitions runs in the native C++ core
    (``native/incdbscan.cpp``).

Labels are numbered by each cluster's minimum member row index (border
points included); noise is -1.  eps is squared in float32, as the JAX
package does, so a pair at the same distance gets the same verdict.
"""
from __future__ import annotations

import numpy as np
import torch

from mused_tpu_torch.ops.affinity import order_keys
from mused_tpu_torch.ops.kmeans import _sq_dists


def _eps2(eps) -> float:
    """eps * eps rounded to float32 (the JAX package squares a float32 eps)."""
    return float(np.float32(eps) * np.float32(eps))


def _as_points(data, device) -> torch.Tensor:
    """(n, d) float32 points on ``device`` (a tensor keeps its own device)."""
    if isinstance(data, torch.Tensor):
        return data.float()
    return torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(device)


def _first_occurrence_compaction(roots: torch.Tensor,
                                 is_clustered: torch.Tensor) -> torch.Tensor:
    """Relabel root row ids to consecutive ints by first occurrence; -1 noise."""
    n = roots.shape[0]
    arange = torch.arange(n, device=roots.device)
    safe_roots = torch.where(is_clustered, roots, 0)
    first = torch.full((n,), n, dtype=torch.int64, device=roots.device).scatter_reduce(
        0, safe_roots, torch.where(is_clustered, arange, n), reduce="amin")
    first_of = first[safe_roots]                      # first row index of my cluster
    is_rep = is_clustered & (arange == first_of)
    rank = torch.cumsum(is_rep.long(), 0) - 1         # rank of rep at its own row
    new = rank[torch.clamp(first_of, max=n - 1)]      # JAX clamps the gather too
    return torch.where(is_clustered, new, -1).to(torch.int32)


def dbscan_labels(x: torch.Tensor, eps: float, min_samples: int) -> torch.Tensor:
    """DBSCAN on (n, d) points -> (n,) int32 labels, noise = -1.

    eps-graph + core mask, then min-label propagation over the core-core
    subgraph (see the module docstring), then border attachment to the
    minimum-labelled core neighbour."""
    n = x.shape[0]
    x = x.float()
    within = _sq_dists(x, x) <= _eps2(eps)            # includes self
    core = torch.sum(within, dim=1) >= int(min_samples)
    core_edge = within & core[:, None] & core[None, :]
    arange = torch.arange(n, device=x.device)
    labels = torch.where(core, arange, n)
    while True:
        neigh_min = torch.min(torch.where(core_edge, labels[None, :], n), dim=1)[0]
        new = torch.minimum(labels, neigh_min)
        # pointer jump: a core row's label is a core row of its component
        new = torch.where(core, new[torch.clamp(new, max=n - 1)], n)
        if torch.equal(new, labels):
            break
        labels = new

    # border points: non-core within eps of a core point -> that root's label
    border_min = torch.min(torch.where(within & core[None, :], labels[None, :], n),
                           dim=1)[0]
    is_border = ~core & (border_min < n)
    roots = torch.where(core, labels, torch.where(is_border, border_min, 0))
    return _first_occurrence_compaction(roots, core | is_border)


def dbscan(data, eps: float = 0.5, min_samples: int = 5, *, device="cuda") -> np.ndarray:
    """Host-facing DBSCAN (reference matrix_operations.py:235-238) on
    ``device`` (a tensor's own device when ``data`` is one)."""
    x = _as_points(data, device)
    if x.shape[0] == 0:
        return np.empty(0, np.int32)
    return dbscan_labels(x, eps, min_samples).cpu().numpy()


# ---------------------------------------------------------------------------
# HDBSCAN (batch): host Prim MST over the implicit mutual-reachability graph
# ---------------------------------------------------------------------------

class _UnionFind:
    def __init__(self, n):
        self.parent = list(range(n))

    def find(self, a):
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra
        return ra


# Above this row count the full (n, n) squared-distance matrix (f32) is not
# materialized on host: ~1 GiB at the cap.  Beyond it Prim recomputes each
# row as one BLAS matvec (CPU), and on a card the device Borůvka
# (ops/blocked_hdbscan) takes the sweeps instead.
_PRIM_DENSE_CAP = 16_384


def _prim_mst_mreach(x: np.ndarray, min_samples: int) -> list[tuple]:
    """Exact MST of the implicit mutual-reachability graph, host numpy
    (copied from the JAX package): O(n^2 d), one row of
    max(core_i, core_u, d_iu) per Prim step, the (n, n) matrix built once in
    f32 blocks up to ``_PRIM_DENSE_CAP`` rows and rebuilt per step above."""
    n = len(x)
    sq = np.einsum("ij,ij->i", x, x)
    # min_samples <= 1 degrades to core = 0 (a plain distance MST)
    k = min(max(min_samples, 1), n)

    mreach = None
    core = np.empty(n, np.float32)
    blk = max(1, min(n, (1 << 24) // max(n, 1)))       # ~64 MB gram slabs
    if n <= _PRIM_DENSE_CAP:
        mreach = np.empty((n, n), np.float32)
    for s in range(0, n, blk):
        e = min(s + blk, n)
        g = x[s:e] @ x.T
        g *= -2.0
        g += sq[s:e, None]
        g += sq[None, :]
        np.maximum(g, 0.0, out=g)
        core[s:e] = np.partition(g, k - 1, axis=1)[:, k - 1]
        if mreach is not None:
            np.sqrt(g, out=g)
            mreach[s:e] = g
    np.sqrt(core, out=core)
    if mreach is not None:
        # fold the core distances in once, so every Prim row is a plain view
        np.maximum(mreach, core[None, :], out=mreach)
        np.maximum(mreach, core[:, None], out=mreach)

    live = np.ones(n, bool)                 # not yet in the tree
    best_w = np.full(n, np.inf, np.float32)  # cheapest edge into the tree
    best_src = np.zeros(n, np.int64)
    upd = np.empty(n, bool)
    edges: list[tuple] = []
    u = 0
    live[0] = False
    for _ in range(n - 1):
        if mreach is not None:
            w = mreach[u]
        else:
            d2 = sq[u] + sq - 2.0 * (x @ x[u])
            np.maximum(d2, 0.0, out=d2)
            w = np.sqrt(d2, out=d2)
            np.maximum(w, core, out=w)
            if core[u] > 0.0:
                np.maximum(w, core[u], out=w)
        np.less(w, best_w, out=upd)
        upd &= live
        best_w[upd] = w[upd]
        best_src[upd] = u
        v = int(np.argmin(best_w))
        edges.append((float(best_w[v]), int(best_src[v]), v))
        live[v] = False
        best_w[v] = np.inf
        u = v
    return edges


def hdbscan(data, min_cluster_size: int = 5, min_samples: int = 2, *,
            device="cuda") -> np.ndarray:
    """HDBSCAN with excess-of-mass extraction (reference
    matrix_operations.py:240-243): MST -> single-linkage merge tree ->
    condensed tree (min_cluster_size) -> eom selection -> labels.  The MST
    is host Prim, except above ``_PRIM_DENSE_CAP`` rows on a card, where
    the sweeps go to the device Borůvka (``ops/blocked_hdbscan``): the same
    MST weights, the same extraction, as the JAX package routes off the
    CPU."""
    if isinstance(data, torch.Tensor):
        device = data.device
    n = len(data)
    if n > _PRIM_DENSE_CAP and torch.device(device).type == "cuda":
        from mused_tpu_torch.ops import blocked_hdbscan
        return blocked_hdbscan.hdbscan_blocked(data, min_cluster_size=min_cluster_size,
                                               min_samples=min_samples, device=device)
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    x = np.asarray(data, np.float32)
    if n == 0:
        return np.empty(0, np.int64)
    if n == 1:
        return np.array([-1], np.int64)
    edges = sorted(_prim_mst_mreach(x, min_samples))
    return _extract_labels(edges, n, min_cluster_size)


def _extract_labels(edges, n: int, min_cluster_size: int) -> np.ndarray:
    """Single-linkage merge tree -> condensed tree -> eom labels, from sorted
    MST edges (w, a, b) (copied from the JAX package)."""
    # single-linkage merge tree; internal nodes get ids >= n
    uf = _UnionFind(2 * n - 1)
    node_of_root = list(range(n))
    size = [1] * n + [0] * (n - 1)
    children: list[tuple | None] = [None] * (2 * n - 1)
    next_node = n
    for dist, a, b in edges:
        ra, rb = uf.find(int(a)), uf.find(int(b))
        na, nb = node_of_root[ra], node_of_root[rb]
        r = uf.union(ra, rb)
        node_of_root[r] = next_node
        size[next_node] = size[na] + size[nb]
        children[next_node] = (na, nb, dist)
        next_node += 1
    root = next_node - 1

    def subtree_points(node):
        out, stack = [], [node]
        while stack:
            m = stack.pop()
            if m < n:
                out.append(m)
            else:
                a, b, _ = children[m]
                stack.extend((a, b))
        return out

    # condensed tree walk: points falling out of each cluster (with their
    # lambda) and the true splits' birth lambdas
    lam_birth = {root: 0.0}
    cluster_parent: dict[int, int] = {}
    child_clusters: dict[int, list[int]] = {root: []}
    point_parent: dict[int, int] = {}
    point_out_lambda = np.zeros(n)

    stack = [root]
    while stack:
        c = stack.pop()
        child_clusters.setdefault(c, [])
        node_stack = [c]
        while node_stack:
            m = node_stack.pop()
            if m < n:
                # a leaf point directly inside c: falls out "never"
                point_parent[m] = c
                point_out_lambda[m] = np.inf
                continue
            a, b, dist = children[m]
            lam = 1.0 / dist if dist > 0 else np.inf
            big_a = size[a] >= min_cluster_size
            big_b = size[b] >= min_cluster_size
            if big_a and big_b:
                # true split: both sides become child clusters of c
                for ch in (a, b):
                    lam_birth[ch] = lam
                    cluster_parent[ch] = c
                    child_clusters[c].append(ch)
                    stack.append(ch)
            else:
                for side, big in ((a, big_a), (b, big_b)):
                    if big:
                        node_stack.append(side)
                    else:
                        for p in subtree_points(side):
                            point_parent[p] = c
                            point_out_lambda[p] = lam

    # cap every inf lambda (point out-lambdas and birth lambdas) at one
    # global finite scale, so zero-distance splits cannot make inf - inf
    finite = point_out_lambda[np.isfinite(point_out_lambda)]
    finite_births = [v for v in lam_birth.values() if np.isfinite(v)]
    cap = max(finite.max() if len(finite) else 1.0,
              max(finite_births) if finite_births else 1.0)
    point_out_lambda = np.where(np.isfinite(point_out_lambda), point_out_lambda, cap)
    for c, v in lam_birth.items():
        if not np.isfinite(v):
            lam_birth[c] = cap

    stability: dict[int, float] = {c: 0.0 for c in child_clusters}
    for p, c in point_parent.items():
        stability[c] += max(point_out_lambda[p] - lam_birth[c], 0.0)
    for ch, par in cluster_parent.items():
        stability[par] += max(lam_birth[ch] - lam_birth[par], 0.0) * size[ch]

    # excess of mass, bottom-up (iterative post-order; the root is never
    # selected)
    selected: set[int] = set()
    win_sum: dict[int, float] = {}
    post: list[int] = []
    stack_ = [root]
    while stack_:
        c = stack_.pop()
        post.append(c)
        stack_.extend(child_clusters.get(c, []))
    for c in reversed(post):             # children before parents
        kids = child_clusters.get(c, [])
        if not kids:
            if c != root:
                selected.add(c)
            win_sum[c] = stability[c]
            continue
        kid_sum = sum(win_sum[k] for k in kids)
        if c != root and stability[c] >= kid_sum:
            walk = list(kids)
            while walk:
                m = walk.pop()
                selected.discard(m)
                walk.extend(child_clusters.get(m, []))
            selected.add(c)
            win_sum[c] = stability[c]
        else:
            win_sum[c] = kid_sum

    # each point takes the nearest selected cluster up its condensed parent
    # chain; the root means noise
    labels = np.full(n, -1, np.int64)
    for p in range(n):
        c = point_parent.get(p, root)
        while c != root and c not in selected:
            c = cluster_parent[c]
        if c in selected:
            labels[p] = c

    out = np.full(n, -1, np.int64)
    mapping: dict[int, int] = {}
    for i in range(n):
        if labels[i] >= 0:
            out[i] = mapping.setdefault(labels[i], len(mapping))
    return out


# ---------------------------------------------------------------------------
# incremental variants
# ---------------------------------------------------------------------------

_FALLBACK_CAP = 8192    # caps the no-native fallback's re-clustered buffer


def nearest_within(d2_masked: torch.Tensor, k: int):
    """The k nearest columns per row of a masked squared-distance matrix, in
    ``lax.top_k(-d2, k)``'s order: nearest first, lowest column on ties, and
    -0.0 above +0.0 (its negation ranks below).  Returns (d2, column)."""
    idx = torch.sort(order_keys(-d2_masked), dim=1, descending=True, stable=True)[1][:, :k]
    return torch.gather(d2_masked, 1, idx), idx


class IncrementalDBSCAN:
    """insert / get_cluster_labels contract of the incdbscan library used at
    reference main.py:87-91, exact for the insertion-only stream.

    The default (``max_buffer=None``) is exact incremental DBSCAN over
    everything ever inserted: the new-rows x all-rows geometry runs on
    ``device`` (a capacity-doubling buffer; each row's exact eps-neighbours
    come from a top-k whose k is the batch's largest within-eps count,
    rounded up to a power of two), and the monotone union-find over core
    transitions runs in the native C++ core.  Labels equal batch DBSCAN over
    the full inserted set however the stream was batched (a border point
    tied between clusters joins its first core neighbour in discovery
    order).  Without the native library the fallback re-clusters the whole
    buffer on the device, exact up to ``_FALLBACK_CAP`` points and capped
    beyond.  ``max_buffer=k`` keeps the legacy capped mode: re-cluster the
    last k points."""

    def __init__(self, eps: float, min_pts: int, max_buffer: int | None = None, *,
                 device="cuda"):
        self.eps = float(eps)
        self.min_pts = int(min_pts)
        self.max_buffer = None if max_buffer is None else int(max_buffer)
        self.device = torch.device(device)
        self._buf: np.ndarray | None = None        # host copy (checkpointing)
        self._labels: np.ndarray | None = None
        self._handle = None                         # native union-find core
        self._handle_tried = False
        self._dev_buf: torch.Tensor | None = None   # capacity-padded points
        self._n = 0                                 # valid rows in _dev_buf

    # -- exact-mode internals ------------------------------------------
    def _native_handle(self):
        if not self._handle_tried:
            self._handle_tried = True
            from mused_tpu_torch import native
            self._handle = native.IncDBHandle.create(self.min_pts)
        return self._handle

    def _ensure_capacity(self, need: int, d: int) -> None:
        cap = self._dev_buf.shape[0] if self._dev_buf is not None else 0
        if need <= cap:
            return
        grown = torch.zeros((max(256, 1 << (need - 1).bit_length()), d),
                            dtype=torch.float32, device=self.device)
        if self._dev_buf is not None and self._n:
            grown[:self._n] = self._dev_buf[:self._n]
        self._dev_buf = grown

    def _insert_exact(self, pts: np.ndarray) -> None:
        n_new, d = pts.shape
        n_old = self._n
        self._ensure_capacity(n_old + n_new, d)
        new = torch.from_numpy(pts).to(self.device)
        self._dev_buf[n_old:n_old + n_new] = new
        self._n = n_old + n_new
        d2 = _sq_dists(new, self._dev_buf)
        valid = torch.arange(self._dev_buf.shape[0], device=self.device)[None, :] < self._n
        eps2 = _eps2(self.eps)
        counts = torch.sum(valid & (d2 <= eps2), dim=1)
        k = int(torch.max(counts)) if n_new else 1
        k = min(max(32, 1 << (max(k, 1) - 1).bit_length()), self._n)
        vals, idx = nearest_within(torch.where(valid, d2, torch.inf), k)
        gids = torch.arange(n_old, self._n, device=self.device)[:, None].expand_as(idx)
        # keep only earlier-id neighbours: each unordered pair once
        # (old-new pairs here; new-new pairs from the higher id's row); only
        # the pairs cross to the host, in row-major (discovery) order
        mask = (vals <= eps2) & (idx < gids)
        self._handle.insert(n_new, gids[mask].to(torch.int32).cpu().numpy(),
                            idx[mask].to(torch.int32).cpu().numpy())

    # -- public contract ------------------------------------------------
    def insert(self, points) -> "IncrementalDBSCAN":
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu().numpy()
        pts = np.atleast_2d(np.asarray(points, np.float32))
        self._buf = pts if self._buf is None else np.concatenate([self._buf, pts])
        if self.max_buffer is not None:            # legacy bounded mode
            if len(self._buf) > self.max_buffer:
                self._buf = self._buf[-self.max_buffer:]
            self._labels = dbscan(self._buf, eps=self.eps, min_samples=self.min_pts,
                                  device=self.device)
            return self
        if self._native_handle() is not None:
            self._insert_exact(pts)
            self._labels = None                    # pulled lazily
        else:
            # exact by re-clustering, capped so device memory stays bounded
            if len(self._buf) > _FALLBACK_CAP:
                self._buf = self._buf[-_FALLBACK_CAP:]
            self._labels = dbscan(self._buf, eps=self.eps, min_samples=self.min_pts,
                                  device=self.device)
        return self

    def get_cluster_labels(self, points) -> np.ndarray:
        # a bare (d,) point is ONE record, as in insert()
        k = len(np.atleast_2d(np.asarray(points)))
        if self._labels is None:
            self._labels = self._handle.labels()
        if k > len(self._labels):
            raise ValueError(
                f"queried {k} labels but only {len(self._labels)} points are "
                "retained (bounded max_buffer/fallback mode evicted older rows)")
        return np.asarray(self._labels[-k:])

    # -- checkpointing ---------------------------------------------------
    def snapshot(self) -> dict:
        """Picklable state, the JAX package's layout.  Exact mode stores only
        the inserted points: labels do not depend on batching, so a restore
        re-inserts them in one batch."""
        return {"eps": self.eps, "min_pts": self.min_pts,
                "max_buffer": self.max_buffer, "buf": self._buf,
                "labels": self._labels if self.max_buffer is not None else None}

    @classmethod
    def from_snapshot(cls, snap: dict, *, device="cuda") -> "IncrementalDBSCAN":
        inc = cls(snap["eps"], snap["min_pts"], snap.get("max_buffer"), device=device)
        if snap.get("buf") is not None and len(snap["buf"]):
            if inc.max_buffer is not None:
                inc._buf = snap["buf"]
                inc._labels = snap["labels"]
                if inc._labels is None:
                    inc._labels = dbscan(inc._buf, eps=inc.eps, min_samples=inc.min_pts,
                                         device=inc.device)
            else:
                inc.insert(snap["buf"])
        return inc


def match_centroids(data: np.ndarray, labels: np.ndarray, previous_centroids,
                    previous_labels):
    """Centroid matching across windows (reference matrix_operations.py:
    278-298), host numpy copied from the JAX package: each new cluster's
    centroid maps to the nearest previous centroid and inherits its label.

    Returns (labels, new_centroids, centroid_labels); ``centroid_labels[i]``
    is the final (re-mapped) label of ``new_centroids[i]``, the pair the next
    window's lookup indexes (the reference's misaligned uniques are the JAX
    package's documented fix)."""
    labels = np.asarray(labels)
    # each cluster's rows in their original order (a stable sort groups them),
    # so every mean sums the same rows in the same order as data[labels == c]
    order = np.argsort(labels, kind="stable")
    values, starts = np.unique(labels[order], return_index=True)
    members = [rows for c, rows in zip(values, np.split(order, starts[1:])) if c != -1]
    unique_clusters = [c for c in values if c != -1]
    new_centroids = np.array([data[rows].mean(axis=0) for rows in members]) \
        if unique_clusters else np.empty((0, data.shape[1]), np.float32)

    mapping = {}
    if previous_centroids is not None and len(previous_centroids) > 0 \
            and len(new_centroids) > 0:
        prev = np.asarray(previous_centroids)
        # the (new, previous, d) differences in slabs of rows: the same norms,
        # without a many-GB temporary when both windows hold thousands of clusters
        step = max(1, (1 << 26) // max(1, prev.size))
        matches = np.concatenate([
            np.argmin(np.linalg.norm(new_centroids[s:s + step, None, :] - prev[None, :, :],
                                     axis=-1), axis=1)
            for s in range(0, len(new_centroids), step)])
        prev_labels = np.asarray(previous_labels)
        # positions in unique_clusters ARE the label values (labels are
        # first-occurrence compacted 0..k-1)
        mapping = {new: (prev_labels[old] if old < len(prev_labels) else -1)
                   for new, old in enumerate(matches)}
        labels = np.array([mapping[l] if l in mapping else l for l in labels])
    centroid_labels = np.array([mapping.get(int(c), int(c)) for c in unique_clusters],
                               np.int64)
    return labels, new_centroids, centroid_labels


def dbscan_centroid_incremental(data, previous_centroids, previous_labels,
                                eps: float = 0.5, min_samples: int = 5, *,
                                device="cuda"):
    """Per-window DBSCAN + centroid matching to the previous window
    (reference matrix_operations.py:265-298, with the JAX package's
    evident-intent semantics: the re-map is the matching)."""
    data = np.asarray(data, np.float32)
    if data.ndim != 2:
        return None, previous_centroids, previous_labels
    labels = dbscan(data, eps=eps, min_samples=min_samples, device=device)
    return match_centroids(data, labels, previous_centroids, previous_labels)
