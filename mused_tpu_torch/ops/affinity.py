"""Per-modality directed kNN affinity graphs as plain PyTorch tensor ops.

Port of ``mused_tpu/ops/affinity.py`` (reference matrix_operations.py:14-132):
one dense n x n 0/1 adjacency per modality, edges i->j for j among i's k
nearest neighbours under a modality-specific similarity, self-edges
skipped, invalid rows excluded entirely.  This dense path is the CPU path of
the engine and the oracle of the hand-written kernel
(``ops/kernels/affinity_kernel.py``).  Per-modality k conventions (kept from
the JAX package, SURVEY.md §2.4):

  location  k_basis   neighbours
  time      3*k_basis neighbours
  username  ALL rows sharing the username (k ignored)
  tags      k_basis   neighbours, self similarity below any real one
  text      k_basis   neighbours
  default   k_basis-1 neighbours (the reference counts self among k_basis)

Selection reproduces ``lax.top_k`` exactly: the k largest similarities in
IEEE total order (so -0.0 ranks below +0.0), ties kept lowest column index
first.  ``torch.topk`` promises no tie order, so the rank is a stable
descending sort of the similarities' order-preserving int32 keys.
Zero-similarity "neighbours" are kept like the reference's argsort does;
only column validity drops edges.  Products the JAX package marks
``Precision.HIGHEST`` run in true fp32 (the engine turns TF32 off).
"""
from __future__ import annotations

import torch

NEG = -1e30  # "invalid" similarity sentinel; any real similarity is larger


def order_keys(sim: torch.Tensor) -> torch.Tensor:
    """int32 keys whose signed order is the IEEE total order of ``sim``."""
    bits = sim.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def knn_adjacency(sim: torch.Tensor, valid: torch.Tensor, k: int,
                  exclude_self: bool = True) -> torch.Tensor:
    """Directed kNN adjacency from a similarity matrix (higher = closer).

    sim: (n, n) float32; valid: (n,) bool.  Invalid rows emit no edges and
    receive none.  Returns (n, n) float32 in {0, 1} with zero diagonal.
    """
    n = sim.shape[0]
    k = max(0, min(k, n - 1 if exclude_self else n))
    adj = torch.zeros((n, n), dtype=torch.float32, device=sim.device)
    if k == 0:
        return adj
    sim = torch.where(valid[None, :], sim.float(), NEG)
    if exclude_self:
        sim = sim.masked_fill(torch.eye(n, dtype=torch.bool, device=sim.device), NEG)
    idx = torch.sort(order_keys(sim), dim=1, descending=True, stable=True)[1][:, :k]
    vals = torch.gather(sim, 1, idx)
    edge = (vals > NEG / 2) & valid[:, None]               # drop invalid picks
    return adj.scatter_(1, idx, edge.float())


def knn_adjacency_block(sim: torch.Tensor, row_valid: torch.Tensor,
                        col_valid: torch.Tensor, k: int, row_offset: int,
                        approx: bool = False, out_dtype=torch.float32) -> torch.Tensor:
    """Rectangular (m, n) kNN adjacency for a row block of a larger matrix;
    ``row_offset`` is the global index of local row 0 (self exclusion).

    Same selection as :func:`knn_adjacency`: the k largest in IEEE total
    order, lowest column first on ties.  ``approx=True`` (the JAX package's
    ``lax.approx_max_k``, a TPU partial reduction) runs exactly here, as the
    JAX package itself does off the TPU, so the JAX run on the CPU is the
    parity target."""
    del approx
    m, n = sim.shape
    k = max(0, min(k, n - 1))
    adj = torch.zeros((m, n), dtype=out_dtype, device=sim.device)
    if k == 0:
        return adj
    cols = torch.arange(n, device=sim.device)
    is_self = (row_offset + torch.arange(m, device=sim.device))[:, None] == cols[None, :]
    sim = torch.where(col_valid[None, :] & ~is_self, sim.float(), NEG)
    idx = torch.sort(order_keys(sim), dim=1, descending=True, stable=True)[1][:, :k]
    edge = (torch.gather(sim, 1, idx) > NEG / 2) & row_valid[:, None]
    return adj.scatter_(1, idx, edge.to(out_dtype))


# ---------------------------------------------------------------------------
# modality similarity kernels
# ---------------------------------------------------------------------------

def haversine_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise great-circle distance (km) between (m, 2) and (n, 2)
    [lat, lon] degree arrays."""
    ra, rb = torch.deg2rad(a), torch.deg2rad(b)
    dlat = ra[:, 0][:, None] - rb[:, 0][None, :]
    dlon = ra[:, 1][:, None] - rb[:, 1][None, :]
    h = torch.sin(dlat / 2) ** 2 + torch.cos(ra[:, 0])[:, None] \
        * torch.cos(rb[:, 0])[None, :] * torch.sin(dlon / 2) ** 2
    return 2.0 * 6371.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


def haversine_sim(rows: torch.Tensor, cols: torch.Tensor, row_valid: torch.Tensor,
                  col_valid: torch.Tensor) -> torch.Tensor:
    """(m, n) negated haversine distances of [lat, lon] rows against
    columns, invalid ones at (0, 0): the location kNN's similarity strip."""
    return -haversine_block(torch.where(row_valid[:, None], rows, 0.0),
                            torch.where(col_valid[:, None], cols, 0.0))


def location_adjacency(latlon: torch.Tensor, k_basis: int) -> torch.Tensor:
    """kNN under haversine distance; NaN coordinates are invalid."""
    valid = torch.all(torch.isfinite(latlon), dim=1)
    safe = torch.where(valid[:, None], latlon, 0.0)
    return knn_adjacency(-haversine_block(safe, safe), valid, k_basis)


def time_valid(times: torch.Tensor) -> torch.Tensor:
    """Zero or non-finite timestamps are invalid (NaN also marks padding)."""
    return (torch.all(torch.isfinite(times), dim=1)
            & (times[:, 0] != 0.0) & (times[:, 1] != 0.0))


def time_sim(rows: torch.Tensor, cols: torch.Tensor, row_valid: torch.Tensor,
             col_valid: torch.Tensor) -> torch.Tensor:
    """(m, n) negated |dt_taken| + |dt_upload| of rows against columns,
    invalid ones at 0: the time kNN's similarity strip."""
    r = torch.where(row_valid[:, None], rows, 0.0)
    c = torch.where(col_valid[:, None], cols, 0.0)
    return -(torch.abs(r[:, :1] - c[:, 0][None, :]) + torch.abs(r[:, 1:2] - c[:, 1][None, :]))


def time_adjacency(times: torch.Tensor, k_basis: int) -> torch.Tensor:
    """kNN under |dt_taken| + |dt_upload|, 3*k_basis neighbours."""
    valid = time_valid(times)
    taken = torch.abs(times[:, 0][:, None] - times[:, 0][None, :])
    upload = torch.abs(times[:, 1][:, None] - times[:, 1][None, :])
    return knn_adjacency(-(taken + upload), valid, 3 * k_basis)


def username_adjacency(user_ids: torch.Tensor) -> torch.Tensor:
    """Connect all rows sharing a username (ids < 0 invalid); k ignored."""
    n = user_ids.shape[0]
    valid = user_ids >= 0
    same = (user_ids[:, None] == user_ids[None, :]) & valid[:, None] & valid[None, :]
    same &= ~torch.eye(n, dtype=torch.bool, device=user_ids.device)
    return same.float()


def jaccard_matrix(multihot: torch.Tensor) -> torch.Tensor:
    """Pairwise Jaccard over (n, H) 0/1 incidence: inter = M M^T."""
    m = multihot.float()
    inter = m @ m.T
    sizes = torch.sum(m, dim=1)
    union = sizes[:, None] + sizes[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9), 0.0)


def tags_adjacency(tags_multihot: torch.Tensor, k_basis: int,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Top-k Jaccard neighbours; ``valid`` reproduces the reference's
    empty-string quirk (an empty tag LIST still participates)."""
    tags_multihot = tags_multihot.float()
    if valid is None:
        valid = torch.sum(tags_multihot, dim=1) > 0
    return knn_adjacency(jaccard_matrix(tags_multihot), valid, k_basis)


def tfidf_rows(counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L2-normalized TF-IDF rows, row validity) of hashed token counts.

    sklearn conventions: tf = raw count, idf = ln((1+n)/(1+df)) + 1 over the
    valid (nonzero) documents only."""
    counts = counts.float()
    valid = torch.sum(counts, dim=1) > 0
    n_docs = torch.clamp(torch.sum(valid.float()), min=1.0)
    df = torch.sum((counts > 0) & valid[:, None], dim=0).float()
    idf = torch.log((1.0 + n_docs) / (1.0 + df)) + 1.0
    x = counts * idf[None, :]
    norm = torch.linalg.norm(x, dim=1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12), valid


def tfidf_cosine_matrix(counts: torch.Tensor) -> torch.Tensor:
    """Pairwise TF-IDF cosine of hashed token counts."""
    x, _ = tfidf_rows(counts)
    return x @ x.T


def text_adjacency(text_counts: torch.Tensor, k_basis: int,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Top-k TF-IDF-cosine neighbours (default validity: nonzero counts)."""
    text_counts = text_counts.float()
    if valid is None:
        valid = torch.sum(text_counts, dim=1) > 0
    return knn_adjacency(tfidf_cosine_matrix(text_counts), valid, k_basis)


def euclidean_sim(rows: torch.Tensor, cols: torch.Tensor, row_valid: torch.Tensor,
                  col_valid: torch.Tensor) -> torch.Tensor:
    """(m, n) negated squared Euclidean distances (clamped at 0) of rows
    against columns, invalid ones at the origin: the default modality's
    kNN similarity strip."""
    r = torch.where(row_valid[:, None], rows, 0.0)
    c = torch.where(col_valid[:, None], cols, 0.0)
    d2 = (torch.sum(r * r, dim=1)[:, None] + torch.sum(c * c, dim=1)[None, :]
          - 2.0 * (r @ c.T))
    return -torch.clamp(d2, min=0.0)


def euclidean_adjacency(data: torch.Tensor, k_basis: int) -> torch.Tensor:
    """Default modality: Euclidean kNN with k_basis-1 neighbours."""
    valid = torch.all(torch.isfinite(data), dim=1)
    return knn_adjacency(euclidean_sim(data, data, valid, valid), valid, max(1, k_basis) - 1)


def embedding_adjacency(emb: torch.Tensor, k_basis: int) -> torch.Tensor:
    """Dense-embedding modality: cosine kNN; all-zero or non-finite rows
    invalid."""
    x, valid = normalized_embedding(emb)
    return knn_adjacency(x @ x.T, valid, k_basis)


def normalized_embedding(emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(unit rows with invalid rows zeroed, validity) of an embedding."""
    finite = torch.all(torch.isfinite(emb), dim=1)
    safe = torch.where(finite[:, None], emb, 0.0)
    norm = torch.linalg.norm(safe, dim=1, keepdim=True)
    return safe / torch.clamp(norm, min=1e-12), finite & (norm[:, 0] > 0)


def counts_from_tokens(ids: torch.Tensor, counts: torch.Tensor | None,
                       dim: int) -> torch.Tensor:
    """Scatter sparse hashed tokens (ids (n, T), -1 padding) back to a dense
    (n, dim) f32 tensor; ``counts`` None means multi-hot."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    if counts is None:
        vals = valid.float()
    else:
        vals = torch.where(valid, counts.float(), 0.0)
    out = torch.zeros((ids.shape[0], dim), dtype=torch.float32, device=ids.device)
    return out.scatter_add_(1, safe, vals)   # ids are deduped per row upstream


def fuse(adjacency_matrices: list[torch.Tensor]) -> torch.Tensor:
    """Element-wise logical OR of modality graphs."""
    fused = adjacency_matrices[0]
    for m in adjacency_matrices[1:]:
        fused = torch.maximum(fused, m)
    return fused


def multimodal_fused_adjacency(location, times, user_ids, tags_multihot,
                               text_counts, *, k_basis: int,
                               tags_valid=None) -> torch.Tensor:
    """All five modality graphs + OR-fusion."""
    return fuse([
        location_adjacency(location, k_basis),
        time_adjacency(times, k_basis),
        username_adjacency(user_ids),
        tags_adjacency(tags_multihot, k_basis, tags_valid),
        text_adjacency(text_counts, k_basis),
    ])
