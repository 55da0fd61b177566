"""Spectral clustering on the fused affinity graph — port of
``mused_tpu/ops/spectral.py``.

Not in the reference's approach list, but one of the framework's target
workloads (BASELINE.md config #2: a crisis stream with spectral clustering).
Normalized-cuts formulation (Ng-Jordan-Weiss): the rows of the top-k
eigenvectors of the symmetric-normalized affinity D^-1/2 (A + A^T)/2 D^-1/2,
row-normalized, clustered with k-means.

The (n, n) symmetric eigendecomposition is ``torch.linalg.eigh`` (cuSOLVER on
the card): the JAX package computes it outside any Pallas kernel too.  It
runs in float64 and returns float32: on the H100, cuSOLVER's float32 path
put a 400-row window's eigenvalues 1.4e-4 from float64
(``tests/test_torch_cuda_slice2.py``), where LAPACK's float32 lands within
1e-6; at the main path's 2000 rows float64 costs about as much as float32.
k-means is called through the module attribute (``kmeans_mod.kmeans``) so
that the parity tests can inject the JAX side's k-means++ draws.
"""
from __future__ import annotations

import torch

from mused_tpu_torch.ops import kmeans as kmeans_mod


def _normalized_spectrum(affinity: torch.Tensor):
    """(eigenvalues, eigenvectors) of D^-1/2 (A+A^T)/2 D^-1/2, descending."""
    a = (affinity.float() + affinity.float().T) * 0.5
    a = a * (1.0 - torch.eye(a.shape[0], dtype=a.dtype, device=a.device))  # no self loops
    deg = torch.sum(a, dim=1)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)), 0.0)
    norm = a * inv_sqrt[:, None] * inv_sqrt[None, :]
    # top eigenvectors of the normalized affinity == bottom of the Laplacian
    lam, vecs = torch.linalg.eigh(norm.double())
    return torch.flip(lam, (0,)).float(), torch.flip(vecs, (1,)).float()


def _njw_embedding(vecs_desc: torch.Tensor, n_components,
                   max_components: int) -> torch.Tensor:
    """NJW tail: live-column mask + row normalization, fixed width."""
    k_cap = min(max_components, vecs_desc.shape[1])
    emb = vecs_desc[:, :k_cap]
    alive = torch.arange(k_cap, device=emb.device)[None, :] < torch.as_tensor(
        n_components, device=emb.device)
    emb = torch.where(alive, emb, 0.0)
    # row-normalize (NJW step); zero rows stay zero
    nrm = torch.linalg.norm(emb, dim=1, keepdim=True)
    emb = emb / torch.clamp(nrm, min=1e-12)
    if k_cap < max_components:
        emb = torch.cat([emb, torch.zeros((emb.shape[0], max_components - k_cap),
                                          dtype=emb.dtype, device=emb.device)], dim=1)
    return emb


def eigengap_k_from_spectrum(lam_desc: torch.Tensor, *, k_max: int, k_min: int = 1,
                             floor: float = 1e-3, rel_floor: float = 0.2) -> torch.Tensor:
    """Label-free cluster count from the normalized-affinity spectrum.

    With μ = 1 − λ, the count is the largest relative jump μ_{i+1}/μ_i within
    the leading ``k_max``; every μ is clamped at ``rel_floor`` × the tail
    value μ_m (and at the absolute ``floor``), so near-zero values, trivial
    or structural, compare as ratio 1 (see the JAX package's docstring for
    the measurements behind both rules).  Returns a () int32 tensor."""
    m = min(k_max + 1, lam_desc.shape[0])
    mu = 1.0 - lam_desc[:m]
    mu = torch.maximum(mu, torch.clamp(rel_floor * mu[m - 1], min=floor))
    ratios = mu[1:] / mu[:-1]
    k = torch.argmax(ratios) + 1
    return torch.clamp(k, k_min, k_max).to(torch.int32)


def spectral_embedding(affinity: torch.Tensor, n_components, *,
                       max_components: int) -> torch.Tensor:
    """(n, max_components) top eigenvectors of the normalized affinity,
    descending, with columns >= ``n_components`` zeroed before the NJW row
    normalization (the geometry of a k = n_components embedding)."""
    _, vecs = _normalized_spectrum(affinity)
    return _njw_embedding(vecs, n_components, max_components)


def spectral_clustering(affinity: torch.Tensor, n_clusters,
                        generator: torch.Generator | None = None, *, k_max: int,
                        k_source: str = "given", background: bool = False) -> torch.Tensor:
    """Labels (n,) from normalized-cuts spectral clustering of the affinity;
    ``n_clusters`` (int or () tensor) <= ``k_max``.

    ``k_source="eigengap"`` ignores ``n_clusters`` and takes the count from
    the spectrum the embedding already computed
    (:func:`eigengap_k_from_spectrum`).  ``background=True`` re-labels the
    far mode of the embedding's distance-to-centroid distribution -1
    (``kmeans.mark_background``)."""
    lam, vecs = _normalized_spectrum(affinity)
    if k_source == "eigengap":
        n_clusters = eigengap_k_from_spectrum(lam, k_max=k_max)
    emb = _njw_embedding(vecs, n_clusters, k_max)
    labels, _ = kmeans_mod.kmeans(emb, n_clusters, generator, k_max=k_max)
    if background:
        labels = kmeans_mod.mark_background(emb, labels, k_max=k_max)
    return labels
