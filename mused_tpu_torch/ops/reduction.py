"""Dimensionality reduction: randomized truncated SVD — port of
``mused_tpu/ops/reduction.py``.

Replaces the reference's ``TruncatedSVD.fit_transform`` (reference
matrix_operations.py:143-147) with the Halko/Martinsson/Tropp range finder:
``reduced = U_r diag(s_r)``, equal to sklearn's output up to sign/rotation.
The Gaussian test matrix ``omega`` comes from the caller's
``torch.Generator`` or is injected (tests hand the JAX side's draw to both).
"""
from __future__ import annotations

import torch


def randomized_svd(x: torch.Tensor, rank: int, generator: torch.Generator | None = None,
                   *, n_iter: int = 4, oversample: int = 10,
                   omega: torch.Tensor | None = None):
    """Top-``rank`` SVD of (n, d) x -> (u (n, r), s (r,), vt (r, d)), with
    ``n_iter`` QR-stabilized power iterations."""
    n, d = x.shape
    k = min(rank + oversample, min(n, d))
    if omega is None:
        omega = torch.randn((d, k), generator=generator, device=x.device, dtype=x.dtype)
    q = torch.linalg.qr(x @ omega)[0]                     # (n, k)
    for _ in range(n_iter):
        z = torch.linalg.qr(x.T @ q)[0]                   # (d, k)
        q = torch.linalg.qr(x @ z)[0]                     # (n, k)
    ub, s, vt = torch.linalg.svd(q.T @ x, full_matrices=False)
    return (q @ ub)[:, :rank], s[:rank], vt[:rank]


def eigengap_k(reduced: torch.Tensor, *, k_max: int, k_min: int = 1,
               theta: float = 0.15) -> torch.Tensor:
    """Unsupervised per-window cluster count from the reduced window's column
    energies (the sigma^2 profile): the largest relative gap among the
    leading ``k_max`` energies.  The i=1 (Perron) gap competes only when no
    later gap exceeds ``theta``; energies below 2% of the leading one and
    gaps into the numerically-zero padding tail are never candidates.
    Returns a () int32 tensor on the input's device."""
    e = torch.sort(torch.sum(reduced * reduced, dim=0), descending=True)[0]
    e = e[:min(k_max + 1, e.shape[0])]
    gaps = (e[:-1] - e[1:]) / torch.clamp(e[:-1], min=1e-30)
    significant = (e[:-1] >= 0.02 * e[0]) & (e[1:] > 1e-9 * e[0])
    gaps = torch.where(significant, gaps, -1.0)
    if gaps.shape[0] > 1:
        strong_secondary = torch.max(gaps[1:]) > theta
        gaps = torch.cat([torch.where(strong_secondary, -1.0, gaps[0])[None], gaps[1:]])
    k = torch.argmax(gaps) + 1
    return torch.clamp(k, k_min, k_max).to(torch.int32)


def svd_reduce(matrix: torch.Tensor, reduced_dim: int,
               generator: torch.Generator | None = None, *,
               omega: torch.Tensor | None = None) -> torch.Tensor:
    """TruncatedSVD.fit_transform equivalent: components clamp to
    ``min(reduced_dim, d - 1)`` like the reference, then zero-pad back to
    ``reduced_dim`` columns (also when the window has fewer rows than the
    rank) so the output shape is always (n, reduced_dim)."""
    d = matrix.shape[1]
    r = min(reduced_dim, d - 1)
    u, s, _ = randomized_svd(matrix, r, generator, omega=omega)
    out = u * s[None, :]
    if out.shape[1] < reduced_dim:
        pad = torch.zeros((matrix.shape[0], reduced_dim - out.shape[1]),
                          dtype=matrix.dtype, device=matrix.device)
        out = torch.cat([out, pad], dim=1)
    return out
