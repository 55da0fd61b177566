"""Blocked spectral clustering: normalized cuts beyond the dense cap — port
of ``mused_tpu/ops/blocked_spectral.py``.

The dense path (``ops/spectral``) eigendecomposes the (n, n) normalized
affinity.  Here the matrix stays implicit: with A the fused adjacency
(rebuilt row blocks, ``ops/blocked_affinity.scan_blocks``) and
``M = D^-1/2 (A + A^T)/2 D^-1/2``, the top eigenvectors come from subspace
iteration whose products with M are blocked sweeps:

  degrees   one sweep accumulating the row sums of A and of A^T
  M @ V     one sweep per product: each rebuilt block serves both A u and
            A^T u (u = D^-1/2 V)
  Ritz      a small (m, m) ``eigh`` of the projected matrix, in float64 as
            the dense path runs its ``eigh``

then the NJW row normalization and k-means, as on the dense path.  The
products are true fp32 (the JAX package marks them ``Precision.HIGHEST``):
TF32 stays off (``engine/streaming.configure_precision``).  The Gaussian
probe comes from the caller's ``torch.Generator`` or is injected
(``probe=``), and k-means is called through the module attribute
(``kmeans_mod.kmeans``), so the parity tests can hand both sides the JAX
package's draws.

Spans (``utils/profiling``, recorded only while a profiler runs; device
extents on a CUDA device): ``spectral.degrees`` the degree sweep,
``spectral.sweep`` each product sweep, with the counter ``spectral.sweeps``
(1 per sweep), and ``spectral.ritz`` the QRs, the projected ``eigh`` and
the final rotation.
"""
from __future__ import annotations

import torch

from mused_tpu_torch.ops import blocked_affinity as ba
from mused_tpu_torch.ops import kmeans as kmeans_mod
from mused_tpu_torch.utils import profiling
# the count lives with the dense spectral ops; the blocked path feeds it Ritz
# values
from mused_tpu_torch.ops.spectral import eigengap_k_from_spectrum  # noqa: F401


def _degrees(cols: ba.Columns, *, block: int, k_basis: int, select: str = "strip",
             nbins: int = 0, starts=None, allreduce=ba.no_reduce) -> torch.Tensor:
    """(n,) degrees of (A + A^T)/2: one sweep of row and column sums
    (``starts`` / ``allreduce`` as in ``blocked_affinity.blocked_svd_reduce``)."""
    n = cols.n
    device = cols.valids[0].device
    row_sums = torch.zeros(n, dtype=torch.float32, device=device)
    col_sums = torch.zeros(n, dtype=torch.float32, device=device)
    for start, fused in ba.scan_blocks(cols, block, k_basis, select, nbins, starts=starts):
        row_sums[start:start + block] = torch.sum(fused, dim=1)
        col_sums += torch.sum(fused, dim=0)
    return 0.5 * allreduce(row_sums + col_sums)


def _sym_matmul(cols: ba.Columns, v: torch.Tensor, *, block: int, k_basis: int,
                select: str = "strip", nbins: int = 0, starts=None,
                allreduce=ba.no_reduce) -> torch.Tensor:
    """((A + A^T)/2) @ v for (n, m) v in one sweep: each block is rebuilt
    once and used for both ``fused @ v`` and ``fused.T @ v_block``."""
    with profiling.span("spectral.sweep", device=v.device.type == "cuda"):
        av = torch.zeros_like(v)
        atv = torch.zeros_like(v)
        for start, fused in ba.scan_blocks(cols, block, k_basis, select, nbins,
                                           starts=starts):
            av[start:start + block] = fused @ v
            atv += fused.T @ v[start:start + block]
        out = 0.5 * allreduce(av + atv)
    profiling.counter("spectral.sweeps", 1)
    return out


def ritz_from_products(sym_matmul, inv_sqrt: torch.Tensor,
                       generator: torch.Generator | None, *, n: int, m: int,
                       n_iter: int = 6, probe: torch.Tensor | None = None):
    """Subspace iteration + Rayleigh-Ritz for M = D^-1/2 Â D^-1/2 given only
    ``sym_matmul(v) = Â @ v`` and the degree scaling.  ``probe`` (n, m)
    injects the Gaussian start, else it is drawn from ``generator``.
    Returns (ritz (n, m) basis, eigenvalue estimates (m,)), both in
    descending eigenvalue order."""
    if probe is None:
        probe = torch.randn((n, m), generator=generator, device=inv_sqrt.device,
                            dtype=torch.float32)
    v = probe
    scale = inv_sqrt[:, None]
    on_card = inv_sqrt.device.type == "cuda"
    for _ in range(n_iter):
        mv = sym_matmul(v * scale) * scale
        with profiling.span("spectral.ritz", device=on_card):
            v = torch.linalg.qr(mv)[0]
    mv = sym_matmul(v * scale) * scale
    with profiling.span("spectral.ritz", device=on_card):
        t = v.T @ mv
        lam, w = torch.linalg.eigh((0.5 * (t + t.T)).double())
        return v @ torch.flip(w, (1,)).float(), torch.flip(lam, (0,)).float()


def spectral_embedding_blocked(cols: ba.Columns, generator: torch.Generator | None, *,
                               k_max: int, block: int, k_basis: int, n_iter: int = 6,
                               oversample: int = 8, select: str = "strip", nbins: int = 0,
                               probe: torch.Tensor | None = None, starts=None,
                               allreduce=ba.no_reduce):
    """(ritz, eigenvalues) of the implicit fused adjacency's normalized-cuts
    operator, so a caller can take the cluster count from the spectrum
    before the labels (``k_estimate="eigengap"``).  ``select`` / ``nbins``
    route the sweeps' kNN and ``starts`` / ``allreduce`` share them out as
    in ``blocked_svd_reduce``; ``probe`` injects the Gaussian start.  Rows
    must tile into blocks exactly (pad upstream)."""
    n = cols.n
    if n % block:
        raise ValueError(f"block={block} must divide n={n} (pad rows upstream)")
    kw = dict(block=block, k_basis=k_basis, select=select, nbins=nbins, starts=starts,
              allreduce=allreduce)
    with profiling.span("spectral.degrees", device=cols.valids[0].device.type == "cuda"):
        deg = _degrees(cols, **kw)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)), 0.0)
    return ritz_from_products(lambda v: _sym_matmul(cols, v, **kw), inv_sqrt, generator,
                              n=n, m=min(k_max + oversample, n), n_iter=n_iter, probe=probe)


def spectral_clustering_blocked(cols: ba.Columns, n_clusters,
                                generator: torch.Generator | None, *, k_max: int,
                                block: int, k_basis: int, n_real: int | None = None,
                                n_iter: int = 6, oversample: int = 8,
                                select: str = "strip", nbins: int = 0) -> torch.Tensor:
    """Labels (n_real,) by blocked normalized-cuts spectral clustering.
    ``cols`` has rows padded to a block multiple (padding rows are invalid:
    zero degree, zero embedding); ``n_real`` slices them off before k-means,
    so their blob at the origin cannot take a centroid."""
    ritz, _ = spectral_embedding_blocked(
        cols, generator, k_max=k_max, block=block, k_basis=k_basis, n_iter=n_iter,
        oversample=oversample, select=select, nbins=nbins)
    return labels_from_ritz(ritz, n_clusters, generator, k_max=k_max,
                            n_real=cols.n if n_real is None else n_real)


def labels_from_ritz(ritz: torch.Tensor, n_clusters, generator: torch.Generator | None,
                     *, k_max: int, n_real: int, background: bool = False) -> torch.Tensor:
    """NJW tail: the live eigenvectors (columns < ``n_clusters``), rows
    normalized, then k-means, as the dense path's last step;
    ``background=True`` applies the background bucket on the same
    embedding (``kmeans.mark_background``)."""
    emb = ritz[:n_real, :k_max]
    alive = torch.arange(emb.shape[1], device=emb.device)[None, :] < torch.as_tensor(
        n_clusters, device=emb.device)
    emb = torch.where(alive, emb, 0.0)
    emb = emb / torch.clamp(torch.linalg.norm(emb, dim=1, keepdim=True), min=1e-12)
    labels, _ = kmeans_mod.kmeans(emb, n_clusters, generator, k_max=k_max)
    if background:
        labels = kmeans_mod.mark_background(emb, labels, k_max=k_max)
    return labels
