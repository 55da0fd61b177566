"""The numbers that decide ``correct``, each computed in float64.

* ``graph_mismatch``: the share of the reference graph's edges that the
  program's graph lacks or adds, |A_prog xor A_ref| / |A_ref|.
* ``fd_excess``: Frequent Directions promises B^T B <= A^T A for the sketch
  B of the rows of A.  For every sketch row b_i the program returns, with
  x = b_i / |b_i|, it reads (|B x|^2 - |A x|^2) / |B|_2^2; the largest is
  reported.  A sketch of other rows than A's breaks the promise by far.
* ``fd_deficit``: the other side of the promise, |A x|^2 - |B x|^2 <=
  |A|_F^2 / l for every unit x, with A the reference's graph and l the
  sketch's rows: the largest eigenvalue of A^T A - B^T B over |A|_F^2 / l.
  A sketch that folded only some of A's rows, or shrank too far, misses
  their energy and reads above 1.
* ``svd_identity``: a truncated SVD U S returned as (n, r) columns u_i s_i
  satisfies |A^T u_i| = s_i whatever test matrix it started from.  The
  largest | |A^T u_i| - s_i | / s_1 is reported.
* ``svd_energy_gap``: 1 - sum s_i^2 / sum sigma_i^2, the energy the
  program's r columns capture against the top r singular values sigma_i of
  the reference's graph (:func:`top_energy`).  An SVD of part of the graph,
  as one whose products dropped rows, captures part of its energy.
* ``label_cost_excess``: the k-means cost of the program's labels in the
  embedding the program clustered (its own reduction, which the numbers
  above check against its graph) over the cost that Lloyd's steps reach
  from that partition, less 1: k-means ends on a fixed point of Lloyd's
  step, labels of anything else are far from one.  Rows labelled -1 (no
  event) are left out.
"""
from __future__ import annotations

import numpy as np
import torch


def graph_mismatch(diff_edges: int, ref_edges: int) -> float:
    return diff_edges / max(ref_edges, 1)


def fd_excess(reduced: torch.Tensor, a: torch.Tensor) -> float:
    """``reduced`` (n, l): the sketch's transpose; ``a`` (n, n) the graph."""
    b = reduced.double().T
    norms = torch.linalg.norm(b, dim=1)
    live = norms > 0
    if not bool(live.any()):
        return float("inf")
    x = b[live] / norms[live, None]
    bx = (b @ x.T).pow(2).sum(dim=0)
    ax = (a.double() @ x.T).pow(2).sum(dim=0)
    top = torch.linalg.matrix_norm(b, ord=2) ** 2
    return float(((bx - ax) / top).max())


def fd_deficit(reduced: torch.Tensor, a: torch.Tensor, ell: int) -> float:
    """``reduced`` (n, l): the sketch's transpose; ``a`` (n, n) the
    reference's graph; ``ell`` the sketch's rows as configured."""
    b = reduced.double().T
    a = a.double()
    top = torch.linalg.eigvalsh(a.T @ a - b.T @ b)[-1]
    return float(top / (a.pow(2).sum() / ell))


def top_energy(a_mul, at_mul, n: int, r: int, *, device) -> float:
    """Sum of the top ``r`` squared singular values of A, from float64
    subspace iteration: 2 r columns and 6 power steps (the program's SVD
    takes r + 8 and 2).  ``a_mul`` / ``at_mul`` return A v / A^T v."""
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.linalg.qr(a_mul(torch.randn((n, min(n, 2 * r)), generator=gen, device=device,
                                          dtype=torch.float64)))[0]
    for _ in range(6):
        q = torch.linalg.qr(a_mul(torch.linalg.qr(at_mul(q))[0]))[0]
    s = torch.linalg.svdvals(at_mul(q))
    return float(s[:r].pow(2).sum())


def svd_energy_gap(reduced: torch.Tensor, ref_energy: float) -> float:
    """``reduced`` (n, r) = U S; ``ref_energy`` the reference's top-r energy."""
    if ref_energy <= 0:
        return float("inf")
    return 1.0 - float(reduced.double().pow(2).sum()) / ref_energy


def svd_identity(reduced: torch.Tensor, at_mul) -> float:
    """``reduced`` (n, r) = U S; ``at_mul(v)`` returns A^T v in float64."""
    u = reduced.double()
    s = torch.linalg.norm(u, dim=0)
    live = s > 0
    if not bool(live.any()):
        return float("inf")
    u = u[:, live] / s[live]
    w = torch.linalg.norm(at_mul(u), dim=0)
    return float((torch.abs(w - s[live]) / s.max()).max())


def _cost(x: torch.Tensor, labels: torch.Tensor, k: int) -> float:
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, labels, x)
    counts = torch.bincount(labels, minlength=k).to(x.dtype)
    cent = sums / torch.clamp(counts, min=1)[:, None]
    return float(((x - cent[labels]) ** 2).sum())


def _lloyd_from(x: torch.Tensor, labels: torch.Tensor, k: int, iters: int = 100) -> float:
    """Cost after Lloyd's steps started from the partition ``labels``."""
    for _ in range(iters):
        sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
        sums.index_add_(0, labels, x)
        counts = torch.bincount(labels, minlength=k).to(x.dtype)
        live = counts > 0
        cent = sums[live] / counts[live, None]
        new = torch.argmin(torch.cdist(x, cent), dim=1)
        k = int(live.sum())
        if bool(torch.equal(new, labels)):
            break
        labels = new
    return _cost(x, labels, k)


def label_cost_excess(labels: np.ndarray, emb: torch.Tensor) -> float:
    keep = labels != -1
    if not keep.any():
        return float("inf")
    _, dense = np.unique(labels[keep], return_inverse=True)
    k = int(dense.max()) + 1
    if k == 1:
        return 0.0
    x = emb.double()[torch.as_tensor(keep, device=emb.device)]
    lab = torch.as_tensor(dense, device=emb.device)
    return _cost(x, lab, k) / max(_lloyd_from(x, lab, k), 1e-300) - 1.0
