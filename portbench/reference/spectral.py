"""Plain reference of a huge window of embedding modalities under blocked
spectral clustering, and the numbers that decide ``correct`` there.

The graph.  Each embedding modality is normalized in float32 (rows with a
non-finite entry or a zero norm are invalid and link nothing) and rounded
to bfloat16, the precision the configuration states for its panels; its
cosine kNN rows are the k_basis best of each row's stride bins
(:func:`graphs.binned_rows`), on those rounded rows with float64 products.
A window's fused graph A is the union of its modalities' rows, built once
as a sparse float64 matrix from row blocks (:class:`Graph`).

The operator.  M = D^-1/2 (A + A^T)/2 D^-1/2, with D the degrees of
(A + A^T)/2 (rows of degree 0 scale to 0), and its top eigenvalues by
float64 subspace iteration with Rayleigh-Ritz, run until they settle
(:func:`top_eigenvalues`).

The numbers (each in float64), for the Ritz vectors r_i and values l_i
that the timed path returned, of which the first c are live (the count
the clustering took):

* ``ritz_identity``: the largest |r_i^T M r_i / r_i^T r_i - l_i| / l_1
  over the live ones, with M built (:class:`Graph`) from the row blocks
  the program rebuilt, so that the product alone is held to it, as
  ``judge.svd_identity`` holds the SVD to the program's graph; the graph
  is held to the reference's by ``graph_mismatch``.  A Ritz pair satisfies
  it whatever probe the iteration started from; products computed in a
  lower precision, or with rows missing, do not.
* ``ritz_energy_gap``: 1 - sum of the live l_i over the sum of the
  reference's top c eigenvalues.  Subspace iteration approaches them from
  below; products that miss part of the graph fall far short.
"""
from __future__ import annotations

import torch

from portbench.reference import graphs


class EmbeddingPanels:
    """A window's embedding modalities as the kNN reference reads them:
    ``sim`` / ``valid`` / ``n`` / ``device``, as :class:`graphs.Panels`,
    with the modality given by its position."""

    def __init__(self, mats, device):
        self.xs, self.valids = [], []
        for m in mats:
            m = torch.as_tensor(m, dtype=torch.float32).to(device)
            finite = torch.all(torch.isfinite(m), dim=1)
            safe = torch.where(finite[:, None], m, 0.0)
            norm = torch.linalg.norm(safe, dim=1, keepdim=True)
            x = safe / torch.clamp(norm, min=1e-12)
            self.xs.append(x.to(torch.bfloat16).to(torch.float64))
            self.valids.append(finite & (norm[:, 0] > 0))
        self.n = self.xs[0].shape[0]
        self.device = torch.device(device)

    def sim(self, modality: int, lo: int, hi: int) -> torch.Tensor:
        x = self.xs[modality]
        return x[lo:hi] @ x.T

    def valid(self, modality: int) -> torch.Tensor:
        return self.valids[modality]


def fused_block(p: EmbeddingPanels, lo: int, hi: int, k_basis: int,
                nbins: int) -> torch.Tensor:
    """(hi - lo, n) bool fused rows: the union of every modality's binned
    kNN rows."""
    out = None
    for m in range(len(p.xs)):
        rows = graphs.binned_rows(p, m, lo, hi, k_basis, nbins)
        out = rows if out is None else out | rows
    return out


class Graph:
    """A 0/1 (n, n) graph assembled from row blocks, and its normalized
    symmetric operator M as a float64 CSR matrix (:meth:`operator`)."""

    def __init__(self, n: int, device):
        self.n, self.device = n, device
        self.rows, self.cols = [], []

    def add(self, lo: int, block: torch.Tensor) -> None:
        r, c = torch.nonzero(block, as_tuple=True)
        self.rows.append(r + lo)
        self.cols.append(c)

    def operator(self) -> torch.Tensor:
        r, c = torch.cat(self.rows), torch.cat(self.cols)
        del self.rows, self.cols
        half = torch.full((2 * len(r),), 0.5, dtype=torch.float64, device=self.device)
        sym = torch.sparse_coo_tensor(torch.stack([torch.cat([r, c]), torch.cat([c, r])]),
                                      half, (self.n, self.n),
                                      check_invariants=False).coalesce()
        i, j = sym.indices()
        deg = torch.zeros(self.n, dtype=torch.float64, device=self.device)
        deg.index_add_(0, i, sym.values())
        inv_sqrt = torch.where(deg > 0, deg.clamp(min=1e-300).rsqrt(), 0.0)
        vals = sym.values() * inv_sqrt[i] * inv_sqrt[j]
        return torch.sparse_coo_tensor(sym.indices(), vals, (self.n, self.n),
                                       check_invariants=False).coalesce().to_sparse_csr()


def top_eigenvalues(m: torch.Tensor, k: int, *, extra: int = 64, tol: float = 1e-12,
                    max_iter: int = 500) -> torch.Tensor:
    """The ``k`` largest eigenvalues of the symmetric operator ``m``
    (descending, float64): subspace iteration on k + ``extra`` columns from
    a fixed Gaussian start, Rayleigh-Ritz at every step, until the top k
    move by less than ``tol`` (relative) from one step to the next."""
    n = m.shape[0]
    gen = torch.Generator(device=m.device).manual_seed(0)
    q = torch.linalg.qr(torch.randn((n, min(n, k + extra)), generator=gen, device=m.device,
                                    dtype=torch.float64))[0]
    prev = None
    for _ in range(max_iter):
        z = m @ q
        t = q.T @ z
        lam = torch.flip(torch.linalg.eigvalsh(0.5 * (t + t.T)), (0,))[:k]
        if prev is not None and float((lam - prev).abs().max()) <= tol * float(lam.abs().max()):
            break
        prev = lam
        q = torch.linalg.qr(z)[0]
    return lam


def ritz_from_probe(m: torch.Tensor, probe: torch.Tensor, n_iter: int = 6):
    """Subspace iteration on ``m`` from ``probe`` (n, c) for ``n_iter``
    steps, then Rayleigh-Ritz: (Ritz vectors, values), descending, in
    float64: the steps blocked spectral clustering takes."""
    v = probe.double()
    for _ in range(n_iter):
        v = torch.linalg.qr(m @ v)[0]
    t = v.T @ (m @ v)
    lam, w = torch.linalg.eigh(0.5 * (t + t.T))
    return v @ torch.flip(w, (1,)), torch.flip(lam, (0,))


def rayleigh(m: torch.Tensor, ritz: torch.Tensor) -> torch.Tensor:
    """r_i^T M r_i / r_i^T r_i of each column r_i, in float64."""
    r = ritz.double()
    return (r * (m @ r)).sum(dim=0) / (r * r).sum(dim=0).clamp(min=1e-300)


def ritz_identity(m: torch.Tensor, ritz: torch.Tensor, lam: torch.Tensor, live: int) -> float:
    """Largest |r_i^T M r_i / |r_i|^2 - l_i| / l_1 over the ``live`` pairs."""
    if live < 1 or float(lam[0]) <= 0:
        return float("inf")
    q = rayleigh(m, ritz[:, :live])
    return float(((q - lam[:live].double()).abs() / float(lam[0])).max())


def ritz_energy_gap(lam: torch.Tensor, ref_top: torch.Tensor, live: int) -> float:
    """1 - sum of the ``live`` Ritz values over the reference's top ``live``."""
    ref = float(ref_top[:live].sum())
    if live < 1 or ref <= 0:
        return float("inf")
    return 1.0 - float(lam[:live].double().sum()) / ref
