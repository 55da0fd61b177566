"""Plain kNN graphs of a window, from its featurized records.

Each modality links a row to its k most similar other rows (self and
invalid columns excluded, ties to the lowest column first, invalid rows
link nothing): location by the chord between unit vectors (ranks like the
great-circle distance), k = k_basis; time by |d taken| + |d upload|,
3 k_basis; tags by Jaccard over the hashed tag sets, k_basis; text by the
cosine of TF-IDF rows (sklearn's smooth idf over the window's rows that
hold text), k_basis.  Username links every pair of rows with the same
name.  The fused graph is their union (reference matrix_operations.py:14-141).

Huge windows select each row's neighbours from stride bins: with
``nbins`` bins, column c = g * nbins + s falls in bin s, each bin keeps its
most similar column (lowest g on ties), and the k best bins are kept, ties
in bin order.  On those windows the text rows are rounded to bfloat16 after
normalization, the precision the configuration states for them.

Similarities are computed in ``dtype``: float64 for the reference, float32
(with TF32 products when the caller enables them) for the control.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.features import Records, token_arrays


class Panels:
    """A window's features as dense device tensors."""

    def __init__(self, rec: Records, *, tags_hash_dim: int, text_hash_dim: int, device,
                 dtype=torch.float64, text_bf16: bool = False):
        n = len(rec.latlon)
        self.n, self.device = n, device
        t = lambda a, dt=None: torch.as_tensor(a, device=device, dtype=dt)  # noqa: E731
        rad = np.deg2rad(np.where(rec.loc_valid[:, None], rec.latlon, 0.0).astype(np.float64))
        xyz = np.stack([np.cos(rad[:, 0]) * np.cos(rad[:, 1]),
                        np.cos(rad[:, 0]) * np.sin(rad[:, 1]), np.sin(rad[:, 0])], axis=1)
        self.xyz = t(xyz, dtype)
        self.times = t(rec.times.astype(np.float64), dtype)
        self.loc_valid, self.time_valid = t(rec.loc_valid), t(rec.time_valid)
        self.users = t(rec.users)
        self.user_valid = self.users >= 0
        self.tags_valid = t(rec.tags_valid)

        r, b, c = token_arrays(rec.tags, with_counts=False)
        tags = torch.zeros((n, tags_hash_dim), dtype=dtype, device=device)
        tags[t(r), t(b)] = 1.0
        self.tags, self.tag_sizes = tags, tags.sum(dim=1)

        r, b, c = token_arrays(rec.words, with_counts=True)
        # the text panel is built in float32 (the configuration's precision)
        counts = torch.zeros((n, text_hash_dim), dtype=torch.float32, device=device)
        counts[t(r), t(b)] = t(c, torch.float32)
        self.text_valid = counts.sum(dim=1) > 0
        n_docs = torch.clamp(self.text_valid.float().sum(), min=1.0)
        df = ((counts > 0) & self.text_valid[:, None]).sum(dim=0).float()
        idf = torch.log((1.0 + n_docs) / (1.0 + df)) + 1.0
        x = counts * idf[None, :]
        x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
        if text_bf16:
            x = x.to(torch.bfloat16)
        self.text = x.to(dtype)

    # (m, n) similarities of rows [lo, hi) against every row
    def sim(self, modality: str, lo: int, hi: int) -> torch.Tensor:
        if modality in ("location", "time"):
            x = self.xyz if modality == "location" else self.times
            acc = None
            for c in range(x.shape[1]):
                d = x[lo:hi, c, None] - x[None, :, c]
                d = d * d if modality == "location" else torch.abs(d)
                acc = d if acc is None else acc + d
            return -acc
        if modality == "tags":
            inter = self.tags[lo:hi] @ self.tags.T
            union = self.tag_sizes[lo:hi, None] + self.tag_sizes[None, :] - inter
            return torch.where(union > 0, inter / torch.clamp(union, min=1e-9),
                               torch.zeros_like(inter))
        if modality == "text":
            return self.text[lo:hi] @ self.text.T
        raise ValueError(f"no similarity for modality {modality!r}")

    def valid(self, modality: str) -> torch.Tensor:
        return {"location": self.loc_valid, "time": self.time_valid, "tags": self.tags_valid,
                "text": self.text_valid, "username": self.user_valid}[modality]

    def username(self, lo: int, hi: int) -> torch.Tensor:
        v = self.user_valid
        same = (self.users[lo:hi, None] == self.users[None, :]) & v[lo:hi, None] & v[None, :]
        return same & ~_self_mask(lo, hi, self.n, self.device)


KNN_MODALITIES = ("location", "time", "tags", "text")


def k_of(modality: str, k_basis: int) -> int:
    return 3 * k_basis if modality == "time" else k_basis


def _self_mask(lo: int, hi: int, n: int, device) -> torch.Tensor:
    return (lo + torch.arange(hi - lo, device=device))[:, None] \
        == torch.arange(n, device=device)[None, :]


def _masked(p: Panels, modality: str, lo: int, hi: int) -> torch.Tensor:
    s = p.sim(modality, lo, hi)
    drop = ~p.valid(modality)[None, :] | _self_mask(lo, hi, p.n, p.device)
    return s.masked_fill(drop, float("-inf"))


def knn_rows(p: Panels, modality: str, lo: int, hi: int, k: int) -> torch.Tensor:
    """(hi - lo, n) bool: each row's k most similar columns, exactly."""
    s = _masked(p, modality, lo, hi)
    k = max(0, min(k, p.n - 1))
    out = torch.zeros(s.shape, dtype=torch.bool, device=p.device)
    if k == 0:
        return out
    idx = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    out.scatter_(1, idx, torch.gather(s, 1, idx) > float("-inf"))
    return out & p.valid(modality)[lo:hi, None]


def dense_graphs(p: Panels, k_basis: int) -> dict:
    """{modality: (n, n) bool} for the four kNN modalities and username."""
    out = {m: knn_rows(p, m, 0, p.n, k_of(m, k_basis)) for m in KNN_MODALITIES}
    out["username"] = p.username(0, p.n)
    return out


def binned_rows(p: Panels, modality: str, lo: int, hi: int, k: int, nbins: int) -> torch.Tensor:
    """(hi - lo, n) bool: the k best of each row's ``nbins`` stride bins."""
    s = _masked(p, modality, lo, hi)
    m = hi - lo
    # torch.max over a dim returns the first maximal index: the lowest group
    vals, grp = torch.max(s.reshape(m, p.n // nbins, nbins), dim=1)
    k = max(0, min(k, p.n - 1, nbins))
    out = torch.zeros((m, p.n), dtype=torch.bool, device=p.device)
    if k == 0:
        return out
    thr = torch.topk(vals, k, dim=1).values[:, -1:]
    real = vals > float("-inf")
    above = (vals > thr) & real
    tie = (vals == thr) & real
    budget = k - above.sum(dim=1, keepdim=True)
    keep = (above | (tie & (torch.cumsum(tie.long(), dim=1) <= budget)))
    keep &= p.valid(modality)[lo:hi, None]
    cols = grp * nbins + torch.arange(nbins, device=p.device)[None, :]
    r = torch.arange(m, device=p.device)[:, None].expand(m, nbins)
    out[r[keep], cols[keep]] = True
    return out


def binned_block(p: Panels, lo: int, hi: int, k_basis: int, nbins: int) -> torch.Tensor:
    """(hi - lo, n) bool fused rows of a huge window: the binned kNN of the
    four modalities and the username links."""
    out = p.username(lo, hi)
    for m in KNN_MODALITIES:
        out |= binned_rows(p, m, lo, hi, k_of(m, k_basis), nbins)
    return out


def packbits(x: torch.Tensor) -> torch.Tensor:
    """(m, n) bool -> (m, n / 8) uint8, bit j of byte b is column 8 b + j."""
    w = (1 << torch.arange(8, device=x.device, dtype=torch.int32))
    return (x.reshape(x.shape[0], -1, 8).to(torch.int32) * w).sum(dim=2).to(torch.uint8)


def unpackbits(x: torch.Tensor) -> torch.Tensor:
    s = torch.arange(8, device=x.device, dtype=torch.int32)
    return ((x.to(torch.int32)[..., None] >> s) & 1).reshape(x.shape[0], -1).bool()


def popcount(x: torch.Tensor) -> int:
    """Set bits in a uint8 tensor."""
    table = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64,
                         device=x.device)
    return int(table[x.long()].sum())
