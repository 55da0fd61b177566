"""The least time the card could take for a kernel's work, counted from a
window's inputs.

A frozen restatement of ``chip_smoke.py``'s bound arithmetic (``bound``,
``k1_bound``, ``k2_postings_bound``, ``coord_bound``, at commit 8a4150f),
counted from the featurized records instead of from structures the program
built, so that the bound stays the same whatever route computes the work:

* text and tags by the nonzero rule: 2 operations (a float32 multiply-add)
  per postings entry that the rows' features meet, at the float32 peak;
  bytes of the rows' nonzeros (index and value), of the postings entries
  and table rows of the features met, of the columns' validity and
  statistics, and of the output;
* location and time by instructions per (row, column) pair
  (``COORD_INSTR_PER_PAIR``) at the float32 issue rate, with the bytes of
  the coordinates and the output.

Bound = max(operations / peak, bytes / memory rate) per launch; a set of
launches is bounded by the sum of theirs.  Peaks are an H100 SXM's at 700 W
(NVIDIA's data sheet): a card set to a lower power limit reads a lower share.
"""
from __future__ import annotations

import numpy as np

from portbench.reference.features import Records, token_arrays

PEAK_OPS = {"fp32": 67e12, "fp32_instr": 33.5e12}
HBM_BYTES_PER_S = 3.35e12
# chord3: 3 sub + 3 mul + 2 add; l1: 2 sub + 1 add; each with a compare and 2 selects
COORD_INSTR_PER_PAIR = {"chord3": 11, "l1": 6}
COORDS = {"chord3": 3, "l1": 2}
POSTINGS_UNIT = 128          # columns per postings table step


def bound_s(ops: float, peak: str, nbytes: float) -> float:
    return max(ops / PEAK_OPS[peak], nbytes / HBM_BYTES_PER_S)


class TokenStats:
    """Per-feature document frequencies of a token modality and its rows."""

    def __init__(self, rows: list, with_counts: bool, n: int):
        r, b, _ = token_arrays(rows, with_counts)
        self.rows, self.feats, self.n = r, b, n
        dim = int(b.max()) + 1 if len(b) else 1
        self.df = np.bincount(b, minlength=dim).astype(np.float64)

    def block(self, lo: int, hi: int) -> dict:
        """What rows [lo, hi) meet: postings entries, row terms, features."""
        sel = (self.rows >= lo) & (self.rows < hi)
        cnt = np.bincount(self.feats[sel], minlength=len(self.df)).astype(np.float64)
        met = cnt > 0
        return {"entries_met": float((cnt * self.df).sum()), "row_terms": float(sel.sum()),
                "features_met": float(met.sum()),
                "postings_of_features_met": float(self.df[met].sum())}


def postings_bound_s(stats: TokenStats, lo: int, hi: int, *, value_bytes: int, n: int,
                     out_bytes: float, with_stats: bool) -> float:
    met = stats.block(lo, hi)
    steps = -(-n // POSTINGS_UNIT) + 1
    nbytes = (met["row_terms"] * (4 + value_bytes)
              + met["postings_of_features_met"] * (4 + value_bytes)
              + met["features_met"] * steps * 4 + n + out_bytes)
    if with_stats:
        nbytes += (n + (hi - lo)) * 4
    return bound_s(2.0 * met["entries_met"], "fp32", nbytes)


def coord_bound_s(metrics: list, n: int, rows: int, out_bytes: float) -> float:
    instr = sum(COORD_INSTR_PER_PAIR[m] for m in metrics) * float(rows) * n
    nbytes = sum((n + rows) * COORDS[m] * 4 + n for m in metrics) + out_bytes
    return bound_s(instr, "fp32_instr", nbytes)


def k1_window_s(rec: Records, k_basis: int) -> float:
    """K1's four calls on one dense window: location, time, tags, text.  The
    output counted is each row's k neighbour indices, the least any route
    must write."""
    n = len(rec.latlon)
    out = lambda k: n * min(k, n - 1) * 4.0      # noqa: E731
    tags = TokenStats(rec.tags, False, n)
    text = TokenStats(rec.words, True, n)
    return (coord_bound_s(["chord3"], n, n, out(k_basis))
            + coord_bound_s(["l1"], n, n, out(3 * k_basis))
            + postings_bound_s(tags, 0, n, value_bytes=4, n=n, out_bytes=out(k_basis),
                               with_stats=True)
            + postings_bound_s(text, 0, n, value_bytes=4, n=n, out_bytes=out(k_basis),
                               with_stats=False))


def k23_window_s(rec: Records, *, block: int, nbins: int) -> float:
    """K2 (text, tags) and K3 (location + time) over every row block of a
    huge window or blocked batch, once: the binned candidates, (block,
    nbins) float32 values and int8 groups per metric.  A route that
    computes a block's candidates again (the blocked SVD's sweeps) does the
    same work again: its time counts, its work does not."""
    n = len(rec.latlon)
    out = block * nbins * 5.0
    tags = TokenStats(rec.tags, False, n)
    text = TokenStats(rec.words, True, n)
    total = 0.0
    for lo in range(0, n, block):
        hi = lo + block
        total += (postings_bound_s(text, lo, hi, value_bytes=2, n=n, out_bytes=out,
                                   with_stats=False)
                  + postings_bound_s(tags, lo, hi, value_bytes=1, n=n, out_bytes=out,
                                     with_stats=True)
                  + coord_bound_s(["chord3", "l1"], n, block, 2 * out))
    return total
