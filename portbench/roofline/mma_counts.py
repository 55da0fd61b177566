"""The least time the card could take for K2 / K3's tensor-core tiles, the
route that dense panels (embeddings, ``default_safe``) take.

The tile program (``binned_mma_kernel``, and ``binned_mma_pair_kernel``
for two tensor-core panels in one launch) computes every (row, column)
product of a plane, so its work is the dense count: 2 · rows · n · K
operations per plane (a multiply-add per feature) at the bf16 tensor-core
peak, against its bytes: the bf16 column panel and rows read once, the
columns' validity, and the (rows, nbins) float32 values and int8 groups
written.  Bound = max(operations / peak, bytes / memory rate) per plane; a
launch of the pair computes two planes.  Peaks are an H100 SXM's at 700 W
(NVIDIA's data sheet), as in ``counts.py``.
"""
from __future__ import annotations

from portbench.roofline.counts import HBM_BYTES_PER_S

BF16_PEAK_OPS = 989e12
MMA_KERNEL = "binned_mma_kernel"           # one plane a launch
MMA_PAIR_KERNEL = "binned_mma_pair_kernel"  # two planes a launch


def plane_bound_s(rows: int, n: int, k: int, nbins: int) -> float:
    """One plane: ``rows`` rows of a bf16 panel of ``k`` features against
    its ``n`` columns, binned into ``nbins`` bins."""
    ops = 2.0 * rows * n * k
    nbytes = (n + rows) * k * 2.0 + n + rows * nbins * 5.0
    return max(ops / BF16_PEAK_OPS, nbytes / HBM_BYTES_PER_S)


def planes(trace) -> int:
    """Planes the traced tensor-core launches computed."""
    return trace.launches_of((MMA_KERNEL,)) + 2 * trace.launches_of((MMA_PAIR_KERNEL,))


def device_s(trace) -> float:
    return trace.seconds_of((MMA_KERNEL, MMA_PAIR_KERNEL))
