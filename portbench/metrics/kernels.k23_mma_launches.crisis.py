"""Launches of K2 / K3's tensor-core tiles per stream window."""
from portbench.roofline import mma_counts


def read(run):
    if run.trace is None or not run.windows:
        return None
    n = run.trace.launches_of((mma_counts.MMA_KERNEL, mma_counts.MMA_PAIR_KERNEL))
    return n / run.windows if n else None
