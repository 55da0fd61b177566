"""The readers that per-layer metrics share.  Each metric's file under
``portbench/metrics/`` binds ``read`` to one of these; the kernels a
roofline or a launch count sums are named here once for every cell."""
from __future__ import annotations

# csrc/knn_adjacency.cu
K1_KERNELS = ("sim_keys_kernel", "coord_keys_kernel", "row_stats_kernel",
              "radix_select_kernel")
# csrc/blocked_select.cu: every route of the binned candidates (K2) and pairs (K3)
K23_KERNELS = ("binned_postings_kernel", "binned_mma_kernel", "binned_mma_pair_kernel",
               "binned_coord_kernel", "binned_simple_kernel")


def idle_pct(run):
    """Share of the traced window (%) in which nothing ran on the device: 1
    less the union of its kernel, copy and set intervals over the window's
    wall time."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def syncs_per_window(run):
    """Host waits on the device per stream window: what
    ``torch.cuda.set_sync_debug_mode("warn")`` reports plus every
    synchronize call, over the traced window (the benchmark timer's own
    waits left out)."""
    if run.syncs is None or not run.windows:
        return None
    return run.syncs / run.windows


def _roofline(run, bound_s, kernels):
    if run.trace is None or bound_s is None:
        return None
    t = run.trace.seconds_of(kernels)
    return 100.0 * bound_s / t if t > 0 else None


def k1_roofline(run):
    """K1's share of its roofline (%): the bound counted from every measured
    window's inputs (``portbench/roofline``) over the device seconds of
    :data:`K1_KERNELS`."""
    return _roofline(run, run.k1_bound_s, K1_KERNELS)


def k23_roofline(run):
    """K2 and K3's share of their roofline (%): the bound of computing every
    row block's binned candidates once, counted from the inputs, over the
    device seconds of every launch of :data:`K23_KERNELS`.  A route that
    computes a block's candidates more than once reads lower; the launch
    count (:func:`k23_launches`) says how often."""
    return _roofline(run, run.k23_bound_s, K23_KERNELS)


def k23_launches(run):
    """Launches of :data:`K23_KERNELS` per stream window, or per call where
    the cell's unit of work is a call."""
    per = run.windows or run.attempted
    if run.trace is None or not per:
        return None
    n = run.trace.launches_of(K23_KERNELS)
    return n / per if n else None
