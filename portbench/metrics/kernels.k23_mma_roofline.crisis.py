"""K2 / K3's tensor-core tiles' share of their roofline (%): the planes the
traced launches computed times one plane's bound (``portbench/roofline/
mma_counts.py``, the dense count at the bf16 peak) over the launches'
summed device time."""
from portbench.roofline import mma_counts


def read(run):
    bound = getattr(run, "mma_plane_bound_s", None)
    if run.trace is None or not bound:
        return None
    t = mma_counts.device_s(run.trace)
    return 100.0 * mma_counts.planes(run.trace) * bound / t if t > 0 else None
