"""Median window latency (ms): from the due time of a window's last record
to the return of its events, over every window of the run (the
benchmark's own stamps, as for the p95)."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_ms, 50)) if run.latencies_ms else None
