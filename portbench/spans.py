"""The readers of the program's own spans and counters.

While the traced window's profiler runs, the program records spans and
counters (``mused_tpu_torch/utils/profiling``: ``recorded()``), each with a
name, a ``key`` (the stream window index or the batch call number),
``start_ns`` / ``end_ns`` and, for spans timed on the device,
``device_ms``.  Each per-layer metric's file under ``portbench/metrics/``
binds ``read`` to one of the readers here.  Serving's readers sum a
window's spans of one name and give the median over windows; the others
give the mean per stream window or per call: the total over the run's
windows (``run.windows``) or, where the unit is a call, its calls
(``run.attempted``), since a huge window's key repeats in every call of
``process_streaming_data``.  A program that records nothing (one without
the recorder) makes every reader return None.
"""
from __future__ import annotations

import collections
import statistics


def program_records() -> list:
    """What the program recorded, or [] where it has no recorder."""
    try:
        from mused_tpu_torch.utils.profiling import recorded
    except ImportError:
        return []
    return recorded()


def host_ms(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-6


def device_ms(r) -> float | None:
    return r.device_ms


def per_key(records, name: str, value=host_ms) -> dict:
    """{key: sum of ``value`` over the records named ``name``}; records whose
    value is None are left out."""
    out: dict = collections.defaultdict(float)
    for r in records:
        if r.name == name:
            v = value(r)
            if v is not None:
                out[r.key] += v
    return dict(out)


def p50_per_key(records, name: str, value=host_ms) -> float | None:
    """Median over keys of the per-key sums (None without records)."""
    sums = per_key(records, name, value)
    return float(statistics.median(sums.values())) if sums else None


def mean_per_unit(records, name: str, units: int, value=host_ms) -> float | None:
    """Total of ``value`` over the records named ``name``, per unit (None
    without records or units)."""
    sums = per_key(records, name, value)
    return float(sum(sums.values()) / units) if sums and units else None


def counted(name: str):
    """The value of a counter record named ``name``."""
    return lambda r: (r.counters or {}).get(name)


def _units(run) -> int:
    return run.windows or run.attempted


def serving_p50(name: str):
    def read(run):
        return p50_per_key(program_records(), name)
    read.__doc__ = f"Median over windows of the summed ``{name}`` spans (ms)."
    return read


def mean_ms(name: str, value=host_ms):
    def read(run):
        return mean_per_unit(program_records(), name, _units(run), value)
    read.__doc__ = f"Mean ``{name}`` milliseconds per stream window or call."
    return read


def mean_count(name: str):
    def read(run):
        return mean_per_unit(program_records(), name, _units(run), counted(name))
    read.__doc__ = f"Mean ``{name}`` count per stream window or call."
    return read


# w2000-serve: the window's life from fire to return, and its five parts
serving_window_ms = serving_p50("serving.window")
serving_queue_wait_ms = serving_p50("serving.queue_wait")
serving_featurize_ms = serving_p50("featurize")
serving_enqueue_ms = serving_p50("engine.enqueue")
serving_held_ms = serving_p50("serving.held")
serving_finalize_ms = serving_p50("serving.finalize")
# w100k-svd: the prefetcher's featurize, the loop's wait on it, the allocator
huge_featurize_ms = mean_ms("featurize")
huge_ingest_wait_ms = mean_ms("ingest.wait")
huge_device_allocs = mean_count("memory.device_allocs")
# b150k-batch: the call's layers; the columns and the SVD on the device's clock
batch_featurize_ms = mean_ms("featurize")
batch_columns_ms = mean_ms("engine.columns", device_ms)
batch_reduce_ms = mean_ms("engine.reduce", device_ms)
batch_cluster_ms = mean_ms("engine.cluster")
batch_metrics_ms = mean_ms("match.metrics")
