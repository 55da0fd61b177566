"""Mean device milliseconds of one product sweep of blocked spectral
clustering: the ``spectral.sweep`` spans' device extents over the
``spectral.sweeps`` count, both of the whole traced window."""
from portbench import spans


def read(run):
    recs = spans.program_records()
    ms = sum(spans.per_key(recs, "spectral.sweep", spans.device_ms).values())
    n = sum(spans.per_key(recs, "spectral.sweeps", spans.counted("spectral.sweeps")).values())
    return ms / n if ms and n else None
