"""Mean milliseconds of the engine's "reduce" span per huge window: the
blocked randomized SVD's sweeps (ops/blocked_affinity, ops/reduction), with a
timer that waits for the device at each span's end in the traced run."""


def read(run):
    xs = run.spans.get("reduce")
    return 1e3 * sum(xs) / len(xs) if xs else None
