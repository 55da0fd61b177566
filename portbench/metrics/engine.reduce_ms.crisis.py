"""Mean milliseconds of the engine's "reduce" span per huge window: blocked
spectral clustering's degree and product sweeps and its Ritz steps
(ops/blocked_spectral), with a timer that waits for the device at each
span's end in the traced run."""


def read(run):
    xs = run.spans.get("reduce")
    return 1e3 * sum(xs) / len(xs) if xs else None
