"""Run one benchmark cell on this machine's card(s) and print its result.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the check compared,
beside its limit.  The same comparisons are the last lines of standard
error.  Without a CUDA device, or with fewer than the cell asks for, it
prints no result and exits 2; if JAX or the JAX package was loaded, 3.
Every cache of the program's builds lives under ``.portbench_cache/`` in
the checkout (the nvcc builds in the program's own ``_build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness
    cell = harness.resolve(args.workload)
    try:
        out = harness.run_cell(cell, args.seed % 2**63, args.seconds, bool(args.trace),
                               t_start=T_START)
    except SystemExit as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    banned = harness.banned_modules()
    if banned:
        print(f"no result: the process loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    print(f"card: {out['device']['kind']}, {out['device'].get('power_limit')}",
          file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
