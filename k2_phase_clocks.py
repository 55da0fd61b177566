#!/usr/bin/env python3
"""Where a CTA of K2's postings route spends its time, on one GPU.

    python3 k2_phase_clocks.py

Builds a copy of ``mused_tpu_torch/csrc/blocked_select.cu`` in which thread 0
of every CTA of ``binned_postings_kernel`` adds the SM clock cycles
(``clock64``) of each phase of its row to a device counter, runs K2 on the
postings route for the tags and text panels of the first 2048-row block of
``chip_smoke.py``'s huge window (n = 98,304, nbins 1536), and prints the
mean cycles per CTA and the share of each phase: the prologue (zeroing, the
row's term extraction), the next step's table entries, the validity loads,
the accumulation (warp 0's share of the step's postings), the wait at the
first barrier, the epilogue and the wait at the second barrier.  The copy
is built in a temporary directory; the repository's library is untouched.
The counters serialize nothing but cost a few cycles per phase, so the
kernel's time is printed beside them.
"""
import ctypes
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.ops.kernels import build

PHASES = ("prologue", "next step's table entries", "validity loads", "accumulate (warp 0)",
          "barrier 1", "epilogue", "barrier 2")

# (anchor in the source, what replaces it): the counters, and a mark after each phase
PATCH = [
    ("constexpr int kPostThreads = 256;",
     "__device__ unsigned long long post_clocks[8];\n"
     "#define MARK(i) do { if (threadIdx.x == 0) { const long long t_ = clock64(); "
     "atomicAdd(&post_clocks[i], (unsigned long long)(t_ - t_prev)); t_prev = t_; } } "
     "while (0)\nconstexpr int kPostThreads = 256;"),
    ("                         uint8_t* smem) {\n",
     "                         uint8_t* smem) {\n  long long t_prev = clock64();\n"),
    ("  const bool whole = next >= h.k;", "  MARK(0);\n  const bool whole = next >= h.k;"),
    ("    const int self = grow - cbase;", "    MARK(1);\n    const int self = grow - cbase;"),
    ("    for (int f = 0;;) {", "    MARK(2);\n    for (int f = 0;;) {"),
    ("    __syncthreads();\n    // epilogue, two slots",
     "    MARK(3);\n    __syncthreads();\n    MARK(4);\n    // epilogue, two slots"),
    ("    __syncthreads();\n    lo = lo_n;",
     "    MARK(5);\n    __syncthreads();\n    MARK(6);\n    lo = lo_n;"),
    ('}  // extern "C"',
     "int mused_post_clocks(void* out) {\n"
     "  const cudaError_t e = cudaMemcpyFromSymbol(out, post_clocks, sizeof(post_clocks));\n"
     "  unsigned long long zero[8] = {0};\n"
     "  cudaMemcpyToSymbol(post_clocks, zero, sizeof(zero));\n"
     "  return static_cast<int>(e);\n}\n}  // extern \"C\""),
]


def instrumented_library():
    """Build the patched sources in a temporary directory and load them."""
    src = open(os.path.join(build.CSRC, "blocked_select.cu")).read()
    for anchor, repl in PATCH:
        if src.count(anchor) != 1:
            raise AssertionError(f"the kernel source changed: {anchor!r} is not unique")
        src = src.replace(anchor, repl)
    tmp = tempfile.mkdtemp(prefix="k2_phase_clocks_")
    for name in os.listdir(build.CSRC):
        if name.endswith(".cu"):
            shutil.copy(os.path.join(build.CSRC, name), tmp)
    with open(os.path.join(tmp, "blocked_select.cu"), "w") as f:
        f.write(src)
    build.CSRC, build.BUILD_DIR, build._lib = tmp, os.path.join(tmp, "_build"), None
    lib = build.load()
    lib.mused_post_clocks.argtypes = [ctypes.c_void_p]
    lib.mused_post_clocks.restype = ctypes.c_int
    return lib, tmp


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_phase_clocks: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    mods, _, _ = cs.make_stream(cs.HUGE_WINDOW, noise_rate=cs.NOISE_RATE, binary=True,
                                sort_by_uploaded=True, seed=cs.SEED)
    cols = cs.huge_columns(mods, dev)
    by = dict(zip(cols.kinds, zip(cols.tensors, cols.valids, cols.postings_of())))
    (tags, sums), tagv, ptags = by["tags"]
    text, textv, ptext = by["text_bf16"]
    block, nbins = cs.HUGE_BLOCK, cs.HUGE_NBINS
    calls = {
        "tags": lambda: bs.binned_candidates(tags, tags[:block], tagv, 0, metric="jaccard",
                                             nbins=nbins, block=block, row_sums=sums,
                                             postings=ptags),
        "text": lambda: bs.binned_candidates(text, text[:block], textv, 0, metric="dot",
                                             nbins=nbins, block=block, postings=ptext)}
    lib, tmp = instrumented_library()
    try:
        for name, fn in calls.items():
            counts = np.zeros(8, np.uint64)
            fn()
            torch.cuda.synchronize()
            build.check(lib.mused_post_clocks(counts.ctypes.data), "reading the clocks")
            fn()
            torch.cuda.synchronize()
            build.check(lib.mused_post_clocks(counts.ctypes.data), "reading the clocks")
            total = float(counts.sum())
            row = {"panel": name, "n": cols.n, "nbins": nbins, "block": block,
                   "ms": cs.cuda_ms(fn, reps=10),
                   "cycles_per_cta": total / block,
                   "phases": {p: {"cycles_per_cta": float(c) / block, "share": float(c) / total}
                              for p, c in zip(PHASES, counts)}}
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
