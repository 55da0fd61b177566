"""Build and load the port's CUDA kernels (``mused_tpu_torch/csrc/*.cu``).

Route: ``nvcc`` compiles every source into an object file, all sources at
once in parallel, and links them into one shared library with a plain C
interface, loaded with ``ctypes``.  Nothing includes PyTorch's headers, so a
build takes seconds rather than the minutes a ``torch.utils.cpp_extension``
build of the same kernels costs.  The library lands in ``_build/`` beside
this package (git-ignored), named by a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is reused.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.  The build happens at
first use, never at import: CPU-only installs import this module freely.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of the last build (None: reused)
build_log: str = ""                  # nvcc's output for the loaded library


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmused_kernels_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tmp = _nvcc(), f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                               *(obj for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    with open(path + ".log", "w") as f:
        f.write(build_log)
    os.replace(tmp, path)   # atomic: a concurrent loader never sees half a file


def _configure(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mused_knn_adjacency.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.mused_knn_adjacency.restype = i
    lib.mused_knn_smem_bytes.argtypes = [i]
    lib.mused_knn_smem_bytes.restype = i
    lib.mused_binned_candidates.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.mused_binned_candidates.restype = i
    lib.mused_binned_candidates_splits.argtypes = [i] * 4
    lib.mused_binned_candidates_splits.restype = i
    lib.mused_binned_candidates_pair.argtypes = ([p] * 5 + [i, i]) * 2 + [p] * 4 + [i] * 4 + [p]
    lib.mused_binned_candidates_pair.restype = i
    lib.mused_binned_candidates_pair_splits.argtypes = [i] * 3
    lib.mused_binned_candidates_pair_splits.restype = i
    lib.mused_binned_postings.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.mused_binned_postings.restype = i
    lib.mused_binned_postings_pair.argtypes = ([p] * 7 + [i, i]) * 2 + [p] * 4 + [i] * 4 + [p]
    lib.mused_binned_postings_pair.restype = i
    lib.mused_union_rowblock.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.mused_union_rowblock.restype = i
    lib.mused_cand_list_names.argtypes = []
    lib.mused_cand_list_names.restype = ctypes.c_char_p
    lib.mused_cand_lists_layout.argtypes = [i] * 4 + [p] * 4
    lib.mused_cand_lists_layout.restype = i
    lib.mused_cand_lists.argtypes = [p, p, p] + [i] * 6 + [p, p]
    lib.mused_cand_lists.restype = i
    lib.mused_cand_scratch_words.argtypes = [i] * 7
    lib.mused_cand_scratch_words.restype = ctypes.c_longlong
    for fn in (lib.mused_cand_matvec_t, lib.mused_cand_matvec):
        fn.argtypes = [p, p, p] + [i] * 6 + [p, p, i, p, p, p]
        fn.restype = i
    lib.mused_cuda_error_string.argtypes = [i]
    lib.mused_cuda_error_string.restype = ctypes.c_char_p


def load():
    """The loaded kernel library, building it first if needed."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            elif os.path.exists(path + ".log"):
                with open(path + ".log") as f:
                    build_log = f.read()
            lib = ctypes.CDLL(path)
            _configure(lib)
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().mused_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
