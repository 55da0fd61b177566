"""ctypes loader for the port's native feature hasher: the hashing part of
``mused_tpu/native/__init__.py``, copied, with its own build.

The C++ source is this package's ``hasher.cpp`` (a copy of
``mused_tpu/native/hasher.cpp``).  At first use it is compiled with the host
C++ compiler (``c++``; ``nvcc``, which drives the same compiler, where there
is none) into ``mused_tpu_torch/_build/``, named by a hash of the source and
flags, so an edited source is rebuilt.  The library hashes text tokens and
tags into fixed-width tensors far faster than the pure-Python loops in
``data/features.py``; both use CRC32, so their outputs are bit-identical.
If the library cannot be built, every function here returns None and the
callers take the Python loops; ``available()`` says which one runs,
``load_error`` why the native one does not, and ``calls`` counts the native
calls so that a run can show it went through them.

Marshalling uses the packed-blob ABI: all n rows join into ONE NUL-separated
UTF-8 blob (one str.join + one .encode, no per-row ctypes objects).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "hasher.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None
_load_failed = False
load_error = ""     # why the native library is not loaded ("" when it is)
calls = 0           # native hasher calls so far
# two prefetch threads may race the first build: one lock around build + CDLL
_load_lock = threading.Lock()


def _compile_cmd(out: str) -> list[str]:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx:
        return [cxx, *CXX_FLAGS, "-o", out, SOURCE]
    from mused_tpu_torch.ops.kernels import build
    return [build._nvcc(), "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
            "-o", out, SOURCE]


def library_path() -> str:
    """Path of the shared library for the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmused_hasher_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(_compile_cmd(tmp), check=True, capture_output=True, text=True,
                   timeout=300)
    os.replace(tmp, path)   # atomic: a concurrent loader never sees half a file


def _configure_hasher(lib):
    blob_head = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_int64]
    lib.mused_hash_text_counts_packed.argtypes = \
        blob_head + [ctypes.POINTER(ctypes.c_float)]
    lib.mused_multihot_tags_packed.argtypes = \
        lib.mused_hash_text_counts_packed.argtypes
    lib.mused_hash_text_sparse_packed.argtypes = \
        blob_head + [ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                     ctypes.POINTER(ctypes.c_uint16)]
    lib.mused_multihot_tags_sparse_packed.argtypes = \
        blob_head + [ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]


def _load_lib():
    """Build (if needed), load and configure the library; None on failure,
    with the reason in ``load_error``."""
    global load_error
    if os.environ.get("MUSED_TPU_NO_NATIVE"):
        load_error = "MUSED_TPU_NO_NATIVE is set"
        return None   # global kill switch: pure-Python fallbacks everywhere
    path = library_path()
    try:
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        _configure_hasher(lib)
        return lib
    except subprocess.CalledProcessError as e:
        load_error = f"hasher build failed: {e.stderr or e.stdout}"
    except (OSError, subprocess.SubprocessError, AttributeError, RuntimeError) as e:
        load_error = f"{type(e).__name__}: {e}"
    return None


def _load():
    global _lib, _load_failed
    if _lib is None and not _load_failed:
        with _load_lock:
            if _lib is None and not _load_failed:   # double-checked
                _lib = _load_lib()
                _load_failed = _lib is None
    return _lib


def available() -> bool:
    return _load() is not None


def _count() -> None:
    global calls
    calls += 1


def _pack(items) -> bytes:
    """One NUL-separated UTF-8 blob for all rows (single join + encode).

    Embedded NULs in the source strings would desynchronize the row walk;
    they never occur in real text, but sanitize if present (one C-speed scan).
    """
    joined = "\x00".join(items)
    if len(items) > 1 and joined.count("\x00") != len(items) - 1:
        joined = "\x00".join(s.replace("\x00", " ") for s in items)
    elif len(items) == 1 and "\x00" in joined:
        joined = joined.replace("\x00", " ")
    return joined.encode("utf-8", "ignore")


def _tag_rows(tag_lists) -> list[str]:
    rows = []
    for tags in tag_lists:
        if tags is None:
            rows.append("")
        elif isinstance(tags, str):
            rows.append(tags)
        else:
            rows.append("\x1f".join(str(t) for t in tags if t))
    return rows


def hash_text_counts(texts, dim: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = np.zeros((len(texts), dim), np.float32)
    blob = _pack([t if isinstance(t, str) else "" for t in texts])
    lib.mused_hash_text_counts_packed(
        blob, len(blob), len(texts), dim,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    _count()
    return out


def hash_text_sparse(texts, dim: int, t_cap: int):
    """(ids (n, t_cap) int32 with -1 padding, counts (n, t_cap) uint16) of
    deduped hashed tokens per document, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    n = len(texts)
    ids = np.full((n, t_cap), -1, np.int32)
    cnt = np.zeros((n, t_cap), np.uint16)
    blob = _pack([t if isinstance(t, str) else "" for t in texts])
    lib.mused_hash_text_sparse_packed(
        blob, len(blob), n, dim, t_cap,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    _count()
    return ids, cnt


def multihot_tags_sparse(tag_lists, dim: int, t_cap: int):
    """(n, t_cap) int32 deduped hashed tag ids (-1 padding), or None."""
    lib = _load()
    if lib is None:
        return None
    rows = _tag_rows(tag_lists)
    ids = np.full((len(rows), t_cap), -1, np.int32)
    blob = _pack(rows)
    lib.mused_multihot_tags_sparse_packed(
        blob, len(blob), len(rows), dim, t_cap,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    _count()
    return ids


def multihot_tags(tag_lists, dim: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    rows = _tag_rows(tag_lists)
    out = np.zeros((len(rows), dim), np.float32)
    blob = _pack(rows)
    lib.mused_multihot_tags_packed(
        blob, len(blob), len(rows), dim,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    _count()
    return out
