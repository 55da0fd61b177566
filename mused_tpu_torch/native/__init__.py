"""ctypes loaders for the port's native host code: the hashing part, the
incremental-DBSCAN core and the SED2012 scanner of
``mused_tpu/native/__init__.py``, copied, with their own build.

The C++ sources are this package's ``hasher.cpp``, ``incdbscan.cpp`` and
``sed2012_parser.cpp`` (copies of ``mused_tpu/native``'s).  At first use each is compiled with the
host C++ compiler (``c++``; ``nvcc``, which drives the same compiler, where
there is none) into ``mused_tpu_torch/_build/``, named by a hash of the
source and flags, so an edited source is rebuilt.

  * The hasher hashes text tokens and tags into fixed-width tensors far
    faster than the pure-Python loops in ``data/features.py``; both use
    CRC32, so their outputs are bit-identical.  Without it every function
    here returns None and the callers take the Python loops.
  * The incdbscan core (:class:`IncDBHandle`) keeps the monotone union-find
    of ``ops/dbscan.IncrementalDBSCAN``; without it ``create`` returns None
    and the clusterer re-clusters its buffer on the device.
  * The SED2012 scanner (:func:`parse_sed2012`) reads the metadata XML in one
    pass and cleans its text in C++; without it (or with
    ``MUSED_TPU_NO_NATIVE_PARSER=1``) ``data/sed2012`` takes the Python
    iterparse path, which gives the same table.

``available()`` / ``incdb_available()`` say which one runs, ``load_error`` /
``incdb_load_error`` why the native one does not, and ``calls`` /
``incdb_calls`` count the native calls so that a run can show it went
through them.

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
INCDB_SOURCE = os.path.join(_DIR, "incdbscan.cpp")
SED_SOURCE = os.path.join(_DIR, "sed2012_parser.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None
_load_failed = False
load_error = ""     # why the native hasher is not loaded ("" when it is)
calls = 0           # native hasher calls so far
_incdb_lib = None
_incdb_load_failed = False
incdb_load_error = ""   # why the native incdbscan core is not loaded
incdb_calls = 0         # native incdbscan inserts so far
_sed_lib = None
_sed_load_failed = False
sed_load_error = ""     # why the native SED2012 scanner is not loaded
sed_calls = 0           # native SED2012 scans so far
# two prefetch threads may race the first build: one lock around build + CDLL
_load_lock = threading.Lock()


def _compile_cmd(out: str, source: str) -> list[str]:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx:
        return [cxx, *CXX_FLAGS, "-o", out, source]
    from mused_tpu_torch.ops.kernels import build
    return [build._nvcc(), "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC,-pthread",
            "-o", out, source]


def library_path(source: str = SOURCE) -> str:
    """Path of the shared library for ``source`` and the current flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"libmused_{stem}_{h.hexdigest()[:16]}.so")


def _build(path: str, source: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(_compile_cmd(tmp, source), check=True, capture_output=True,
                   text=True, timeout=300)
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


def _configure_incdb(lib):
    lib.mused_incdb_create.restype = ctypes.c_void_p
    lib.mused_incdb_create.argtypes = [ctypes.c_int64]
    lib.mused_incdb_free.argtypes = [ctypes.c_void_p]
    lib.mused_incdb_free.restype = None
    lib.mused_incdb_insert.restype = ctypes.c_int64
    lib.mused_incdb_insert.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.mused_incdb_labels.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.mused_incdb_labels.restype = None


def _configure_sed(lib):
    lib.mused_parse_sed2012.restype = ctypes.c_int64
    lib.mused_parse_sed2012.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.mused_free_blob.argtypes = [ctypes.POINTER(ctypes.c_char)]


def _load_lib(source: str, configure):
    """Build (if needed), load and configure one library: (lib or None, why
    not)."""
    if os.environ.get("MUSED_TPU_NO_NATIVE"):
        return None, "MUSED_TPU_NO_NATIVE is set"   # kill switch: fallbacks everywhere
    path = library_path(source)
    try:
        if not os.path.exists(path):
            _build(path, source)
        lib = ctypes.CDLL(path)
        configure(lib)
        return lib, ""
    except subprocess.CalledProcessError as e:
        return None, f"{os.path.basename(source)} build failed: {e.stderr or e.stdout}"
    except (OSError, subprocess.SubprocessError, AttributeError, RuntimeError) as e:
        return None, f"{type(e).__name__}: {e}"


def _load():
    global _lib, _load_failed, load_error
    if _lib is None and not _load_failed:
        with _load_lock:
            if _lib is None and not _load_failed:   # double-checked
                _lib, load_error = _load_lib(SOURCE, _configure_hasher)
                _load_failed = _lib is None
    return _lib


def _load_incdb():
    global _incdb_lib, _incdb_load_failed, incdb_load_error
    if _incdb_lib is None and not _incdb_load_failed:
        with _load_lock:
            if _incdb_lib is None and not _incdb_load_failed:
                _incdb_lib, incdb_load_error = _load_lib(INCDB_SOURCE, _configure_incdb)
                _incdb_load_failed = _incdb_lib is None
    return _incdb_lib


def _load_sed():
    global _sed_lib, _sed_load_failed, sed_load_error
    if _sed_lib is None and not _sed_load_failed:
        with _load_lock:
            if _sed_lib is None and not _sed_load_failed:
                _sed_lib, sed_load_error = _load_lib(SED_SOURCE, _configure_sed)
                _sed_load_failed = _sed_lib is None
    return _sed_lib


def sed_available() -> bool:
    return _load_sed() is not None


def parse_sed2012(path: str, skip_records: int = 0, max_records: int | None = None,
                  clean: bool = False, threads: int | None = None):
    """Native SED2012 metadata scan (sed2012_parser.cpp) -> column dict
    (id / taken / uploaded / username / title / description string lists,
    lat / lon float64, tag_counts + flat tags), or None when the library is
    unavailable or the output's framing disagrees.  ``clean=True`` runs
    title, description and tags through the C++ ``clean_text``; float / NaN
    conversion and labels stay in ``data/sed2012``.  ``threads`` splits the
    scan over "<photo"-aligned chunks (byte-identical output); None = the
    MUSED_TPU_PARSER_THREADS variable, else 0 = auto."""
    global sed_calls
    lib = _load_sed()
    if lib is None:
        return None
    if threads is None:
        try:
            threads = int(os.environ.get("MUSED_TPU_PARSER_THREADS", "0"))
        except ValueError:
            threads = 0
    blob_p = ctypes.POINTER(ctypes.c_char)()
    blob_len = ctypes.c_int64(0)
    n = lib.mused_parse_sed2012(
        path.encode(), skip_records, -1 if max_records is None else max_records,
        int(clean), threads, ctypes.byref(blob_p), ctypes.byref(blob_len))
    if n < 0:
        return None
    sed_calls += 1
    try:
        raw = ctypes.string_at(blob_p, blob_len.value)
    finally:
        lib.mused_free_blob(blob_p)

    # column-oriented decode: numpy for the numbers, one decode + one split
    # per string column
    import struct
    off = 0
    (nrec,) = struct.unpack_from("<Q", raw, off)
    off += 8
    lat = np.frombuffer(raw, "<f8", nrec, off).copy()
    off += 8 * nrec
    lon = np.frombuffer(raw, "<f8", nrec, off).copy()
    off += 8 * nrec
    str_cols = []
    for _ in range(6):
        (blen,) = struct.unpack_from("<Q", raw, off)
        off += 8
        blob = raw[off:off + blen]
        off += blen
        str_cols.append(blob.decode("utf-8", "replace").split("\x00") if nrec else [])
    tag_counts = np.frombuffer(raw, "<u4", nrec, off).copy()
    off += 4 * nrec
    (tlen,) = struct.unpack_from("<Q", raw, off)
    off += 8
    total_tags = int(tag_counts.sum()) if nrec else 0
    tag_items = (raw[off:off + tlen].decode("utf-8", "replace").split("\x00")
                 if total_tags else [])
    if any(len(col) != nrec for col in str_cols) or len(tag_items) != total_tags:
        return None     # framing mismatch: the caller takes the Python parser
    ids, taken, uploaded, username, title, desc = str_cols
    return {"n": int(nrec), "id": ids, "taken": taken, "uploaded": uploaded,
            "username": username, "title": title, "description": desc,
            "lat": lat, "lon": lon, "tag_counts": tag_counts, "tags": tag_items}


def incdb_available() -> bool:
    return _load_incdb() is not None


class IncDBHandle:
    """Owning wrapper over the native incremental-DBSCAN structure
    (incdbscan.cpp): monotone union-find over eps-pairs discovered on the
    device.  The factory returns None when the library is unavailable."""

    @staticmethod
    def create(min_pts: int) -> "IncDBHandle | None":
        lib = _load_incdb()
        if lib is None:
            return None
        return IncDBHandle(lib, lib.mused_incdb_create(int(min_pts)))

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle
        self._poisoned = False
        self.n = 0

    def insert(self, n_new: int, pair_a: np.ndarray, pair_b: np.ndarray) -> None:
        global incdb_calls
        if self._poisoned:
            raise MemoryError("native incdbscan handle is poisoned "
                              "(earlier allocation failure)")
        pa = np.ascontiguousarray(pair_a, np.int32)
        pb = np.ascontiguousarray(pair_b, np.int32)
        assert pa.shape == pb.shape and pa.ndim == 1
        n = self._lib.mused_incdb_insert(
            self._h, int(n_new), len(pa),
            pa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        incdb_calls += 1
        if n == -2:
            # allocation failure mid-mutation: the structure may hold a
            # partly applied batch, so nothing may read or extend it
            self._poisoned = True
            raise MemoryError("native incdbscan allocation failed; the "
                              "handle is poisoned — rebuild the clusterer")
        if n < 0:
            # ids are validated before any mutation: the handle stays usable
            raise ValueError("malformed eps-pair ids")
        self.n = int(n)

    def labels(self) -> np.ndarray:
        if self._poisoned:
            raise MemoryError("native incdbscan handle is poisoned "
                              "(earlier allocation failure)")
        out = np.empty(self.n, np.int32)
        if self.n:
            self._lib.mused_incdb_labels(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mused_incdb_free(self._h)
            self._h = None


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
