"""Console capture: mirror stdout/stderr into a timestamped run log — the
port's copy of ``mused_tpu/utils/tee.py`` (no JAX there either).

Provides the observability contract of reference tee.py (every byte printed
during a sweep also lands in a log file; broken/closed sinks never crash the
experiment; the file is closed even on abnormal exit) with an original
design: a fan-out stream plus a ``LogSession`` handle that owns install,
restore, and close, instead of module-global redirection only.  One
reference inconsistency resolved: it tees into ``log/`` while its metric
dumps go to ``logs/`` (SURVEY.md §5.5) — default here is ``logs/``,
configurable.  Under a torch.distributed process group of more than one
rank, only rank 0 writes a log file: the other ranks get an inert session
that leaves their streams alone.
"""
from __future__ import annotations

import atexit
import io
import os
import sys
from datetime import datetime

_SINK_ERRORS = (ValueError, OSError)   # closed file / broken pipe


class Fanout(io.TextIOBase):
    """Text stream that repeats every write to each sink, best-effort.

    A sink that raises (closed file, broken pipe) is skipped for that call —
    logging must never take the experiment down with it.
    """

    def __init__(self, *sinks):
        super().__init__()
        self._sinks = tuple(sinks)

    def write(self, data) -> int:
        for sink in self._sinks:
            try:
                sink.write(data)
                sink.flush()
            except _SINK_ERRORS:
                continue
        return len(data)

    def flush(self) -> None:
        for sink in self._sinks:
            try:
                sink.flush()
            except _SINK_ERRORS:
                continue

    def isatty(self) -> bool:
        head = self._sinks[0] if self._sinks else None
        try:
            return bool(head and head.isatty())
        except _SINK_ERRORS:
            return False

    def writable(self) -> bool:
        return True


class LogSession:
    """An installed stdout/stderr mirror; restore() puts the world back."""

    def __init__(self, path: str, file):
        self.path = path
        self.file = file
        self._saved = (sys.stdout, sys.stderr)
        atexit.register(self.close)

    def restore(self) -> None:
        # restore what was active when THIS session installed itself, so
        # nested sessions unwind correctly (an outer tee keeps logging)
        sys.stdout, sys.stderr = self._saved
        self.close()

    def close(self) -> None:
        f = self.file
        if f is None or f.closed:
            return
        try:
            f.close()
        except Exception as exc:     # noqa: BLE001 — never die in teardown
            sys.__stderr__.write(f"[tee] could not close {self.path}: {exc}\n")

    # file-like conveniences so callers can treat the session as the file
    @property
    def closed(self) -> bool:
        return self.file is None or self.file.closed


def setup_logging(log_dir: str = "logs") -> LogSession:
    """Start mirroring stdout+stderr into ``log_dir/<timestamp>.txt``.

    Returns a LogSession; call ``.restore()`` when the sweep ends (or rely on
    the atexit close).  Covers reference tee.py:28-52 usage at main.py:326.
    A rank other than 0 of a process group gets a session without a file.
    """
    from mused_tpu_torch.parallel.mesh import is_writer
    if not is_writer():
        return LogSession(None, None)
    os.makedirs(log_dir, exist_ok=True)
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    # 'x' + suffix retry: two sessions inside one wall-clock second must
    # not truncate each other's log (a fast-failing experiment's recorded
    # traceback was destroyed by the next experiment's tee otherwise)
    path = os.path.join(log_dir, f"{stamp}.txt")
    for k in range(1, 1000):
        try:
            handle = open(path, "x")
            break
        except FileExistsError:
            path = os.path.join(log_dir, f"{stamp}-{k}.txt")
    else:
        handle = open(path, "w")     # pathological: give up on uniqueness
    session = LogSession(path, handle)
    # fan out from the CURRENT streams (not sys.__stdout__) so nesting
    # chains: an inner session's output still reaches the outer log file
    sys.stdout = Fanout(session._saved[0], handle)
    sys.stderr = Fanout(session._saved[1], handle)
    return session


def teardown_logging(session=None) -> None:
    """Undo setup_logging (the reference never restores; sweeps here nest)."""
    if isinstance(session, LogSession):
        session.restore()
        return
    # legacy raw-file path: peel THIS file out of the fan-out instead of
    # resetting to the process streams — a blanket sys.__stdout__ reset
    # uninstalled any OUTER LogSession and its log silently lost the rest
    # of the run (review r5)
    if session is not None:
        for name in ("stdout", "stderr"):
            cur = getattr(sys, name)
            if isinstance(cur, Fanout) and session in cur._sinks:
                rest = [k for k in cur._sinks if k is not session]
                setattr(sys, name,
                        rest[0] if len(rest) == 1 else Fanout(*rest))
        safe_close(session)
    else:
        sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__


def safe_close(file) -> None:
    """Close a raw file object without letting teardown raise."""
    try:
        if file is not None and not file.closed:
            file.close()
    except Exception as exc:         # noqa: BLE001 — never die in teardown
        sys.__stderr__.write(f"[tee] close failed: {exc}\n")


# Back-compat alias: round-1 callers/tests used the class name Tee
Tee = Fanout
