"""What the benchmark reads from inside the program while a window runs.

:class:`Tap` wraps a few of the program's functions for the length of a
run and keeps copies of what they return for the windows (or calls) drawn
for the check: the four kNN graphs and the username links of a dense
window (``engine.streaming.standard_kernel_graphs``), a dense window's
reduction and labels (``engine.streaming._window_step_impl``), the fused
row blocks and the truncated SVD of a huge window or a blocked batch
(``ops.blocked_affinity.fused_rowblock`` / ``blocked_svd_reduce``), and the
k-means labels (``ops.kmeans.kmeans``), before matching renames them.
Copies stay on the device until the window has closed.  ``faults`` plants
the faults that the benchmark's own tests expect the check to catch (see
:data:`FAULTS`); runs of the benchmark plant none.

:class:`SyncCounter` counts the host's waits on the device: what
``torch.cuda.set_sync_debug_mode("warn")`` reports, and every call of
``torch.cuda.synchronize`` or ``torch.cuda.Event.synchronize``.
"""
from __future__ import annotations

import contextlib
import threading
import warnings

import torch

from portbench.reference.graphs import packbits

GRAPH_ORDER = ("location", "time", "username", "tags", "text")   # the program's order
# half_rows: the second half of every graph's rows left out where the graph
# is made; fold_half_rows: the dense window's SWFD fold sketches only the
# first half of the fused rows; svd_half_rows: the blocked SVD's products
# drop the second half of every row block after the tap has copied it;
# labels_altered: k-means labels shuffled; state_unchanged: the SWFD ring
# returned unchanged.
FAULTS = ("state_unchanged", "half_rows", "fold_half_rows", "svd_half_rows",
          "labels_altered")


class Tap:
    def __init__(self, keep: dict, faults: tuple = ()):
        """``keep``: {"graphs" | "step" | "svd" | "kmeans": indices to copy},
        counted from :meth:`arm`."""
        unknown = set(faults) - set(FAULTS)
        if unknown:
            raise ValueError(f"unknown faults {sorted(unknown)}; known: {FAULTS}")
        self.keep = {k: set(keep.get(k, ())) for k in ("graphs", "step", "svd", "kmeans")}
        self.faults = tuple(faults)
        self.graphs: dict = {}       # dense window index -> {modality: packed (n, n / 8)}
        self.reduced: dict = {}      # window / call index -> (n, r) tensor
        self.blocks: dict = {}       # window / call index -> {start: packed (block, n / 8)}
        self.labels: dict = {}       # window / call index -> (n,) labels, -1 = background
        self.armed = False
        self._count = {"graphs": 0, "step": 0, "svd": 0, "kmeans": 0}
        self._current = None
        self._in_svd = False
        self._lock = threading.Lock()
        self._undo: list = []

    def arm(self) -> None:
        """Start counting windows and calls: what ran before was warm-up."""
        with self._lock:
            self._count = dict.fromkeys(self._count, 0)
            self.armed = True

    def _next(self, what: str) -> int | None:
        with self._lock:
            if not self.armed:
                return None
            i = self._count[what]
            self._count[what] += 1
            return i

    def _patch(self, module, name: str, make) -> None:
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        self._undo.append((module, name, orig))

    def __enter__(self) -> "Tap":
        from mused_tpu_torch.engine import streaming
        from mused_tpu_torch.ops import blocked_affinity, fd, kmeans, swfd

        def graphs(orig):
            def wrapped(*a, **kw):
                out = orig(*a, **kw)
                if "half_rows" in self.faults:
                    for g in out:
                        g[g.shape[0] // 2:] = 0
                i = self._next("graphs")
                if i in self.keep["graphs"]:
                    self.graphs[i] = {m: packbits(g != 0) for m, g in zip(GRAPH_ORDER, out)}
                return out
            return wrapped

        def step(orig):
            def wrapped(*a, **kw):
                state, reduced, labels = orig(*a, **kw)
                i = self._next("step")
                if i in self.keep["step"]:
                    self.reduced[i] = reduced.detach().clone()
                    self.labels[i] = labels.detach().clone()
                return state, reduced, labels
            return wrapped

        def svd(orig):
            def wrapped(*a, **kw):
                i = self._next("svd")
                self._current = i if i in self.keep["svd"] else None
                if self._current is not None:
                    self.blocks[i] = {}
                self._in_svd = True
                try:
                    out = orig(*a, **kw)
                finally:
                    cur, self._current, self._in_svd = self._current, None, False
                if cur is not None:
                    self.reduced[cur] = out.detach().clone()
                return out
            return wrapped

        def rowblock(orig):
            def wrapped(cols, start, block, *a, **kw):
                out = orig(cols, start, block, *a, **kw)
                if "half_rows" in self.faults:
                    out[block // 2:] = 0
                cur = self._current
                if cur is not None and start not in self.blocks[cur]:
                    self.blocks[cur][start] = packbits(out != 0)
                if "svd_half_rows" in self.faults and self._in_svd:
                    out = out.clone()
                    out[block // 2:] = 0
                return out
            return wrapped

        def fold(orig):
            def wrapped(rows, *a, **kw):
                rows = rows.clone()
                rows[rows.shape[0] // 2:] = 0
                return orig(rows, *a, **kw)
            return wrapped

        def lloyd(orig):
            def wrapped(*a, **kw):
                lab, cent = orig(*a, **kw)
                if "labels_altered" in self.faults:
                    gen = torch.Generator(device=lab.device).manual_seed(0)
                    lab = lab[torch.randperm(len(lab), generator=gen, device=lab.device)]
                i = self._next("kmeans")
                if i in self.keep["kmeans"]:
                    self.labels[i] = lab.detach().clone()
                return lab, cent
            return wrapped

        def absorb(orig):
            def wrapped(state, *a, **kw):
                return state
            return wrapped

        self._patch(streaming, "standard_kernel_graphs", graphs)
        self._patch(streaming, "_window_step_impl", step)
        self._patch(blocked_affinity, "blocked_svd_reduce", svd)
        self._patch(blocked_affinity, "fused_rowblock", rowblock)
        self._patch(kmeans, "kmeans", lloyd)
        if "state_unchanged" in self.faults:
            self._patch(swfd, "absorb_summary", absorb)
        if "fold_half_rows" in self.faults:
            self._patch(fd, "fold_sketch", fold)
        return self

    def __exit__(self, *exc) -> None:
        for module, name, orig in reversed(self._undo):
            setattr(module, name, orig)
        self._undo.clear()


class SyncCounter(contextlib.AbstractContextManager):
    """Host waits on the device while it is entered (``count``)."""

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def _bump(self) -> None:
        with self._lock:
            self.count += 1

    def __enter__(self) -> "SyncCounter":
        self._sync, self._event_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize
        counter = self

        def sync(*a, **kw):
            counter._bump()
            return counter._sync(*a, **kw)

        def event_sync(ev):
            counter._bump()
            return counter._event_sync(ev)

        torch.cuda.synchronize = sync
        torch.cuda.Event.synchronize = event_sync
        self._warn = warnings.catch_warnings(record=True)
        self._log = self._warn.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.set_sync_debug_mode("default")
        self._warn.__exit__(*exc)
        self.count += sum("synchroniz" in str(w.message) for w in self._log)
        torch.cuda.synchronize = self._sync
        torch.cuda.Event.synchronize = self._event_sync
