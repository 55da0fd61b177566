"""Online serving API: push records as they arrive, get events out — port of
``mused_tpu/serving.py``.

The reference has no serving surface: its only entry point
(``process_streaming_data``, reference main.py:13-130) needs the whole
stream and its ground-truth labels up front.  ``StreamDetector`` wraps the
same engine for production use:

  * records are pushed incrementally (single records or chunks), with no
    ground truth anywhere;
  * windows fire on the reference's trigger (main.py:32), sliding windows
    included (``step_window_ratio``);
  * each window's cluster count comes from the label-free eigengap estimate
    (``k_estimate="eigengap"``) or a fixed cap, never from labels;
  * cluster ids stay stable across windows through the engine's positional
    matching and surface as per-window :class:`WindowResult` events;
  * featurize + dispatch run on a background worker thread with a bounded
    queue (``dispatch_ahead``; at saturation pushes block instead of
    buffering without bound).  Every push, whether it fires a window or
    not, returns oldest-first each pending window whose device work has
    completed (its CUDA event reports done), so a result waits for no later
    fire.  Only a push that fires a window waits on the device, and only
    when more windows are pending than ``max_lag`` plus what the worker can
    hold (``dispatch_ahead + 1`` windows or groups), which bounds the lag
    and the host memory (``flush()`` drains);
  * eligible configs (``windows_per_batch`` = W > 1, by the offline
    engine's rule, ``engine.streaming.resolve_windows_per_batch``) buffer W
    fired windows and dispatch them as one group
    (``engine.streaming.scanned_group_dispatch``), whose labels are pulled
    in one transfer and equal per-window dispatch's.  Results may then lag
    by up to W - 1 buffered windows more, and the worker holds up to
    ``dispatch_ahead + 1`` groups; ``flush()`` dispatches a partial group
    window by window (never padded: the sketch state sees each window
    once);
  * ``background=True`` adds the label-free background bucket
    (``kmeans.mark_background``): rows in the far mode of the embedding's
    distance-to-centroid distribution get event id -1 ("no event"), which
    matching passes through;
  * ``save()`` / ``load()`` checkpoint the whole detector (device sketch
    state, matcher state, the raw-record tail the next windows need);
  * while spans record (``utils/profiling``), each window's root span
    ``serving.window`` runs from its fire to the return of its result,
    tiled by ``serving.queue_wait`` (fire to the worker's start),
    ``featurize``, ``engine.enqueue`` (copy and dispatch, host),
    ``serving.held`` (enqueue end to finalize start: the device tail and
    the wait for the next push) and ``serving.finalize`` (label pull,
    matching, event ids), all keyed by the window index.  The counter
    ``serving.finalized_early`` records 1 for each window a push finalizes
    while no more than ``max_lag`` windows are pending.

The worker thread launches device work and the caller thread pulls labels
on the same (the current) CUDA stream, so window order holds; readiness is
a CUDA event recorded after each window's or group's dispatch.  Everything
downstream of featurization is the offline engine's window step or group
call: serving adds no second compute path.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from mused_tpu_torch.data.ingest import to_device
from mused_tpu_torch.engine import streaming as engine_mod
from mused_tpu_torch.utils import profiling
from mused_tpu_torch.utils.config import FeatureConfig, PipelineConfig

WINDOW_SPAN = "serving.window"


class _DispatchWorker:
    """One background thread owning featurize + device dispatch, FIFO (the
    engine's state is strictly sequential across windows) over a bounded
    queue: at saturation pushes block on a free slot (backpressure)."""

    def __init__(self, depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="serving-dispatch")
        self._t.start()

    def submit(self, fn) -> None:
        self.check()
        self._q.put(fn)

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            try:
                if fn is None:
                    return
                if self._exc is None:   # after a failure: drain, don't run
                    fn()
            except BaseException as e:  # noqa: BLE001 — re-raised at the caller
                self._exc = e
            finally:
                self._q.task_done()

    def drain(self) -> None:
        """Block until every submitted dispatch has completed."""
        self._q.join()
        self.check()

    def check(self) -> None:
        # a dispatch failure poisons the detector for good: the windows after
        # the failed one were never folded into the state, so every later
        # push / flush / save must fail rather than emit a stream with
        # windows missing
        if self._exc is not None:
            raise RuntimeError(
                "serving dispatch worker failed; this detector's stream state is "
                "broken past the failed window — restore from the last save()"
            ) from self._exc

    def stop(self) -> None:
        try:
            self._q.put_nowait(None)
        except queue.Full:      # a wedged queue must not block shutdown
            pass


def _entry_ready(entry) -> bool:
    """True when finalizing ``entry`` will not wait for the device: its
    window's or group's dispatch event has completed (always True off the
    card, and for a huge window, which completes inside its dispatch)."""
    if len(entry) == 3:                  # (row_start, _PendingWindow, event)
        _, pending, event = entry
        return pending.clusters is not None or event is None or event.query()
    return entry[3].ready()              # a group member: its _GroupHandle


class _GroupHandle:
    """A dispatched group's device labels (W, n) and r_norms (W,), pulled
    to the host once for its W windows."""

    def __init__(self, labels: torch.Tensor, r_norms: torch.Tensor, event):
        self._labels, self.r_norms, self._event = labels, r_norms, event
        self._host: np.ndarray | None = None

    def ready(self) -> bool:
        return self._host is not None or self._event is None or self._event.query()

    def pull(self) -> np.ndarray:
        if self._host is None:
            self._host = self._labels.cpu().numpy()
            self._labels = None
        return self._host


class WindowResult(NamedTuple):
    """One processed window's events."""

    window_index: int
    row_start: int          # absolute stream index of the window's first row
    clusters: np.ndarray    # (window_size,) stable event id per record;
                            # -1 = background ("no event", background_bucket)
    event_ids: np.ndarray   # unique event ids present in this window (no -1)
    counts: np.ndarray      # record count per event_ids entry
    new_events: np.ndarray  # event ids first seen in this window (no -1)
    background: int = 0     # rows in this window's background bucket


class StreamDetector:
    """Push-based online event detector on ``device`` (the card unless the
    caller passes ``device="cpu"``).

    Parameters mirror :class:`PipelineConfig`; pass ``cfg`` for full
    control.  ``k_estimate`` must be label-free ("eigengap" or "fixed"):
    serving has no ground truth, so the reference's labels-derived count
    (main.py:41) is rejected.

    ``max_lag`` is the number of windows that may stay unpulled while their
    device work runs: past it, plus what the dispatch worker holds, a push
    waits for the oldest.  It holds nothing back: a window whose work has
    completed is returned by the next push at any depth.  A huge window
    completes inside its dispatch and runs with no lag."""

    def __init__(self, modality_types: Sequence[str], window_size: int, *,
                 approach: str = "SWFDMC", reduced_dim: int = 50,
                 k_basis: int = 50, max_events: int = 150,
                 k_estimate: str = "eigengap", step_window_ratio: int = 1,
                 seed: int = 0, matching: str = "auto", max_lag: int = 2,
                 dispatch_ahead: int = 2, background: bool = False,
                 cfg: PipelineConfig | None = None, device="cuda"):
        if cfg is None:
            cfg = PipelineConfig(
                window_size=window_size, reduced_dim=reduced_dim, k_basis=k_basis,
                approach=approach, seed=seed, label_mode="all",
                n_clusters_override=max_events, matching=matching,
                k_estimate=k_estimate, step_window_ratio=step_window_ratio,
                background_bucket=background)
        if cfg.k_estimate == "labels":
            raise ValueError(
                "serving is unsupervised: k_estimate must be 'eigengap' or 'fixed' "
                "('labels' is the offline reference quirk that derives each "
                "window's cluster count from ground truth)")
        self.cfg = cfg
        self.modality_types = tuple(modality_types)
        self.engine = engine_mod.StreamingEngine(cfg, device)
        # a huge window matches inside its dispatch, which needs the previous
        # window's matched labels: no lag
        self.max_lag = 0 if self.engine.huge else max(int(max_lag), 0)
        # the offline engine's rule for W; without lag a group cannot wait
        self._batch_w = 1 if self.max_lag == 0 else engine_mod.resolve_windows_per_batch(
            cfg, standard_types=list(self.modality_types) == engine_mod.STANDARD_TYPES,
            backend=self.engine.device.type)
        self._scan_types = engine_mod.scanned_types_for(self.modality_types, cfg.features)
        # (row_start, window index, window rows, fire time) fired and awaiting
        # a full group
        self._gbuf: list[tuple[int, int, list[np.ndarray], int]] = []
        # retention: per-modality lists of immutable pushed chunks covering
        # at least the last window_size rows (see push())
        self._rchunks: list[list[np.ndarray]] = [[] for _ in self.modality_types]
        self._ret_start = 0      # absolute index of the first retained row
        self._ret_len = 0
        self._count = 0          # absolute records pushed
        self._window_index = 0
        self._prev_clusters: np.ndarray | None = None
        # (row_start, _PendingWindow, CUDA event or None) per window, or
        # (row_start, window index, stable feats, _GroupHandle, position) per
        # member of a group: appended by the dispatch worker, consumed by the
        # caller thread (one producer, one consumer; deque ops are atomic)
        self._pending: collections.deque[tuple] = collections.deque()
        self._seen_events: set[int] = set()
        # window index -> (fire time, enqueue end), both time.time_ns(): kept
        # by the worker while spans record, for the finalize-side spans
        self._stamps: dict[int, tuple[int, int]] = {}
        # labels are never consulted (k_estimate is label-free); this array
        # only fills the engine's signature
        self._dummy_labels = np.zeros(cfg.window_size, np.int64)
        # the worker exists only when results may lag anyway; created at the
        # first window, depth 0 opts out
        self._dispatch_ahead = int(dispatch_ahead) if self.max_lag > 0 else 0
        self._worker: _DispatchWorker | None = None

    # ------------------------------------------------------------------
    def push(self, modality_rows: Sequence[np.ndarray]) -> list[WindowResult]:
        """Feed one record or a chunk of records (one array per modality,
        each ``(n_new, width)``, or ``(width,)`` for a single record).
        Returns the windows finalized by this push; ``flush()`` drains the
        rest."""
        rows = [np.asarray(m) for m in modality_rows]
        if len(rows) != len(self.modality_types):
            raise ValueError(
                f"got {len(rows)} modality arrays, expected "
                f"{len(self.modality_types)} ({self.modality_types})")
        # chunks are (n, width); a bare 1-D array is ONE record of that width,
        # so scalar (width-1) modalities must ship as (n, 1)
        if any(m.ndim == 0 for m in rows):
            raise ValueError(
                "modality arrays must be (n, width) chunks or (width,) single "
                "records; got a 0-d scalar — wrap scalar modalities as (n, 1)")
        rows = [m[None] if m.ndim == 1 else m for m in rows]
        n_new = len(rows[0])
        if any(len(m) != n_new for m in rows):
            raise ValueError(
                "modality chunks disagree on record count "
                f"({[len(m) for m in rows]}); scalar modalities must be shaped "
                "(n, 1) — a 1-D array is read as ONE record")

        w = self.cfg.window_size
        # the one copy detaches the rows from the caller's arrays: retained
        # chunks are immutable, so window views handed to the worker never
        # see a caller reusing its buffer
        for lst, m in zip(self._rchunks, rows):
            lst.append(np.array(m))
        self._ret_len += n_new
        end = self._count + n_new

        out: list[WindowResult] = []
        # fire at record i when i+1 >= w and ((i+1)*ratio) % w == 0, i.e. i+1
        # is a multiple of w // gcd(ratio, w) past one full window
        p = w // math.gcd(self.cfg.step_window_ratio, w)
        t0 = -(-max(w, self._count + 1) // p) * p
        for t in range(t0, end + 1, p):
            out.extend(self._fire(t - 1, self._window_rows(t - w, t)))
        self._count = end
        out.extend(self._drain_ready(block=False))
        # drop whole chunks no future window can reach (every future window
        # starts at >= count - w + 1)
        while self._rchunks[0] and self._ret_len - len(self._rchunks[0][0]) >= w:
            n0 = len(self._rchunks[0][0])
            for lst in self._rchunks:
                lst.pop(0)
            self._ret_len -= n0
            self._ret_start += n0
        return out

    def _window_rows(self, lo: int, hi: int) -> list[np.ndarray]:
        """Rows [lo, hi) per modality from the retained chunks: a view when
        one chunk covers the range, else one concatenate."""
        out = []
        for lst in self._rchunks:
            parts = []
            pos = self._ret_start
            for c in lst:
                s, e = max(lo - pos, 0), min(hi - pos, len(c))
                if e > s:
                    parts.append(c[s:e])
                pos += len(c)
                if pos >= hi:
                    break
            out.append(parts[0] if len(parts) == 1 else np.concatenate(parts))
        return out

    def _submit(self, fn) -> None:
        """Run ``fn`` on the dispatch worker (created lazily), or inline when
        asynchronous dispatch is off."""
        if self._dispatch_ahead <= 0:
            fn()
            return
        if self._worker is None:
            self._worker = _DispatchWorker(self._dispatch_ahead)
        self._worker.submit(fn)

    def _fire(self, i: int, window: list[np.ndarray]) -> list[WindowResult]:
        """Dispatch the window ending at absolute index ``i``; finalize the
        completed windows, and any beyond the hard bound."""
        fired = time.time_ns()
        row_start = i + 1 - self.cfg.window_size
        widx = self._window_index
        self._window_index += 1
        if self._batch_w > 1:
            self._gbuf.append((row_start, widx, window, fired))
            if len(self._gbuf) == self._batch_w:
                group, self._gbuf = self._gbuf, []
                self._submit(lambda: self._dispatch_group(group))
        else:
            self._submit(lambda: self._dispatch_one(row_start, widx, window, fired))
        return self._drain_ready(block=True)

    def _drain_ready(self, block: bool) -> list[WindowResult]:
        """Finalize pending windows oldest-first while the oldest's device
        work has completed, at any depth, so the pull waits for nothing.
        With ``block``, past the hard bound (``max_lag`` plus what the
        worker can hold) the oldest is pulled even if it has not completed,
        so the lag and host memory stay bounded; only a push that fired a
        window blocks."""
        hard = self.max_lag + (self._batch_w * (self._dispatch_ahead + 1)
                               if self._worker else 0)
        out = []
        while self._pending:
            depth = len(self._pending)
            if not (block and depth > hard) and not _entry_ready(self._pending[0]):
                break
            result = self._finalize_oldest()
            if depth <= self.max_lag:
                profiling.counter("serving.finalized_early", 1, key=result.window_index)
            out.append(result)
        return out

    def _dispatch_one(self, row_start: int, widx: int, rows: list[np.ndarray],
                      fired: int) -> None:
        """Featurize, copy to the device and dispatch one window (on the
        worker thread when asynchronous).  A dense dispatch reads no previous
        labels (matching is finalize-side)."""
        eng = self.engine
        profiling.interval("serving.queue_wait", fired, time.time_ns(), key=widx,
                           parent=WINDOW_SPAN)
        host = eng.featurize(rows, self.modality_types, key=widx, parent=WINDOW_SPAN)
        with profiling.span("engine.enqueue", key=widx, parent=WINDOW_SPAN):
            pending = eng.dispatch_window(host, to_device(host, eng.device),
                                          self.modality_types, self._dummy_labels, widx,
                                          self._prev_clusters)
            event = self._recorded_event()
        if profiling.on():
            self._stamps[widx] = (fired, time.time_ns())
        self._pending.append((row_start, pending, event))

    def _recorded_event(self):
        """A CUDA event recorded after the work enqueued so far (None off the card)."""
        if self.engine.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _dispatch_group(self, group: list) -> None:
        """Featurize a full group, move it to the device stacked and dispatch
        it as one group call (on the worker thread when asynchronous)."""
        eng = self.engine
        started = time.time_ns()
        for _, widx, _, fired in group:
            profiling.interval("serving.queue_wait", fired, started, key=widx,
                               parent=WINDOW_SPAN)
        host = [eng.featurize(rows, self.modality_types, key=widx, parent=WINDOW_SPAN)
                for _, widx, rows, _ in group]
        enqueue = time.time_ns()
        feats = to_device(engine_mod.stack_window_features([tuple(h) for h in host]),
                          eng.device)
        k, k_source = eng._k_plan(self._dummy_labels)
        labels, r_norms = engine_mod.scanned_group_dispatch(
            eng, feats, [k] * len(group), [w for _, w, _, _ in group],
            types=self._scan_types, k_source=k_source)
        handle = _GroupHandle(labels, r_norms, self._recorded_event())
        enqueued = time.time_ns()
        for _, widx, _, fired in group:    # the group's enqueue, once per member
            profiling.interval("engine.enqueue", enqueue, enqueued, key=widx,
                               parent=WINDOW_SPAN)
            if profiling.on():
                self._stamps[widx] = (fired, enqueued)
        for pos, ((row_start, widx, _, _), h) in enumerate(zip(group, host)):
            self._pending.append((row_start, widx, eng._stable_feats(h), handle, pos))

    def _finalize_oldest(self) -> WindowResult:
        entry = self._pending.popleft()
        widx = entry[1].window_index if len(entry) == 3 else entry[1]
        start = time.time_ns()
        with profiling.span("serving.finalize", key=widx, parent=WINDOW_SPAN):
            result = self._finalize(entry)
        end = time.time_ns()
        stamps = self._stamps.pop(widx, None)
        if stamps is not None:
            fired, enqueued = stamps
            profiling.interval("serving.held", enqueued, start, key=widx,
                               parent=WINDOW_SPAN)
            profiling.interval(WINDOW_SPAN, fired, end, key=widx)
        return result

    def _finalize(self, entry) -> WindowResult:
        eng = self.engine
        if len(entry) == 3:
            row_start, pending, _ = entry
            widx = pending.window_index
            clusters = eng.finalize_window(pending, self._prev_clusters)
        else:
            row_start, widx, stable_feats, handle, pos = entry
            labels = handle.pull()[pos]
            if self.cfg.approach == "SWFDMC" and eng.swfd_R is None:
                eng.swfd_R = float(handle.r_norms[0])
            clusters = engine_mod.match_window_labels(
                self._prev_clusters, labels, self.cfg, method=eng._match_method(),
                centroid_matcher=eng.centroid_matcher, stable_feats=stable_feats)
        self._prev_clusters = clusters
        ids, counts = np.unique(clusters, return_counts=True)
        # the background id (-1) is "no event": never in event_ids /
        # new_events; its rows show in `clusters` and `background`
        n_background = 0
        if len(ids) and ids[0] == -1:
            n_background = int(counts[0])
            ids, counts = ids[1:], counts[1:]
        new = np.array([e for e in ids.tolist() if e not in self._seen_events], ids.dtype)
        self._seen_events.update(ids.tolist())
        return WindowResult(window_index=widx, row_start=row_start,
                            clusters=clusters, event_ids=ids, counts=counts,
                            new_events=new, background=n_background)

    def flush(self) -> list[WindowResult]:
        """Finalize every queued window: in-flight dispatches drain first,
        then a partial group dispatches window by window."""
        if self._worker is not None:
            self._worker.drain()
        for row_start, widx, rows, fired in self._gbuf:
            self._dispatch_one(row_start, widx, rows, fired)
        self._gbuf = []
        out = []
        while self._pending:
            out.append(self._finalize_oldest())
        return out

    def __del__(self):
        worker = getattr(self, "_worker", None)
        if worker is not None:
            worker.stop()

    # ------------------------------------------------------------------
    def save(self, path: str) -> list[WindowResult]:
        """Checkpoint the detector (device state, matcher state, the raw
        record tail).  Pending windows are flushed first so the saved state
        is window-consistent; their results are returned.  When the engine
        runs SPMD over a mesh, rank 0 alone writes and every rank returns
        after the write.  Same trust model as ``utils/checkpoint``: load only
        checkpoints you wrote."""
        flushed = self.flush()
        from mused_tpu_torch.parallel import mesh as mesh_mod
        from mused_tpu_torch.utils import checkpoint as ckpt
        mesh_mod.write_once(lambda: ckpt.save_checkpoint(path, self.engine.state, {
            "serving": True,
            "count": self._count,
            "window_index": self._window_index,
            "prev_clusters": self._prev_clusters,
            "seen_events": sorted(self._seen_events),
            "tail": self._window_rows(max(0, self._count - self.cfg.window_size),
                                      self._count),
            "dispatch_ahead": self._dispatch_ahead,
            "modality_types": list(self.modality_types),
            # the full config, nested FeatureConfig included: a partial field
            # list would rebuild other featurization / clustering knobs
            "cfg_kwargs": dataclasses.asdict(self.cfg),
            **self.engine.host_snapshot()}), spmd=self.engine.mesh is not None)
        return flushed

    @classmethod
    def load(cls, path: str, *, max_lag: int = 2, dispatch_ahead: int | None = None,
             cfg: PipelineConfig | None = None, device="cuda") -> "StreamDetector":
        """Rebuild a detector from :meth:`save` output on ``device``; pushing
        resumes the stream where it left off (the saved tail gives the next
        windows their overlap).  ``dispatch_ahead=None`` keeps the saved
        detector's depth."""
        from mused_tpu_torch.utils import checkpoint as ckpt
        leaves, host = ckpt.load_checkpoint(path)
        if not host.get("serving"):
            raise ValueError(f"{path} is not a StreamDetector checkpoint")
        if cfg is None:
            kw = dict(host["cfg_kwargs"])
            if isinstance(kw.get("features"), dict):
                kw["features"] = FeatureConfig(**kw["features"])
            cfg = PipelineConfig(**kw)
        if dispatch_ahead is None:
            dispatch_ahead = int(host.get("dispatch_ahead", 2))
        det = cls(host["modality_types"], cfg.window_size, cfg=cfg, max_lag=max_lag,
                  dispatch_ahead=dispatch_ahead, device=device)
        det.engine.restore(ckpt.unflatten_like(det.engine.state, leaves), host)
        det._count = int(host["count"])
        det._window_index = int(host["window_index"])
        det._prev_clusters = host["prev_clusters"]
        det._seen_events = set(host["seen_events"])
        tail = host["tail"]
        if tail is not None and len(tail) and len(tail[0]):
            det._rchunks = [[np.asarray(t)] for t in tail]
            det._ret_len = len(tail[0])
            det._ret_start = det._count - det._ret_len
        return det
