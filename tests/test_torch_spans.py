"""The port's span recorder (``mused_tpu_torch/utils/profiling``) and the
spans the three measured paths record.

  * recording is off by default: a span makes no event, no range in the
    profiler's trace and no record, and an interval or a counter no record;
  * under ``torch.profiler`` a span on the profiling thread is a host range
    (a ``RecordFunction``) that starts within 1 ms of the record's
    ``start_ns`` (one clock); a worker thread's span is recorded with its
    thread and key, and is no range;
  * a ``device=True`` span times two CUDA events and resolves ``device_ms``
    only once the end event has completed, never by waiting (``SpanTimer``'s
    records: ``test_torch_host_reads.py``);
  * the ring keeps the newest ``RING_SIZE`` records;
  * a CPU ``StreamDetector`` (window 64) gives each window a
    ``serving.window`` whose five children share its key, lie in it in
    order and cover it; ``process_batch_data`` gives ``batch.call`` and its
    five children; ``process_streaming_data`` records each window's
    ``featurize`` in the ingest thread and ``ingest.wait`` in the loop.

The file imports no JAX (on a machine without it: ``--noconftest``); its
last case needs a card and skips without one.
"""
import collections
import contextlib
import io
import threading
import time

import pytest
import torch

from mused_tpu_torch import api
from mused_tpu_torch.data.synthetic import make_stream
from mused_tpu_torch.serving import StreamDetector
from mused_tpu_torch.utils import profiling
from mused_tpu_torch.utils.config import PipelineConfig

W = 64
SERVING_CHILDREN = ("serving.queue_wait", "featurize", "engine.enqueue", "serving.held",
                    "serving.finalize")
BATCH_CHILDREN = ("featurize", "engine.columns", "engine.reduce", "engine.cluster",
                  "match.metrics")


@pytest.fixture(autouse=True)
def _empty_ring():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def stream():
    return make_stream(512, n_events=4, noise_rate=0.5, seed=0)


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def test_recording_is_off_by_default(monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "_HostRange", lambda *a, **k: made.append("range"))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append("event"))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not profiling.on()
    with profiling.span("a", key=1, device=True) as s:
        pass
    assert s is None
    profiling.interval("b", 0, 1, key=1)
    profiling.counter("c", 3, key=1)
    timer = profiling.SpanTimer("cpu")
    with timer.span("fuse"):
        pass
    assert made == [] and profiling.recorded() == []
    assert timer.summary()["fuse"]["count"] == 1


def test_a_span_under_the_profiler_is_a_host_range_on_its_clock():
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        assert profiling.on()
        for i in range(3):          # the first calls pay for set-up
            with profiling.span("spans.test", key=i):
                time.sleep(0.002)
    assert not profiling.on()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "spans.test"]
    recs = [r for r in profiling.recorded() if r.name == "spans.test"]
    assert len(events) == len(recs) == 3
    for ev, rec in zip(sorted(events, key=lambda e: e.start_ns()), recs):
        assert abs(ev.start_ns() - rec.start_ns) < 1_000_000
        assert rec.start_ns <= ev.start_ns() and ev.end_ns() <= rec.end_ns
        assert rec.thread == threading.current_thread().name and rec.parent is None


def test_a_worker_threads_span_is_recorded_with_its_thread_and_key():
    def work():
        with profiling.span("spans.worker", key=7):
            with profiling.span("spans.inner"):
                profiling.counter("spans.count", 5)

    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        t = threading.Thread(target=work, name="spans-worker")
        t.start()
        t.join()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "spans.worker" not in names       # only the profiling thread's spans
    recs = {r.name: r for r in profiling.recorded()}
    assert set(recs) == {"spans.worker", "spans.inner", "spans.count"}
    assert all(r.thread == "spans-worker" and r.key == 7 for r in recs.values())
    assert recs["spans.inner"].parent == "spans.worker"
    assert recs["spans.count"].parent == "spans.inner"
    assert recs["spans.count"].counters == {"spans.count": 5}
    assert recs["spans.worker"].counters is None and recs["spans.worker"].ms >= 0


class _FakeEvent:
    done = False
    log: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = len(self.log)
        self.log.append("record")

    def query(self):
        self.log.append("query")
        return _FakeEvent.done

    def elapsed_time(self, end):
        return 2.5 * (end.t - self.t)

    def synchronize(self):
        raise AssertionError("a span never waits for the device")


def test_device_spans_resolve_after_completion_and_never_wait(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(a))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "log", [])
    with profiling.recording():
        with profiling.span("spans.device", device=True):
            pass
        with profiling.span("spans.host"):
            pass
    dev, host = profiling.recorded()
    assert _FakeEvent.log == ["record", "record"]
    assert dev.device_ms is None                 # not yet complete: not waited for
    monkeypatch.setattr(_FakeEvent, "done", True)
    assert dev.device_ms == 2.5 and dev.device_ms == 2.5
    assert host.device_ms is None and syncs == []


def test_the_ring_keeps_the_newest_records():
    with profiling.recording():
        for i in range(profiling.RING_SIZE + 5):
            profiling.interval("spans.ring", i, i + 1, key=i)
    recs = profiling.recorded()
    assert len(recs) == profiling.RING_SIZE
    assert recs[0].key == 5 and recs[-1].key == profiling.RING_SIZE + 4


def test_each_served_window_is_tiled_by_its_five_children(stream):
    mods, mtypes, _ = stream
    cfg = PipelineConfig(approach="sSVDMC", window_size=W, reduced_dim=8, k_basis=3,
                         label_mode="all", n_clusters_override=6, k_estimate="eigengap")
    det = StreamDetector(mtypes, W, cfg=cfg, device="cpu")
    with profiling.recording():
        out = []
        for lo in range(0, len(mods[0]), 48):
            out.extend(det.push([m[lo:lo + 48] for m in mods]))
        out.extend(det.flush())
    by_key = collections.defaultdict(dict)
    for r in profiling.recorded():
        if r.name == "serving.window" or r.parent == "serving.window":
            assert r.name not in by_key[r.key]
            by_key[r.key][r.name] = r
    assert sorted(by_key) == [r.window_index for r in out] == list(range(len(out)))
    caller = threading.current_thread().name
    covered = total = 0
    for key, spans in by_key.items():
        root = spans.pop("serving.window")
        assert root.parent is None and root.thread == caller
        assert set(spans) == set(SERVING_CHILDREN)
        kids = [spans[n] for n in SERVING_CHILDREN]
        assert kids[0].thread == kids[1].thread == kids[2].thread == "serving-dispatch"
        assert kids[3].thread == kids[4].thread == caller
        at = root.start_ns
        for k in kids:                            # in order, inside the root
            assert at <= k.start_ns <= k.end_ns <= root.end_ns, (key, k)
            at = k.end_ns
        assert kids[0].start_ns == root.start_ns
        covered += sum(k.end_ns - k.start_ns for k in kids)
        total += root.end_ns - root.start_ns
    assert covered >= 0.97 * total


def test_a_batch_call_records_its_five_children(stream):
    mods, mtypes, labels = stream
    cfg = PipelineConfig(force_blocked_batch=True, reduced_dim=8, k_basis=3, window_size=W,
                         subset_size=len(labels))
    with profiling.recording():
        for _ in range(2):
            _quiet(api.process_batch_data, api.get_initial_results()[0], mods, mtypes, 8, 3,
                   2, 0, "SVDMC_batch", labels, 0.5, "binary", True, 1.5, 2, 3, W, cfg=cfg,
                   device="cpu")
    recs = profiling.recorded()
    roots = [r for r in recs if r.name == "batch.call"]
    assert len(roots) == 2 and roots[1].key == roots[0].key + 1
    for root in roots:
        kids = [r for r in recs if r.key == root.key and r.parent == "batch.call"]
        assert [k.name for k in kids] == list(BATCH_CHILDREN)
        at = root.start_ns
        for k in kids:
            assert at <= k.start_ns <= k.end_ns <= root.end_ns
            at = k.end_ns
        assert sum(k.ms for k in kids) >= 0.95 * root.ms
        assert all(k.device_ms is None for k in kids)      # no device off the card


def test_the_offline_stream_records_featurize_and_the_ingest_wait(stream):
    mods, mtypes, labels = stream
    with profiling.recording():
        _quiet(api.process_streaming_data, api.get_initial_results()[0], mods, mtypes, W, 8,
               3, 2, 0, "sSVDMC", labels, 1, 0.5, "binary", True, 1.5, 2, device="cpu")
    recs = profiling.recorded()
    n = len(mods[0]) // W
    feats = [r for r in recs if r.name == "featurize"]
    waits = [r for r in recs if r.name == "ingest.wait"]
    assert sorted(r.key for r in feats) == [r.key for r in waits] == list(range(n))
    assert all(r.thread.startswith("ingest") for r in feats)
    assert all(r.thread == threading.current_thread().name for r in waits)
    assert not [r for r in recs if r.name == "memory.device_allocs"]    # a card's count


@pytest.mark.cuda
def test_device_extents_and_allocator_calls_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: device extents and the allocator's calls need a card")
    x = torch.randn(2048, 2048, device="cuda")
    x = x @ x / 2048                 # the first product loads the library
    torch.cuda.synchronize()
    with profiling.recording():
        with profiling.span("spans.matmul", device=True):
            for _ in range(8):
                x = x @ x / 2048
    rec = profiling.recorded()[0]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(8):
        x = x @ x / 2048
    end.record()
    torch.cuda.synchronize()
    assert rec.device_ms is not None and 0 < rec.device_ms < 20 * start.elapsed_time(end)
    mods, mtypes, labels = make_stream(4096, n_events=4, noise_rate=0.5, seed=0)
    cfg = PipelineConfig(approach="sSVDMC", window_size=2048, reduced_dim=8, k_basis=3,
                         force_blocked_window=True, label_mode="binary",
                         n_clusters_override=2, subset_size=4096)
    torch.cuda.empty_cache()
    with profiling.recording():
        _quiet(api.process_streaming_data, api.get_initial_results()[0], mods, mtypes, 2048,
               8, 3, 2, 0, "sSVDMC", labels, 1, 0.5, "binary", True, 1.5, 2, cfg=cfg)
    allocs = [r for r in profiling.recorded() if r.name == "memory.device_allocs"]
    assert [r.key for r in allocs] == [0, 1]
    assert allocs[0].counters["memory.device_allocs"] > 0      # from an emptied cache
