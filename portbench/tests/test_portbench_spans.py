"""The readers of the program's spans (``portbench/spans.py``) on
hand-built records: serving's median of per-window sums, the mean per
window or call, device extents and counters, and None where nothing was
recorded (as from a program without the recorder)."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import harness, spans


def rec(name, key, ms, device_ms=None, counters=None):
    return SimpleNamespace(name=name, key=key, start_ns=1_000, end_ns=1_000 + int(ms * 1e6),
                           device_ms=device_ms, counters=counters)


RECORDS = [
    rec("serving.window", 0, 380.0), rec("serving.window", 1, 390.0),
    rec("serving.window", 2, 400.0), rec("serving.window", 3, 1000.0),
    rec("featurize", 0, 10.0), rec("featurize", 0, 2.0), rec("featurize", 1, 30.0),
    rec("engine.reduce", 0, 1.0, device_ms=3000.0), rec("engine.reduce", 1, 1.0, 5000.0),
    rec("engine.reduce", 2, 1.0, None),
    rec("memory.device_allocs", 0, 0.0, counters={"memory.device_allocs": 6}),
    rec("memory.device_allocs", 1, 0.0, counters={"memory.device_allocs": 2}),
]


def test_per_key_sums_each_windows_spans():
    assert spans.per_key(RECORDS, "featurize") == pytest.approx({0: 12.0, 1: 30.0})
    assert spans.per_key(RECORDS, "engine.reduce", spans.device_ms) == {0: 3000.0,
                                                                        1: 5000.0}


def test_serving_reads_the_median_over_windows():
    assert spans.p50_per_key(RECORDS, "serving.window") == pytest.approx(395.0)
    assert spans.p50_per_key(RECORDS, "featurize") == pytest.approx(21.0)
    assert spans.p50_per_key(RECORDS, "serving.held") is None


def test_the_others_read_the_mean_per_unit():
    assert spans.mean_per_unit(RECORDS, "featurize", 2) == pytest.approx(21.0)
    assert spans.mean_per_unit(RECORDS, "featurize", 4) == pytest.approx(10.5)
    assert spans.mean_per_unit(RECORDS, "engine.reduce", 2,
                               spans.device_ms) == pytest.approx(4000.0)
    assert spans.mean_per_unit(RECORDS, "memory.device_allocs", 2,
                               spans.counted("memory.device_allocs")) == pytest.approx(4.0)
    assert spans.mean_per_unit(RECORDS, "featurize", 0) is None
    assert spans.mean_per_unit([], "featurize", 3) is None


def test_the_metric_readers_divide_by_the_runs_windows_or_calls(monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: RECORDS)
    huge = SimpleNamespace(windows=2, attempted=2)
    batch = SimpleNamespace(windows=0, attempted=4)
    assert spans.serving_window_ms(huge) == pytest.approx(395.0)
    assert spans.huge_featurize_ms(huge) == pytest.approx(21.0)
    assert spans.batch_featurize_ms(batch) == pytest.approx(10.5)
    assert spans.batch_reduce_ms(batch) == pytest.approx(2000.0)
    assert spans.huge_device_allocs(huge) == pytest.approx(4.0)
    assert harness.metric_reader("serving.window_ms.serve")(huge) == pytest.approx(395.0)
    assert harness.metric_reader("engine.reduce_ms.batch")(batch) == pytest.approx(2000.0)


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: [])
    run = SimpleNamespace(windows=3, attempted=3)
    for name in ("serving.window_ms.serve", "engine.ingest_wait_ms.huge",
                 "memory.device_allocs.huge", "engine.columns_ms.batch"):
        assert harness.metric_reader(name)(run) is None
