"""The benchmark's files resolve by name, its metrics' arrows point at
end-to-end metrics their cells report, and nothing under portbench/ loads
JAX or the JAX package (nor, in the reference, the port)."""
from __future__ import annotations

import ast
import json
import pathlib

import pytest

from portbench import harness

ROOT = pathlib.Path(harness.ROOT)
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _imports(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell, BENCH)
    assert c.config["name"] == next(w for w in BENCH["workloads"] if w["name"] == cell)["config"]
    assert harness.driver_of(c).Driver
    assert c.traffic["limits"]
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader_and_a_reported_arrow(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(harness.metric_reader(metric))
    e2e = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
    for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
        assert cell in e2e.get("workloads", [cell]), (metric, cell)


def test_every_config_file_lies_under_paths_and_lists_its_cuts():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]


def test_every_traffic_file_names_a_generator():
    for w in BENCH["workloads"]:
        t = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "drivers" / f"{t['generator']}.py").exists()


def test_no_module_loads_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & harness.BANNED, path


def test_the_reference_and_the_yardstick_load_nothing_of_the_port():
    for sub in ("reference", "roofline", "gen"):
        for path in (ROOT / "portbench" / sub).rglob("*.py"):
            assert "mused_tpu_torch" not in _imports(path), path


def test_the_banned_check_compares_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setattr(sys, "modules", {"mused_tpu_torch.engine": None, "numpy": None,
                                         "jaxtyping": None})
    assert harness.banned_modules() == []
    monkeypatch.setattr(sys, "modules", {"mused_tpu.ops": None, "jax.numpy": None})
    assert harness.banned_modules() == ["jax", "mused_tpu"]


NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.\-]{1,16}$"
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_benchmark_json_keeps_to_its_format():
    import re
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for section, keys in KEYS.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            assert set(e) - {"workloads"} == keys, (section, e["name"])
            assert re.match(NAME, e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert re.match(UNIT, e["unit"]) and e["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
