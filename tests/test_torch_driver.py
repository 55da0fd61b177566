"""Slice 2g's driver surface against the JAX package (all on the CPU):

  * ``main.build_parser`` has every flag of the JAX CLI with its default and
    choices, plus ``--device``; flags that reach unported parts raise;
  * ``utils/output`` writes byte-identical logs and tables (plots skipped
    without matplotlib), ``utils/tee`` mirrors, nests and unwinds;
  * ``run_experiment`` on the demo config, fed the JAX frame as a column
    table, gives the JAX driver's results with the draws injected;
  * ``python -m mused_tpu_torch.main --dataset demo --device cpu`` runs in a
    process of its own and writes its logs;
  * ``api`` has every public name of the JAX ``api`` with its parameters,
    and ``create_adjacency_matrix`` gives the JAX package's graphs.
"""
import argparse
import contextlib
import inspect
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from mused_tpu import api as japi
from mused_tpu import main as jmain
from mused_tpu.data.synthetic import synthetic_events_dataframe
from mused_tpu.utils import output as joutput
from mused_tpu_torch import api as tapi
from mused_tpu_torch import main as tmain
from mused_tpu_torch.data import sed2012 as tsed
from mused_tpu_torch.utils import output as toutput
from mused_tpu_torch.utils import tee as ttee
from torch_parity import inject_jax_draws, synthetic_window_stream, table_from_dataframe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = {
    "sSVDMC": {"noise_rate": [0.1, 0.5], "f1_score": [0.8, 0.6],
               "processing_time": [1.0, 2.0], "note": ["x", "y"]},
    "SWFDMC": {"noise_rate": [0.1, 0.5], "f1_score": [0.7, 0.65],
               "processing_time": [0.5, 0.9], "note": ["x", "y"]},
}


def _actions(parser) -> dict:
    return {a.dest: a for a in parser._actions if a.dest != "help"}


JAX_FLAGS = sorted(_actions(jmain.build_parser()))


@pytest.mark.parametrize("dest", JAX_FLAGS)
def test_parser_has_the_jax_flag_with_its_default(dest):
    want, got = _actions(jmain.build_parser())[dest], _actions(tmain.build_parser())[dest]
    assert got.option_strings == want.option_strings
    assert got.default == want.default and got.choices == want.choices
    assert got.nargs == want.nargs and type(got) is type(want)
    for text in ("2", "true", "0.5"):       # the same conversions
        if want.type is not None:
            try:
                expected = want.type(text)
            except ValueError:
                continue
            assert got.type(text) == expected


def test_parser_adds_only_device():
    got = _actions(tmain.build_parser())
    assert set(got) - set(JAX_FLAGS) == {"device"}
    assert got["device"].default == "cuda"
    assert tmain.DEFAULT_PARAMS == jmain.DEFAULT_PARAMS
    assert tmain.EXPERIMENT_DEFAULTS == jmain.EXPERIMENT_DEFAULTS


@pytest.mark.parametrize("writer", ["log_metrics", "generate_table", "log_averages"])
def test_output_files_are_byte_identical(writer, tmp_path):
    def call(mod, d):
        if writer == "log_metrics":
            return mod.log_metrics(METRICS, "noise_rate", "mode=binary", save_path=str(d) + "/")
        if writer == "generate_table":
            return mod.generate_table(METRICS, "f1_score", "noise_rate", "x",
                                      save_path=str(d) + "/")
        return mod.log_averages(METRICS, "noise_rate", "", save_path=str(d) + "/")

    a, b = call(joutput, tmp_path / "jax"), call(toutput, tmp_path / "port")
    assert os.path.basename(a) == os.path.basename(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fb.read() == fa.read()


def test_visualize_results_same_files_and_skipped_without_matplotlib(tmp_path, monkeypatch):
    metrics = {k: {m: v for m, v in d.items() if m != "note"} for k, d in METRICS.items()}
    want = joutput.visualize_results(metrics, "noise_rate", ["noise_rate"], "m",
                                     save_path=str(tmp_path / "jax"))
    got = toutput.visualize_results(metrics, "noise_rate", ["noise_rate"], "m",
                                    save_path=str(tmp_path / "port"))
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    monkeypatch.setattr(toutput, "HAVE_MPL", False)
    assert toutput.visualize_results(metrics, "noise_rate", ["noise_rate"]) == []
    assert toutput.visualize_clusters(np.zeros((4, 2)), np.zeros(4)) is None


def test_visualize_clusters_on_the_cpu(tmp_path, rng):
    if not toutput.HAVE_MPL:
        pytest.skip("matplotlib is not installed")
    out = toutput.visualize_clusters(rng.normal(size=(40, 8)), rng.integers(0, 3, 40),
                                     save_path=str(tmp_path) + "/", device="cpu")
    assert os.path.exists(out)


def test_tee_round_trip_and_nesting(tmp_path):
    before = sys.stdout
    outer = ttee.setup_logging(str(tmp_path / "outer"))
    try:
        print("from-outer")
        inner = ttee.setup_logging(str(tmp_path / "inner"))
        try:
            print("from-inner")
        finally:
            ttee.teardown_logging(inner)
        print("outer-again")
    finally:
        ttee.teardown_logging(outer)
    assert sys.stdout is before
    read = {d: open(os.path.join(tmp_path, d, os.listdir(tmp_path / d)[0])).read()
            for d in ("outer", "inner")}
    assert read["inner"] == "from-inner\n"
    assert read["outer"] == "from-outer\nfrom-inner\nouter-again\n"


def test_tee_legacy_raw_file_teardown_and_broken_sinks(tmp_path):
    """teardown_logging with a raw file peels only that file out of the
    fan-out (an outer session keeps logging); a closed sink is skipped."""
    before = sys.stdout
    outer = ttee.setup_logging(str(tmp_path))
    raw = open(tmp_path / "raw.txt", "w")
    sys.stdout = ttee.Fanout(sys.stdout, raw)
    print("both")
    ttee.teardown_logging(raw)
    assert raw.closed and isinstance(sys.stdout, ttee.Fanout)
    print("outer-only")
    closed = open(tmp_path / "closed.txt", "w")
    closed.close()
    assert ttee.Fanout(closed, io.StringIO()).write("x") == 1
    ttee.teardown_logging(outer)
    assert sys.stdout is before and ttee.Tee is ttee.Fanout
    log = [f for f in os.listdir(tmp_path) if f not in ("raw.txt", "closed.txt")][0]
    assert open(tmp_path / log).read() == "both\nouter-only\n"
    assert open(tmp_path / "raw.txt").read() == "both\n"


@pytest.fixture(scope="module")
def demo_frame():
    return synthetic_events_dataframe(n_rows=400, n_events=6, noise_rate=0.5, seed=0)


@pytest.mark.parametrize("label_mode", ["binary", "types"])
def test_run_experiment_demo_matches_jax(label_mode, demo_frame, tmp_path, monkeypatch):
    """The demo config (reference main.py:318-324) through both drivers on
    the same frame: the per-approach results equal (but the seconds), the
    noise-rate quirk and the log file name included."""
    fixed = dict(jmain.DEFAULT_PARAMS, subset_size=100, window_size=8, noise_rate=0.4,
                 reduced_dim=2, k_basis=1, label_mode=label_mode)
    captured = {}

    def run(main_mod, df, d, **kw):
        monkeypatch.setattr(main_mod.output, "log_metrics",
                            lambda metrics, **k: captured.update({d: (metrics, k)}))
        with contextlib.redirect_stdout(io.StringIO()):
            assert main_mod.run_experiment(df, "label_mode", ["binary", "types"],
                                           ["SWFDMC", "sSVDMC"], dict(fixed), 3,
                                           log_dir=str(tmp_path / d),
                                           plot_dir=str(tmp_path / d), **kw) == 4

    run(jmain, demo_frame, "jax")
    inject_jax_draws(monkeypatch)
    run(tmain, table_from_dataframe(demo_frame), "port", device="cpu")
    (want, wkw), (got, gkw) = captured["jax"], captured["port"]
    assert gkw["string_to_add"] == wkw["string_to_add"]
    for approach in ("SWFDMC", "sSVDMC"):
        assert set(got[approach]) == set(want[approach])
        for key, vals in want[approach].items():
            if key != "processing_time":
                assert got[approach][key] == vals, (approach, key)


def test_measured_noise_rate_matches_jax(demo_frame):
    params = dict(jmain.DEFAULT_PARAMS, subset_size=150, noise_rate=0.25)
    assert tmain._measured_noise_rate(table_from_dataframe(demo_frame), params) == \
        jmain._measured_noise_rate(demo_frame, params)


def test_cli_demo_runs_in_its_own_process(tmp_path):
    """The acceptance command, with no JAX in the process."""
    cmd = [sys.executable, "-m", "mused_tpu_torch.main", "--dataset", "demo", "--device",
           "cpu", "--no-tee", "--second-pass-label-mode", "none", "--approaches", "SWFDMC",
           "sSVDMC"]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    logs = os.listdir(tmp_path / "logs")
    assert len(logs) == 1 and logs[0].startswith("exp=label_mode,mode=types")
    body = open(tmp_path / "logs" / logs[0]).read()
    assert "SWFDMC: {" in body and "sSVDMC: {" in body
    assert "Finished running 1 experiments" in out.stdout


@pytest.mark.parametrize("flags,exc,match", [
    # the rows layout runs since slice 4b, over the ranks torchrun starts
    (["--data-shards", "2"], ValueError, "process group of 2 ranks"),
])
def test_cli_flags_of_unported_parts_raise(flags, exc, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(exc, match=match):
        tmain.cli(["--dataset", "demo", "--device", "cpu", "--no-tee", "--approaches",
                   "sSVDMC", *flags])


@pytest.mark.parametrize("flags", [["--parallel-sweep"], ["--merge-topology", "ring"]])
def test_cli_flags_of_slice_4b_run_the_demo_as_the_plain_cli(flags, tmp_path, monkeypatch):
    """``--parallel-sweep`` (one point per device, here the CPU) and the ring
    merge on one device log what the plain demo logs."""
    logs = {}
    for name, extra in (("plain", []), ("flags", flags)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        with contextlib.redirect_stdout(io.StringIO()):
            assert tmain.cli(["--dataset", "demo", "--device", "cpu", "--no-tee",
                              "--approaches", "SWFDMC", "sSVDMC", *extra]) == 0
        (log,) = os.listdir("logs")
        body = open(os.path.join("logs", log)).read()
        logs[name] = re.sub(r"'processing_time': \[[^]]*\]", "", body)
    assert logs["flags"] == logs["plain"]


def test_cli_windows_per_batch_logs_what_the_per_window_cli_logs(tmp_path, monkeypatch):
    """``--windows-per-batch 4`` runs the scanned group dispatch, whose
    metrics equal per-window dispatch's."""
    logs = {}
    for w in ("1", "4"):
        (tmp_path / w).mkdir()
        monkeypatch.chdir(tmp_path / w)
        with contextlib.redirect_stdout(io.StringIO()):
            assert tmain.cli(["--dataset", "demo", "--device", "cpu", "--no-tee",
                              "--approaches", "SWFDMC", "sSVDMC", "--windows-per-batch", w]) == 0
        (log,) = os.listdir("logs")
        body = open(os.path.join("logs", log)).read()
        logs[w] = re.sub(r"'processing_time': \[[^]]*\]", "", body)
    assert logs["4"] == logs["1"]


def test_cli_demo_tees_into_its_log_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = sys.stdout
    with contextlib.redirect_stdout(io.StringIO()):
        assert tmain.cli(["--dataset", "demo", "--device", "cpu", "--approaches", "sSVDMC",
                          "--log-dir", "runs", "--plot-dir", "figs"]) == 0
    assert sys.stdout is before
    files = sorted(os.listdir(tmp_path / "runs"))
    assert any(f.startswith("exp=label_mode") for f in files)
    run_log = [f for f in files if not f.startswith("exp=")][0]
    assert "Running label_mode experiment." in open(tmp_path / "runs" / run_log).read()


def test_synthetic_pool_survives_the_noise_sweep():
    args = argparse.Namespace(dataset="synthetic", subset_size=4000, seed=0, dataset_dir="",
                              experiments=["noise_rate"])
    table = tmain.load_dataframe(args)
    assert len(table["event_id"]) == 8000
    for rate in (0.05, 0.5, 0.95):
        _, _, labels = tsed.prepare_modalities(table, subset_size=4000, noise_rate=rate,
                                               seed=0)
        assert len(labels) == 4000 and int((labels == 0).sum()) == 4000 - int(
            (1 - rate) * 4000)


def _public(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")
            and n not in ("annotations", "np", "torch")}


def test_api_has_every_public_name_of_the_jax_api():
    missing = _public(japi) - _public(tapi)
    assert not missing, missing
    for name in _public(japi):
        want, got = getattr(japi, name), getattr(tapi, name)
        if not callable(want) or inspect.isclass(want):
            continue
        wp = list(inspect.signature(want).parameters)
        gp = list(inspect.signature(got).parameters)
        assert gp[:len(wp)] == wp, name
        assert set(gp[len(wp):]) <= {"device", "cfg", "engine"}, (name, gp)


@pytest.mark.parametrize("modality", ["location", "time", "username", "tags", "text",
                                      "default"])
def test_create_adjacency_matrix_matches_jax(modality):
    mods, types, _ = synthetic_window_stream(seed=2)
    data = (np.random.default_rng(2).normal(size=(96, 6)) if modality == "default"
            else mods[types.index(modality)][:96])
    want = japi.create_adjacency_matrix(data, modality, k_basis=3)
    got = tapi.create_adjacency_matrix(data, modality, k_basis=3, device="cpu")
    assert got.dtype == want.dtype and got.shape == (96, 96)
    np.testing.assert_array_equal(got, want)


def test_reference_matrix_operations(rng):
    graphs = [(rng.random((30, 30)) < p).astype(np.float32) for p in (0.1, 0.2)]
    np.testing.assert_array_equal(tapi.fuse_matrices(graphs), japi.fuse_matrices(graphs))
    x = rng.normal(size=(60, 12)).astype(np.float32)
    x[:30] += 4.0
    got = tapi.perform_svd_reduction(x, 3, 0, device="cpu")
    want = np.asarray(japi.perform_svd_reduction(x, 3, 0))
    assert got.shape == want.shape == (60, 3)
    # U S columns up to sign: the singular values (column norms) agree
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), np.linalg.norm(want, axis=0),
                               rtol=1e-3)
    labels = tapi.perform_clustering(x, 2, 0, device="cpu")
    assert labels.shape == (60,) and len(set(labels[:30])) == len(set(labels[30:])) == 1
    assert tapi.perform_dbscan_clustering_fn(x, eps=2.0, min_samples=3,
                                            device="cpu").shape == (60,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.create_adjacency_matrix(x, "default")
