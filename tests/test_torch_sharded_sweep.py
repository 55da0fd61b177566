"""The sweep-level scale-out (``mused_tpu_torch/parallel/sweep``) and the
driver's ``run_experiment(parallel=True)`` on two CPU devices, against the
sequential sweep: every point's metrics equal (processing times aside),
the reference's measured-noise-rate quirk chained as the sequential driver
chains it (reference main.py:196), the points in order.  Then the CLI's
demo on 2 gloo ranks with ``--data-shards 2`` (the row-sharded dense step),
as ``torchrun --nproc-per-node 2`` would run it: rank 0 alone writes the
log and tee files, and every rank logs the single-process demo's sSVDMC
metrics (the distributed SVD and row-sharded k-means reproduce one device
up to summation order; SWFDMC's merged per-shard sketches are another valid
FD sketch, so its metrics are held to their range, as the JAX package's
tests hold them).
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from mused_tpu_torch import api as tapi
from mused_tpu_torch import main as tmain
from mused_tpu_torch.data.synthetic import crisis_embedding_stream, synthetic_events
from mused_tpu_torch.parallel import sweep

CPUS = [torch.device("cpu"), torch.device("cpu")]


def _point(noise_rate, device):
    """One independent pipeline run (tests/test_parallel.py's sweep point)."""
    mods, mtypes, labels = crisis_embedding_stream(n_rows=128, n_events=3,
                                                   noise_rate=noise_rate, d_text=16,
                                                   d_image=16, seed=2)
    with contextlib.redirect_stdout(io.StringIO()):
        res = tapi.process_streaming_data(
            results=tapi.get_initial_results()[0], data_modalities=mods,
            modality_types=mtypes, window_size=64, reduced_dim=8, k_basis=3,
            n_clusters_total=4, seed=0, approach="sSVDMC", complete_true_labels=labels,
            step_window_ratio=1, noise_rate=noise_rate, label_mode="all", sorting=False,
            eps=1.5, min_samples=2, device=device)
    return res["nmi_score"][0], res["f1_score"][0]


def test_parallel_sweep_on_two_cpu_devices_equals_the_sequential_sweep():
    rates = [0.2, 0.4, 0.6, 0.8]
    seq = [_point(r, "cpu") for r in rates]
    par = sweep.parallel_sweep(_point, rates, CPUS)
    np.testing.assert_allclose(par, seq, atol=1e-6)


def test_parallel_sweep_raises_after_every_point_ran():
    done = []

    def point(i, device):
        if i == 1:
            raise RuntimeError("point 1")
        done.append(i)
        return i

    with pytest.raises(RuntimeError, match="point 1"):
        sweep.parallel_sweep(point, range(5), CPUS)
    assert sorted(done) == [0, 2, 3, 4]


def test_sweep_devices():
    assert sweep.sweep_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sweep.sweep_devices("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            sweep.parallel_sweep(lambda p, d: p, [1])


@pytest.mark.parametrize("experiment,values", [("noise_rate", [0.3, 0.6]),
                                               ("sorting", [False, True])])
def test_run_experiment_parallel_equals_sequential(experiment, values, tmp_path,
                                                   monkeypatch):
    """Two CPU devices, two approaches: the logged metrics and the details
    string (which carries the last measured noise rate) equal the
    sequential run's."""
    df = synthetic_events(n_rows=400, n_events=4, noise_rate=0.5, seed=0)
    fixed = {"seed": 0, "subset_size": 128, "noise_rate": 0.5, "label_mode": "binary",
             "sorting": False, "window_size": 32, "reduced_dim": 4, "k_basis": 2,
             "step_window_ratio": 1}
    logged = {}

    def capture(name):
        def log_metrics(**kw):
            logged[name] = kw
        return log_metrics

    monkeypatch.setattr(tmain.output, "visualize_results", lambda **kw: [])
    monkeypatch.setattr(tmain.sweep, "sweep_devices", lambda device: CPUS)
    for name, parallel in (("seq", False), ("par", True)):
        monkeypatch.setattr(tmain.output, "log_metrics", capture(name))
        with contextlib.redirect_stdout(io.StringIO()):
            assert tmain.run_experiment(df, experiment, values, ["SWFDMC", "sSVDMC"],
                                        dict(fixed), 0, log_dir=str(tmp_path),
                                        plot_dir=str(tmp_path), parallel=parallel,
                                        device="cpu") == 1
    seq, par = logged["seq"], logged["par"]
    assert par["string_to_add"] == seq["string_to_add"]
    assert list(par["metrics"]) == list(seq["metrics"]) == ["SWFDMC", "sSVDMC"]
    for approach, want in seq["metrics"].items():
        got = par["metrics"][approach]
        assert got.keys() == want.keys()
        for key in want:
            if key != "processing_time":
                assert got[key] == pytest.approx(want[key], abs=1e-6), (approach, key)


def test_cli_on_two_ranks_writes_its_files_once(tmp_path, monkeypatch):
    import torch_dist
    args = ["--approaches", "SWFDMC", "sSVDMC"]
    ranks = torch_dist.start("cli_demo", {"cwd": str(tmp_path / "ranks"),
                                          "args": args + ["--data-shards", "2"]}, world=2)
    (tmp_path / "ranks").mkdir()
    (tmp_path / "one").mkdir()
    monkeypatch.chdir(tmp_path / "one")
    logged = []
    log_metrics = tmain.output.log_metrics
    monkeypatch.setattr(tmain.output, "log_metrics",
                        lambda **kw: logged.append(kw["metrics"]) or log_metrics(**kw))
    with contextlib.redirect_stdout(io.StringIO()):
        assert tmain.cli(["--dataset", "demo", "--device", "cpu", "--no-tee", *args]) == 0
    out = ranks.join(180)
    files = sorted(os.listdir(tmp_path / "ranks" / "logs"))
    assert len([f for f in files if f.startswith("exp=")]) == 1      # the sweep's log
    assert len([f for f in files if not f.startswith("exp=")]) == 1  # rank 0's tee
    for res in out:
        assert res["rc"] == 0 and len(res["metrics"]) == len(logged) == 1
        got, want = res["metrics"][0], logged[0]
        for key in want["sSVDMC"]:
            if key != "processing_time":
                assert got["sSVDMC"][key] == pytest.approx(want["sSVDMC"][key], abs=1e-6), key
        assert all(0.0 <= v <= 1.0 for v in got["SWFDMC"]["nmi_score"] + got["SWFDMC"]["f1_score"])
        assert _without_times(got) == _without_times(out[0]["metrics"][0])


def _without_times(metrics):
    return {a: {k: v for k, v in r.items() if k != "processing_time"}
            for a, r in metrics.items()}
