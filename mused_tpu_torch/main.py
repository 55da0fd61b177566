"""Experiment sweep driver + CLI of the port — ``mused_tpu/main.py`` on
PyTorch (the reference's L5 layer, main.py:169-365).

    python -m mused_tpu_torch.main --dataset demo --device cpu --no-tee

``run_experiment`` sweeps one variable across approaches, logging and
plotting per sweep; ``cli`` iterates the experiment types with every flag
and default of the JAX package's CLI, plus ``--device`` (default ``cuda``,
the entry points' ``device``).  Kept reference quirks: the measured noise
rate overwrites the requested one and carries across sweep values
(reference main.py:196); the eps / min_samples / min_cluster_size
constants (main.py:200); the second pass with label mode ``types``
(main.py:340-358).  ``--dataset demo`` runs the reference's demo config on
``--device`` (the JAX package forces its CPU backend there).
``--parallel-sweep`` evaluates a sweep's points concurrently, one per card
(``parallel/sweep``).  ``--data-shards p`` runs every point SPMD over p
ranks, one per card, started by the caller:

    torchrun --nproc-per-node p -m mused_tpu_torch.main --data-shards p

(each rank binds ``cuda:LOCAL_RANK``); rank 0 alone writes the logs, plots
and tee files.  ``--windows-per-batch W`` dispatches W windows per group
(the engine's scanned multi-window dispatch), with ``--data-shards`` too.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from mused_tpu_torch.data import sed2012, synthetic
from mused_tpu_torch.engine.batch import process_batch_data
from mused_tpu_torch.engine.streaming import process_streaming_data
from mused_tpu_torch.parallel import sweep
from mused_tpu_torch.utils import metrics as metrics_mod, output, tee
from mused_tpu_torch.utils.config import APPROACHES, PipelineConfig

EXPERIMENT_DEFAULTS = {
    # reference main.py:262-269
    "subset_size": [100000, 110000, 120000, 130000, 140000, 150000],
    "label_mode": ["binary", "types", "all"],
    "noise_rate": [0.05, 0.25, 0.50, 0.75, 0.95],
    "sorting": [False, True],
    "window_size": [500, 1000, 2000, 4000],
    "reduced_dim": [10, 20, 30, 40, 50, 60, 70, 80, 90, 100],
    "k_basis": [10, 20, 30, 40, 50, 60, 70, 80, 90, 100],
}

DEFAULT_PARAMS = {
    # reference main.py:303-313
    "seed": 0,
    "subset_size": 150000,
    "noise_rate": 0.95,
    "label_mode": "binary",
    "sorting": False,
    "window_size": 2000,
    "reduced_dim": 50,
    "k_basis": 50,
    "step_window_ratio": 1,
}


def _prepare(df, params):
    return sed2012.prepare_modalities(
        df=df, subset_size=params["subset_size"],
        binary=(params["label_mode"] == "binary"),
        event_types=(params["label_mode"] != "all"),
        sort_by_uploaded=params["sorting"], noise_rate=params["noise_rate"],
        seed=params["seed"])


def _measured_noise_rate(df, params) -> float:
    """The noise share ``prepare_modalities`` actually delivers for
    ``params``: the value the reference writes back into the sweep params
    (main.py:196)."""
    _, _, truth_labels = _prepare(df, params)
    return float(np.sum(truth_labels == 0) / len(truth_labels))


def _eval_sweep_point(df, params, approach, results, engine_opts: dict | None,
                      device="cuda"):
    """One (approach, variable value) sweep point on ``device``: prepare the
    modalities, run the engine, append one row to ``results``.  Returns the
    measured noise rate (the reference's params-mutation quirk)."""
    modalities, modality_types, truth_labels = _prepare(df, params)
    measured_noise = float(np.sum(truth_labels == 0) / len(truth_labels))

    # the reference constants (config mirrors reference main.py:198-200)
    _d = PipelineConfig(label_mode=params["label_mode"])
    if approach.endswith("_batch"):
        dropped = {k: v for k, v in (engine_opts or {}).items()
                   if v not in (None, False, 1, "allgather", "rows", 0,
                                "auto", "labels", 0.15)}
        if dropped:
            print(f"[{approach}] batch engine ignores streaming engine "
                  f"options: {sorted(dropped)}")
        process_batch_data(
            results=results, data_modalities=modalities, modality_types=modality_types,
            reduced_dim=params["reduced_dim"], k_basis=params["k_basis"],
            n_clusters=_d.n_clusters_total, seed=params["seed"], approach=approach,
            complete_true_labels=truth_labels, noise_rate=measured_noise,
            label_mode=params["label_mode"], sorting=params["sorting"], eps=_d.eps,
            min_samples=_d.min_samples, min_cluster_size=_d.min_cluster_size,
            window_size=params["window_size"], device=device)
    else:
        process_streaming_data(
            results=results, data_modalities=modalities, modality_types=modality_types,
            window_size=params["window_size"], reduced_dim=params["reduced_dim"],
            k_basis=params["k_basis"], n_clusters_total=_d.n_clusters_total,
            seed=params["seed"], approach=approach, complete_true_labels=truth_labels,
            step_window_ratio=params["step_window_ratio"], noise_rate=measured_noise,
            label_mode=params["label_mode"], sorting=params["sorting"], eps=_d.eps,
            min_samples=_d.min_samples, device=device, **(engine_opts or {}))
    return measured_noise


def run_experiment(df, experiment_type, variable_values, approaches, fixed_params, count,
                   log_dir="logs/", plot_dir="plots/", engine_opts: dict | None = None,
                   parallel: bool = False, *, device="cuda"):
    """One sweep: variable x approaches (reference main.py:169-256), on
    ``device``; ``df`` is a column table (``data/sed2012``).  Returns
    ``count + 1``.

    ``parallel=True`` evaluates the (approach, value) grid concurrently, one
    point per device of :func:`sweep.sweep_devices` (every card for a bare
    ``"cuda"``), in two phases so the merged results equal the sequential
    sweep's: phase 1 walks the sweep order data-only, chaining the
    reference's measured-noise-rate quirk (main.py:196) through one
    ``prepare_modalities`` per point; phase 2 runs the points in parallel,
    each with its phase-1 parameter snapshot."""
    print(f"Running {experiment_type} experiment.")
    print(f"Fixed params: {fixed_params}")
    start_ns = time.time_ns()
    params = fixed_params.copy()
    metrics: dict = {}
    if parallel:
        # phase 1: the quirk's chain in the sequential order, engine-free; in
        # a noise_rate sweep the next value overwrites each measurement before
        # anything reads it, so only the last point's is measured
        points = []
        n_points = len(approaches) * len(variable_values)
        for approach in approaches:
            for var_value in variable_values:
                params[experiment_type] = var_value
                points.append((approach, var_value, params.copy()))
                if experiment_type != "noise_rate" or len(points) == n_points:
                    params["noise_rate"] = _measured_noise_rate(df, params)

        def eval_point(point, dev):
            approach, _, p = point
            results_p, _ = metrics_mod.get_initial_results()
            return results_p, _eval_sweep_point(df, p, approach, results_p, engine_opts,
                                                dev)

        # phase 2: independent engine runs, one per device
        outs = sweep.parallel_sweep(eval_point, points, sweep.sweep_devices(device))
        independent_variables = metrics_mod.get_initial_results()[1]
        for ai, approach in enumerate(approaches):
            merged, _ = metrics_mod.get_initial_results()
            for vi in range(len(variable_values)):
                part, _ = outs[ai * len(variable_values) + vi]
                for key, vals in part.items():
                    merged[key].extend(vals)
            metrics[approach] = merged
        # params carries the last point's measured rate from phase 1, as the
        # sequential quirk leaves it for the details string (phase 2 measured
        # the same)
        assert abs(params["noise_rate"] - outs[-1][1]) < 1e-12
    else:
        for approach in approaches:
            results, independent_variables = metrics_mod.get_initial_results()
            approach_start = time.time_ns()
            for var_value in variable_values:
                params[experiment_type] = var_value
                print(f"Running experiment with {experiment_type} = {var_value} "
                      f"for {approach} approach")
                print(f"Params: {params}")
                # quirk kept: the measured noise rate overwrites the request and
                # persists across sweep values (reference main.py:196)
                params["noise_rate"] = _eval_sweep_point(df, params, approach, results,
                                                         engine_opts, device)
            approach_sec = (time.time_ns() - approach_start) / 1e9
            print(f"Processed with {approach} approach for {approach_sec} seconds")
            metrics[approach] = results

    details = (f'mode={params["label_mode"]},sorted={params["sorting"]},'
               f'noise={params["noise_rate"]},window={params["window_size"]},'
               f'subset={params["subset_size"]},dim={params["reduced_dim"]},'
               f'k={params["k_basis"]}')
    output.log_metrics(metrics=metrics, independent_variable=experiment_type,
                       string_to_add=details, save_path=log_dir)
    output.visualize_results(metrics=metrics, independent_variable=experiment_type,
                             independent_variables=independent_variables,
                             string_to_add=details, save_path=plot_dir)
    minutes = (time.time_ns() - start_ns) / 1e9 / 60
    print(f"Finished exp={experiment_type},{details} after {minutes} minutes")
    return count + 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mused-tpu-torch",
        description="Multimodal unsupervised streaming event detection (PyTorch + CUDA)")
    p.add_argument("--dataset", choices=["sed2012", "synthetic", "demo"], default="sed2012",
                   help="sed2012 needs dataset/sed2012/ (see setup_datasets.sh); "
                        "synthetic/demo generate data")
    p.add_argument("--dataset-dir", default=sed2012.DATASET_DIR)
    p.add_argument("--max-records", type=int, default=None,
                   help="bound the SED2012 XML parse to the first N photo records")
    p.add_argument("--experiments", nargs="+",
                   default=["subset_size", "label_mode", "noise_rate", "sorting"],
                   choices=list(EXPERIMENT_DEFAULTS))
    p.add_argument("--approaches", nargs="+", default=list(APPROACHES[:6]),
                   choices=list(APPROACHES))
    for k, v in DEFAULT_PARAMS.items():
        flag = "--" + k.replace("_", "-")
        if isinstance(v, bool):
            p.add_argument(flag, type=lambda s: s.lower() in ("1", "true"), default=v)
        elif isinstance(v, float):
            p.add_argument(flag, type=float, default=v)
        elif isinstance(v, str):
            p.add_argument(flag, type=str, default=v)
        else:
            p.add_argument(flag, type=int, default=v)
    p.add_argument("--second-pass-label-mode", default="types",
                   help="reference runs the full sweep twice, second pass with "
                        "this label mode (main.py:340-358); 'none' disables")
    p.add_argument("--log-dir", default="logs/")
    p.add_argument("--plot-dir", default="plots/")
    p.add_argument("--no-tee", action="store_true")
    p.add_argument("--data-shards", type=int, default=1,
                   help="run each sweep point SPMD over this many ranks, one per card "
                        "(start them with torchrun --nproc-per-node N)")
    p.add_argument("--merge-topology", choices=["allgather", "ring"], default="allgather",
                   help="multi-device FD sketch merge")
    p.add_argument("--huge-window-layout", choices=["rows", "columns", "grid"],
                   default="rows",
                   help="multi-device huge-window sweep layout: rows = replicated "
                        "features, row blocks sharded; columns = features "
                        "column-sharded (capacity); grid = col-shards x row-groups")
    p.add_argument("--huge-window-col-shards", type=int, default=0,
                   help="grid layout: how many of data-shards shard the feature "
                        "columns (must divide it; 0 = balanced auto factorization)")
    p.add_argument("--huge-window-cand-fold", choices=["auto", "on", "off"],
                   default="auto",
                   help="huge-window SWFDMC: absorb candidate-form blocks (K4 / K5); "
                        "auto = on for a CUDA device when every modality is eligible")
    p.add_argument("--windows-per-batch", type=int, default=None,
                   help="dispatch this many tumbling windows per device group (the "
                        "same labels as per-window dispatch; one label pull per "
                        "group). Default: auto, which is per-window on the card and "
                        "the CPU")
    p.add_argument("--matching", default="auto",
                   choices=["auto", "hungarian", "pot", "centroid"],
                   help="cross-window cluster-ID matching: auto = reference "
                        "behavior (positional overlap, pot for sSVDMC_pot else "
                        "hungarian); centroid = nearest-centroid registry in input "
                        "feature space (numeric streams)")
    p.add_argument("--k-estimate", default="labels", choices=["labels", "fixed", "eigengap"],
                   help="per-window cluster-count source: labels = reference quirk "
                        "(main.py:41); fixed = n_clusters_total; eigengap = "
                        "unsupervised estimate from the reduced window's spectrum")
    p.add_argument("--eigengap-theta", type=float, default=0.15,
                   help="eigengap_k strong-secondary-gap veto threshold")
    p.add_argument("--background-bucket", action="store_true",
                   help="label the far mode of the distance-to-centroid distribution "
                        "-1 (no event) instead of forcing it into a cluster")
    p.add_argument("--parallel-sweep", action="store_true",
                   help="evaluate the sweep's (approach, value) grid concurrently, "
                        "one point per card (parallel/sweep)")
    p.add_argument("--verbose", action="store_true",
                   help="small-window debug oracles (the reference's subset<1000 "
                        "prints, main.py:35-103)")
    p.add_argument("--device", default="cuda",
                   help="where the engines run: cuda (default) or cpu")
    return p


def load_dataframe(args):
    """The sweep's column table.  ``synthetic`` sizes its pool as the JAX
    package does (twice the largest subset, half noise, so every sweep noise
    rate samples a full subset) and builds it with the port's numpy
    generator, whose rows differ from the JAX package's frame for the same
    seed (below 20,000 rows the JAX package draws row by row; above, it
    consumes its generator in another order than the port)."""
    if args.dataset == "sed2012":
        return sed2012.load_sed2012_dataset(args.dataset_dir, max_records=args.max_records)
    biggest = args.subset_size
    if "subset_size" in getattr(args, "experiments", []):
        biggest = max(biggest, max(EXPERIMENT_DEFAULTS["subset_size"]))
    n = max(biggest * 2, 400) if args.dataset == "synthetic" else 400
    return synthetic.synthetic_events(n_rows=n, n_events=6, noise_rate=0.5, seed=args.seed)


def _join_ranks(args) -> bool:
    """Under torchrun with ``--data-shards`` > 1 and no process group yet:
    join the ranks' group (NCCL on the card, gloo on the CPU), each rank on
    its own card ``cuda:LOCAL_RANK``.  Returns whether it joined."""
    import os

    import torch
    import torch.distributed as dist
    if args.data_shards <= 1 or dist.is_initialized() or "RANK" not in os.environ:
        return False
    if args.device == "cuda":
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(torch.device(args.device))
    dist.init_process_group("nccl" if args.device.startswith("cuda") else "gloo")
    return True


def cli(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if _join_ranks(args):
        import torch.distributed as dist
        try:
            return _run(args)
        finally:
            dist.destroy_process_group()
    return _run(args)


def _run(args) -> int:
    start_ns = time.time_ns()
    np.random.seed(args.seed)
    if args.dataset == "demo":
        # the reference's demo smoke config (main.py:318-324)
        args.subset_size, args.window_size = 100, 8
        args.noise_rate, args.reduced_dim, args.k_basis = 0.4, 2, 1
        args.experiments = ["label_mode"]
        experiments = {"label_mode": ["binary", "types"]}
    else:
        experiments = {e: EXPERIMENT_DEFAULTS[e] for e in args.experiments}

    df = load_dataframe(args)
    default_params = {k: getattr(args, k) for k in DEFAULT_PARAMS}
    count = 0
    passes = [default_params["label_mode"]]
    if args.second_pass_label_mode not in ("none", default_params["label_mode"]) \
            and args.dataset != "demo":
        passes.append(args.second_pass_label_mode)
    engine_opts = {
        "data_shards": args.data_shards, "merge_topology": args.merge_topology,
        "huge_window_layout": args.huge_window_layout,
        "huge_window_col_shards": args.huge_window_col_shards,
        "huge_window_cand_fold": {"auto": None, "on": True,
                                  "off": False}[args.huge_window_cand_fold],
        "verbose": args.verbose, "matching": args.matching,
        "windows_per_batch": args.windows_per_batch, "k_estimate": args.k_estimate,
        "eigengap_theta": args.eigengap_theta, "background_bucket": args.background_bucket,
    }
    for label_mode in passes:
        for experiment_type, variable_values in experiments.items():
            fixed = default_params.copy()
            fixed["label_mode"] = label_mode
            log_file = None if args.no_tee else tee.setup_logging(args.log_dir)
            try:
                count = run_experiment(df, experiment_type, variable_values,
                                       args.approaches, fixed, count, log_dir=args.log_dir,
                                       plot_dir=args.plot_dir, engine_opts=engine_opts,
                                       parallel=args.parallel_sweep, device=args.device)
            finally:
                if log_file is not None:
                    tee.teardown_logging(log_file)

    minutes = (time.time_ns() - start_ns) / 1e9 / 60
    print(f"Finished running {count} experiments")
    print(f"Total processing time: {minutes} minutes")
    if count:
        print(f"Average per experiment: {minutes / count} minutes")
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
