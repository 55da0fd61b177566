"""Output generation: comparison plots, metric logs, LaTeX tables — the
port's copy of ``mused_tpu/utils/output.py``.

Rebuilds reference output_generation.py (plots :6-32, metric dump :77-87,
LaTeX table :89-122) with the same file layouts so downstream tooling keeps
working: plots under ``plots/<variable>/<metric>_by_<variable>,<details>.png``,
logs under ``logs/exp=<variable>,<details>.txt``, tables under ``tables/``.

The reference's dead ``log_averages`` (crashes at output_generation.py:46 —
``list.remove`` returns None) is reimplemented working, and
``visualize_clusters`` uses the port's randomized SVD instead of sklearn.

Under a torch.distributed process group of more than one rank (an SPMD
sweep under torchrun, where every rank holds the same metrics) only rank 0
writes: the other ranks' calls write nothing and return None.
"""
from __future__ import annotations

import os

import numpy as np

try:
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    HAVE_MPL = True
except ImportError:      # plots degrade gracefully; logs/tables still work
    HAVE_MPL = False


def _writer() -> bool:
    from mused_tpu_torch.parallel.mesh import is_writer
    return is_writer()


def visualize_results(metrics: dict, independent_variable: str,
                      independent_variables, string_to_add: str = "",
                      save_path: str = "plots/"):
    """Per-metric line plots comparing approaches (ref output_generation.py:6-32)."""
    if not _writer():
        return None
    if not HAVE_MPL:
        print("matplotlib unavailable; skipping plots")
        return []
    save_path = os.path.join(save_path, independent_variable)
    os.makedirs(save_path, exist_ok=True)

    first = next(iter(metrics.values()))
    metric_names = [k for k in first.keys() if k not in independent_variables]
    written = []
    for metric_name in metric_names:
        plt.figure(figsize=(10, 6))
        for approach, values in metrics.items():
            if metric_name in values:
                plt.plot(values[independent_variable], values[metric_name],
                         label=approach)
        metric_label = metric_name.replace("_", " ").upper()
        x_label = independent_variable.replace("_", " ").upper()
        if metric_name == "processing_time":
            metric_label += " (s)"
        plt.title(f"{metric_label} BY {x_label} - APPROACH COMPARISON")
        plt.xlabel(x_label)
        plt.ylabel(metric_label)
        plt.legend()
        plt.grid()
        out = os.path.join(
            save_path, f"{metric_name}_by_{independent_variable},{string_to_add}.png")
        plt.savefig(out)
        plt.close()
        written.append(out)
    return written


def log_metrics(metrics: dict, independent_variable: str,
                string_to_add: str = "", save_path: str = "logs/") -> str:
    """Dump per-approach results dicts (ref output_generation.py:77-87)."""
    if not _writer():
        return None
    os.makedirs(save_path, exist_ok=True)
    filename = f"exp={independent_variable},{string_to_add}"
    path = os.path.join(save_path, f"{filename}.txt")
    with open(path, "w") as f:
        f.write(f"{filename}\n\n")
        for approach, values in metrics.items():
            f.write(f"{approach}: {values}\n")
    return path


def log_averages(metrics: dict, independent_variable: str = "window_indices",
                 string_to_add: str = "", save_path: str = "logs/") -> str:
    """Per-approach metric averages as a LaTeX-ish table row dump.

    The reference version is dead code that would crash
    (output_generation.py:46); this one works.
    """
    if not _writer():
        return None
    os.makedirs(save_path, exist_ok=True)
    path = os.path.join(save_path, f"metric_averages{string_to_add}.txt")
    approaches = list(metrics.keys())
    first = next(iter(metrics.values()))
    metric_names = [k for k in first.keys() if k != independent_variable]
    with open(path, "w") as f:
        f.write("Metric Average & " + " & ".join(approaches) + " \\\\\n")
        for metric_name in metric_names:
            vals = []
            for approach in approaches:
                column = [v for v in metrics[approach].get(metric_name, [])
                          if isinstance(v, (int, float, np.floating, np.integer))]
                vals.append(float(np.mean(column)) if column else float("nan"))
            row = metric_name.replace("_", " ").capitalize() + " & "
            row += " & ".join(f"{v:.4f}" for v in vals) + " \\\\\n"
            f.write(row)
    return path


def visualize_clusters(reduced_matrix, clusters, plot_name: str = "cluster_vis",
                       save_path: str = "plots/", string_to_add: str = "", *,
                       device="cuda"):
    """2D scatter of the reduced matrix colored by cluster
    (ref output_generation.py:60-75), projected with the port's randomized
    SVD on ``device``."""
    if not HAVE_MPL or not _writer():
        return None
    import torch
    from mused_tpu_torch.ops import reduction
    os.makedirs(save_path, exist_ok=True)
    x = torch.from_numpy(np.asarray(reduced_matrix, np.float32)).to(device)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(0)
    xy = reduction.svd_reduce(x, 2, gen).cpu().numpy()
    plt.figure()
    plt.scatter(xy[:, 0], xy[:, 1], c=np.asarray(clusters))
    plt.title(f"Cluster Visualization {plot_name}")
    plt.xlabel("x")
    plt.ylabel("y")
    out = os.path.join(save_path, f"{plot_name}{string_to_add}.png")
    plt.savefig(out)
    plt.close()
    return out


def generate_table(metrics: dict, metric: str, independent_variable: str,
                   string_to_add: str = "", save_path: str = "tables/") -> str:
    """LaTeX comparison table (ref output_generation.py:89-122)."""
    if not _writer():
        return None
    os.makedirs(save_path, exist_ok=True)
    path = os.path.join(save_path,
                        f"{metric}_by_{independent_variable},{string_to_add}.txt")
    with open(path, "w") as f:
        f.write("\\begin{table}[h!]\n\\centering\n")
        f.write(f"\\caption{{{metric.replace('_', ' ').capitalize()} by "
                f"{independent_variable.replace('_', ' ').capitalize()}}}\n")
        f.write("\\begin{tabular}{|l|" + "c|" * len(metrics) + "}\n\\hline\n")
        f.write(f"{independent_variable.replace('_', ' ').capitalize()} & "
                + " & ".join(metrics.keys()) + " \\\\\n\\hline\n")
        unique_values = sorted({v for a in metrics.values()
                                for v in a[independent_variable]})
        for uv in unique_values:
            row = [f"{uv}"]
            for approach, values in metrics.items():
                if uv in values[independent_variable]:
                    idx = values[independent_variable].index(uv)
                    row.append(f"{values[metric][idx]:.4f}")
                else:
                    row.append("N/A")
            f.write(" & ".join(row) + " \\\\\n")
        f.write("\\hline\n\\end{tabular}\n\\end{table}\n")
    return path
