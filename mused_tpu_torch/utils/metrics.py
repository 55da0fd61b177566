"""Evaluation metrics: the port's copy of ``mused_tpu/utils/metrics.py``.

Copied, not imported (the port runs where the JAX package is absent), with
the original's code and names.  The original's note:

Implemented from the definitions (no sklearn at runtime).  Mirrors
reference metrics_evaluation.py:3-102: weighted F1 / precision / recall, NMI
(arithmetic normalization), NMI_e (events-only NMI, 0 unless both sides
have >= 2 classes), accuracy, MAE, processing time.  Cluster IDs are
treated as class labels directly — meaningful only because cross-window
matching aligns IDs (SURVEY.md §2.4).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

INDEPENDENT_VARIABLES = (
    "subset_size", "noise_rate", "label_mode", "sorting",
    "reduced_dim", "k_basis", "window_size",
)

METRIC_NAMES = (
    "f1_score", "nmi_score", "nmi_e_score", "precision", "recall",
    "accuracy", "mae", "processing_time",
    # extension over the reference schema: F1 under the optimal one-to-one
    # id alignment (see aligned_f1) — recorded alongside the reference-
    # semantics f1_score, whose value depends on the truth's arbitrary id
    # numbering (reference metrics_evaluation.py:69-72)
    "f1_aligned",
)


def get_initial_results():
    """Results schema + independent-variable list (ref metrics_evaluation.py:3-34)."""
    results: Dict[str, List] = {name: [] for name in METRIC_NAMES}
    for var in INDEPENDENT_VARIABLES:
        results[var] = []
    return results, list(INDEPENDENT_VARIABLES)


def _contingency(a: np.ndarray, b: np.ndarray):
    ua, ai = np.unique(a, return_inverse=True)
    ub, bi = np.unique(b, return_inverse=True)
    c = np.zeros((len(ua), len(ub)), np.float64)
    np.add.at(c, (ai, bi), 1.0)
    return c


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0]
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def mutual_information(a: np.ndarray, b: np.ndarray) -> float:
    c = _contingency(a, b)
    n = c.sum()
    pij = c / n
    pi = pij.sum(axis=1, keepdims=True)
    pj = pij.sum(axis=0, keepdims=True)
    nz = pij > 0
    return float(np.sum(pij[nz] * (np.log(pij[nz]) - np.log((pi @ pj)[nz]))))


def nmi(a: np.ndarray, b: np.ndarray) -> float:
    """Arithmetic-mean-normalized mutual information (sklearn default)."""
    a, b = np.asarray(a), np.asarray(b)
    if len(a) == 0:
        return 0.0  # empty stream: no windows ever fired
    ha, hb = _entropy(np.bincount(np.unique(a, return_inverse=True)[1])), \
        _entropy(np.bincount(np.unique(b, return_inverse=True)[1]))
    if ha == 0.0 and hb == 0.0:
        return 1.0
    denom = (ha + hb) / 2.0
    if denom == 0.0:
        return 0.0
    mi = mutual_information(a, b)
    return float(np.clip(mi / denom, 0.0, 1.0))


def nmi_events_only(true_labels: np.ndarray, clusters: np.ndarray) -> float:
    """NMI over event rows only; 0 if either side has < 2 classes (ref :52-67)."""
    mask = np.asarray(true_labels) > 0
    t = np.asarray(true_labels)[mask]
    c = np.asarray(clusters)[mask]
    if len(set(t.tolist())) > 1 and len(set(c.tolist())) > 1:
        return nmi(t, c)
    return 0.0


def _per_class_prf(true_labels: np.ndarray, pred: np.ndarray):
    # per-class counts by one bincount each (the JAX package loops over the
    # classes: the same integer counts, O(n) instead of O(n * classes))
    labels, inv = np.unique(np.concatenate([true_labels, pred]), return_inverse=True)
    t_i, p_i = inv[:len(true_labels)], inv[len(true_labels):]
    k = len(labels)
    tp = np.bincount(t_i[t_i == p_i], minlength=k).astype(np.float64)
    pred_n = np.bincount(p_i, minlength=k).astype(np.float64)
    true_n = np.bincount(t_i, minlength=k).astype(np.float64)
    prec = np.divide(tp, pred_n, out=np.zeros_like(tp), where=pred_n > 0)
    rec = np.divide(tp, true_n, out=np.zeros_like(tp), where=true_n > 0)
    f1 = np.divide(2 * prec * rec, prec + rec,
                   out=np.zeros_like(tp), where=(prec + rec) > 0)
    return labels, prec, rec, f1, true_n


def weighted_f1(true_labels, pred) -> float:
    """sklearn f1_score(average='weighted', zero_division=0) equivalent (ref :69-72)."""
    t, p = np.asarray(true_labels), np.asarray(pred)
    _, _, _, f1, support = _per_class_prf(t, p)
    if support.sum() == 0:
        return 0.0
    return float(np.sum(f1 * support) / support.sum())


def weighted_precision(true_labels, pred) -> float:
    t, p = np.asarray(true_labels), np.asarray(pred)
    _, prec, _, _, support = _per_class_prf(t, p)
    if support.sum() == 0:
        return 0.0
    return float(np.sum(prec * support) / support.sum())


def weighted_recall(true_labels, pred) -> float:
    t, p = np.asarray(true_labels), np.asarray(pred)
    _, _, rec, _, support = _per_class_prf(t, p)
    if support.sum() == 0:
        return 0.0
    return float(np.sum(rec * support) / support.sum())


def aligned_f1(true_labels, pred) -> float:
    """Weighted F1 after the OPTIMAL one-to-one relabeling of predicted
    cluster ids onto truth ids (Hungarian assignment on the overlap
    contingency, maximizing total overlap).

    Why it exists: the reference's F1 treats cluster ids as class labels
    directly (reference metrics_evaluation.py:69-72), which is meaningful
    only when the matching stage happens to land on the truth's arbitrary
    id NUMBERING.  Stable-id matchers (the centroid registry) assign ids in
    first-seen order — no label-free rule can recover the truth's numbering
    — so a PERFECT partition (NMI_e = 1.0) can still score a low raw F1
    (VERDICT r2 weak #3: crisis F1 0.538 at NMI_e 1.00).  This metric
    reports what the partition earns under the best id alignment; it is
    recorded ALONGSIDE the reference-semantics F1, never instead of it.
    Predicted ids beyond the truth id count stay unmatched (they remain
    errors), so over-segmentation is still penalized.
    """
    t, p = np.asarray(true_labels), np.asarray(pred)
    if len(t) == 0:
        return 0.0
    c = _contingency(p, t)                # rows: predicted, cols: truth
    up = np.unique(p)
    ut = np.unique(t)
    from scipy.optimize import linear_sum_assignment
    rows, cols = linear_sum_assignment(-c)
    remap = {}
    for r, col in zip(rows, cols):
        remap[up[r]] = ut[col]
    # unassigned predicted ids map to fresh never-matching labels
    fresh = int(max(ut.max(), up.max())) + 1
    for u in up:
        if u not in remap:
            remap[u] = fresh
            fresh += 1
    return weighted_f1(t, np.array([remap[x] for x in p]))


def accuracy(true_labels, pred) -> float:
    t, p = np.asarray(true_labels), np.asarray(pred)
    return float(np.mean(t == p)) if len(t) else 0.0


def mean_absolute_error(true_labels, pred) -> float:
    t, p = np.asarray(true_labels, np.float64), np.asarray(pred, np.float64)
    return float(np.mean(np.abs(t - p))) if len(t) else 0.0


def compute_all_metrics(results, subset_size, noise_rate, label_mode, sorting,
                        reduced_dim, k_basis, window_size, clusters,
                        true_labels, end_time_ns, start_time_ns):
    """Append one sweep point's metrics (ref metrics_evaluation.py:36-102).

    Signature and logging behavior match the reference so the sweep driver is
    a drop-in.
    """
    results["subset_size"].append(subset_size)
    results["noise_rate"].append(noise_rate)
    results["label_mode"].append(label_mode)
    results["sorting"].append(sorting)
    results["reduced_dim"].append(reduced_dim)
    results["k_basis"].append(k_basis)
    results["window_size"].append(window_size)

    clusters = np.asarray(clusters)
    true_labels = np.asarray(true_labels)
    log = []

    v = nmi(true_labels, clusters)
    results["nmi_score"].append(v); log.append(f"nmi={v:.2f}")
    v = nmi_events_only(true_labels, clusters)
    results["nmi_e_score"].append(v); log.append(f"nmi_e={v:.2f}")
    v = weighted_f1(true_labels, clusters)
    results["f1_score"].append(v); log.append(f"f1={v:.2f}")
    v = aligned_f1(true_labels, clusters)
    results["f1_aligned"].append(v); log.append(f"f1_aligned={v:.2f}")
    v = weighted_precision(true_labels, clusters)
    results["precision"].append(v); log.append(f"precision={v:.2f}")
    v = weighted_recall(true_labels, clusters)
    results["recall"].append(v); log.append(f"recall={v:.2f}")
    v = accuracy(true_labels, clusters)
    results["accuracy"].append(v); log.append(f"accuracy={v:.2f}")
    v = mean_absolute_error(true_labels, clusters)
    results["mae"].append(v); log.append(f"mae={v:.2f}")
    pt = (end_time_ns - start_time_ns) / 1e9
    results["processing_time"].append(pt); log.append(f"processing_time={pt:.2f}")

    print(", ".join(log))
    return results


def now_ns() -> int:
    return time.time_ns()
