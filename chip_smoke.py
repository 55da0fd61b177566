#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``mused_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):
  (a) a CUDA device is present; print ``nvidia-smi`` name and power limit;
      build the kNN-adjacency kernel from ``mused_tpu_torch/csrc`` and print
      the build seconds and ptxas' register / shared-memory report;
  (b) the kernel against its plain PyTorch version on the card, per metric at
      the main path's shapes (window 2000, k_basis 50; first window of the
      stream for location / time / tags / text, random rows for euclidean),
      plus 40 duplicate rows and a 200 m-spaced city-scale location cluster:
      l1 and jaccard bit-equal, dot / chord3 / euclidean >= 99.9% of edges
      with every row's degree identical; times of both;
  (c) ``api.process_streaming_data`` on the card over a seeded 150,000-record
      synthetic stream at the reference defaults (window 2000, k_basis 50,
      reduced_dim 50, binary labels, noise 0.95, sorted) for SWFDMC and
      sSVDMC, with exactly 4 kernel launches per window;
  (d) for the first 3 windows, the kernel-path and plain-path fused
      adjacencies agree on >= 99.9% of edges.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mused_tpu_torch import api
from mused_tpu_torch.data.ingest import to_device
from mused_tpu_torch.data.synthetic import make_stream
from mused_tpu_torch.engine import streaming
from mused_tpu_torch.ops import affinity
from mused_tpu_torch.ops.kernels import affinity_kernel as ak
from mused_tpu_torch.ops.kernels import build
from mused_tpu.utils.config import PipelineConfig

WINDOW, K_BASIS, REDUCED_DIM = 2000, 50, 50     # reference default_params
N_RECORDS, NOISE_RATE, SEED = 150_000, 0.95, 0
EDGE_AGREEMENT = 0.999       # float-sum-order metrics: kernel vs plain edges
BIT_EQUAL = ("l1", "jaccard")   # exact integer / unfused sums: must match exactly


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def edge_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """|A and B| / |A or B| over the 0/1 entries (1.0 when both are empty)."""
    union = int(torch.count_nonzero(torch.maximum(a, b)))
    inter = int(torch.count_nonzero(torch.minimum(a, b)))
    return 1.0 if union == 0 else inter / union


def kernel_cases(mods, engine: streaming.StreamingEngine, device) -> list[tuple]:
    """(name, metric, x, valid, k) at the main path's shapes."""
    host = engine.featurize([m[:WINDOW] for m in mods], streaming.STANDARD_TYPES)
    loc, tim, _, tags_ids, text_ids, text_cnt, tags_valid = to_device(host, device)
    fc = engine.cfg.features
    lv = torch.all(torch.isfinite(loc), dim=1)
    xyz = ak.location_to_unit_xyz(torch.where(lv[:, None], loc, 0.0)).contiguous()
    tv = affinity.time_valid(tim)
    t = torch.where(tv[:, None], tim, 0.0).contiguous()
    tags = affinity.counts_from_tokens(tags_ids, None, fc.tags_hash_dim)
    xt, xv = affinity.tfidf_rows(affinity.counts_from_tokens(text_ids, text_cnt,
                                                             fc.text_hash_dim))
    gen = torch.Generator(device=device).manual_seed(SEED)
    emb = torch.randn((WINDOW, 128), generator=gen, device=device)
    dup = emb / torch.linalg.norm(emb, dim=1, keepdim=True)
    dup[10:50] = dup[10]                                   # 40 exact duplicates
    side = int(np.ceil(np.sqrt(WINDOW)))                   # ~200 m grid in Barcelona
    ij = torch.arange(WINDOW, device=device)
    city = torch.stack([41.39 + (ij // side) * 0.0018,
                        2.16 + (ij % side) * 0.0024], dim=1).float()
    ones = torch.ones(WINDOW, dtype=torch.bool, device=device)
    return [
        ("location", "chord3", xyz, lv, K_BASIS),
        ("time", "l1", t, tv, 3 * K_BASIS),
        ("tags", "jaccard", tags.contiguous(), tags_valid, K_BASIS),
        ("text", "dot", xt.contiguous(), xv, K_BASIS),
        ("generic_euclidean", "euclidean", emb, ones, K_BASIS - 1),
        ("duplicates_dot", "dot", dup.contiguous(), ones, K_BASIS),
        ("city_200m_chord3", "chord3", ak.location_to_unit_xyz(city).contiguous(), ones,
         K_BASIS),
    ]


def phase_b(cases) -> list[dict]:
    rows = []
    for name, metric, x, valid, k in cases:
        got = ak.knn_adjacency(x, valid, k, metric)
        want = ak.knn_adjacency_reference(x, valid, k, metric)
        torch.cuda.synchronize()
        agree = edge_agreement(got, want)
        same_degree = bool(torch.equal(got.sum(1), want.sum(1)))
        row = {"case": name, "metric": metric, "n": x.shape[0], "d": x.shape[1], "k": k,
               "edges": int(want.sum()), "mismatched_entries": int((got != want).sum()),
               "edge_agreement": agree, "same_degree": same_degree,
               "max_abs_err": float((got - want).abs().max()),
               "ms": cuda_ms(lambda: ak.knn_adjacency(x, valid, k, metric)),
               "plain_ms": cuda_ms(lambda: ak.knn_adjacency_reference(x, valid, k, metric))}
        print("[b]", json.dumps(row), flush=True)
        ok = (row["mismatched_entries"] == 0 if metric in BIT_EQUAL
              else agree >= EDGE_AGREEMENT and same_degree)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def phase_c(mods, mtypes, labels, device, approach: str, n_records: int) -> dict:
    cfg = PipelineConfig(seed=SEED, subset_size=n_records, noise_rate=NOISE_RATE,
                         label_mode="binary", sorting=True, window_size=WINDOW,
                         reduced_dim=REDUCED_DIM, k_basis=K_BASIS, approach=approach,
                         n_clusters_override=2)
    engine = streaming.StreamingEngine(cfg, device)
    n_windows = len(streaming.window_triggers(n_records, WINDOW, 1))
    before = ak.launches
    t0 = time.perf_counter()
    res = api.process_streaming_data(
        results=api.get_initial_results()[0], data_modalities=[m[:n_records] for m in mods],
        modality_types=mtypes, window_size=WINDOW, reduced_dim=REDUCED_DIM,
        k_basis=K_BASIS, n_clusters_total=2, seed=SEED, approach=approach,
        complete_true_labels=labels[:n_records], step_window_ratio=1,
        noise_rate=NOISE_RATE, label_mode="binary", sorting=True, eps=1.5,
        min_samples=2, device=device, cfg=cfg, engine=engine)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = {"approach": approach, "records": n_records, "windows": n_windows,
           "launches": ak.launches - before, "seconds": secs,
           "windows_per_s": n_windows / secs, "rows_per_s": n_windows * WINDOW / secs,
           "nmi": res["nmi_score"][0], "nmi_e": res["nmi_e_score"][0],
           "f1": res["f1_score"][0], "f1_aligned": res["f1_aligned"][0],
           "spans": engine.timer.summary()}
    print("[c]", json.dumps(out), flush=True)
    if out["launches"] != 4 * n_windows:
        raise AssertionError(f"expected {4 * n_windows} kernel launches, got "
                             f"{out['launches']}")
    metric_vals = [out[k] for k in ("nmi", "nmi_e", "f1", "f1_aligned")]
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in metric_vals):
        raise AssertionError(f"metrics out of range: {metric_vals}")
    return out


def phase_d(mods, mtypes, device, n_windows: int = 3) -> list[float]:
    cfg = PipelineConfig(window_size=WINDOW, reduced_dim=REDUCED_DIM, k_basis=K_BASIS,
                         approach="sSVDMC", n_clusters_override=2)
    engine = streaming.StreamingEngine(cfg, device)
    agreements = []
    for w in range(n_windows):
        host = engine.featurize([m[w * WINDOW:(w + 1) * WINDOW] for m in mods], mtypes)
        dev = to_device(host, device)
        got = engine.fuse_from_features(host, dev, mtypes, use_kernel=True)
        want = engine.fuse_from_features(host, dev, mtypes, use_kernel=False)
        agree = edge_agreement(got, want)
        print(f"[d] window {w}: edges kernel {int(got.sum())} plain {int(want.sum())} "
              f"mismatched {int((got != want).sum())} agreement {agree:.6f}", flush=True)
        if agree < EDGE_AGREEMENT:
            raise AssertionError(f"window {w}: fused agreement {agree} < {EDGE_AGREEMENT}")
        agreements.append(agree)
    return agreements


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"[a] device {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build.load()
    print(f"[a] kernel library {build.library_path()} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds} s); rows per "
          f"block at n={WINDOW}: {build.load().mused_knn_rows_per_block(WINDOW)}",
          flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("[a] ptxas:", line.strip())

    t0 = time.perf_counter()
    mods, mtypes, labels = make_stream(N_RECORDS, noise_rate=NOISE_RATE, binary=True,
                                       sort_by_uploaded=True, seed=SEED)
    print(f"[c] synthetic stream: {len(labels)} records, {int(labels.sum())} event rows, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    probe_engine = streaming.StreamingEngine(
        PipelineConfig(window_size=WINDOW, k_basis=K_BASIS, reduced_dim=REDUCED_DIM),
        device)
    rows_b = phase_b(kernel_cases(mods, probe_engine, device))

    phase_c(mods, mtypes, labels, device, "sSVDMC", 4 * WINDOW)   # warm-up, not counted
    ak.reset_launches()
    runs = [phase_c(mods, mtypes, labels, device, a, N_RECORDS)
            for a in ("SWFDMC", "sSVDMC")]
    main_launches = ak.launches

    phase_d(mods, mtypes, device)

    main_rows = [r for r in rows_b if r["case"] in ("location", "time", "tags", "text")]
    kernel = {
        "name": "knn_adjacency", "route": "cuda",
        "source": "mused_tpu_torch/csrc/knn_adjacency.cu",
        "replaces": "mused_tpu/ops/pallas/affinity_kernel.py:185",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows_b),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "timed": "one window's four main-path calls (location, time, tags, text)",
        "per_metric": {r["case"]: {"ms": r["ms"], "plain_ms": r["plain_ms"]}
                       for r in rows_b},
        "e2e_windows_per_s": {r["approach"]: r["windows_per_s"] for r in runs},
    }
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
