#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``mused_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):
  (a) a CUDA device is present; print ``nvidia-smi`` name and power limit;
      build the kernels from ``mused_tpu_torch/csrc`` and print the build
      seconds and ptxas' register / shared-memory report per kernel, and the
      shared memory per CTA of K1's sim_keys and radix_select; build the native
      hasher and incdbscan core (``mused_tpu_torch/native``) and fail if
      either does not build;
  (b) K1 against its plain PyTorch version on the card, per metric at the
      main path's shapes (window 2000, k_basis 50; first window of the
      stream for location / time / tags / text, random rows for euclidean),
      plus 40 duplicate rows, a 200 m-spaced city-scale location cluster,
      dense random unit rows at d = 4096 (no zero steps to skip), text in
      512-row chunks and text with bf16 operands: l1, jaccard and
      chord3 bit-equal, dot and euclidean >= 99.9% of edges with every
      row's degree identical; each case's route (tensor-core or
      coordinate), mismatched entries, the times of both and the SM clock,
      power draw and temperature before and after the kernel's timing;
  (c) ``api.process_streaming_data`` on the card over a seeded 150,000-record
      synthetic stream at the reference defaults (window 2000, k_basis 50,
      reduced_dim 50, binary labels, noise 0.95, sorted) for SWFDMC and
      sSVDMC, with exactly 4 kernel launches and 2 native hasher calls per
      window, through the entry points' default device (the card);
  (d) for the first 3 windows, the kernel-path and plain-path fused
      adjacencies agree on >= 99.9% of edges;
  (e) the huge-window kernels K2-K5 against their plain versions on the
      first 2048-row block of the first window of a separate seeded
      196,608-record stream (window 98,304, nbins 1536): the postings build
      of the window's tags and text from their token ids (equal to the
      window's postings; ms and its bytes bound); K2 per metric (location
      chord3, time l1, tags jaccard and text dot on the postings route as the
      main path runs them, bit-equal to the postings plain version too, then
      tags and text again on the tensor-core route on the same block, text
      on integer values bit-equal on both, and chord on a 128-wide random
      generic panel), each row naming its route, with tags + text per block
      on both routes; K3 against two K2 launches and the
      plain version, the list kernels on that block's real candidate block
      (every array the products read equal to the plain lists, the exact
      edge count), K4 / K5 over those lists at the fold's live widths (K4
      r = 66 and 132, K5 r = 66) and the JAX package's 128-padded ones (K4
      128 and 256, K5 128), exact on integers, within the probe tolerances
      below and bit-identical over two launches; times of each kernel and
      its plain version, its bound (max(operations / peak of their type,
      bytes / HBM rate), with the formula's inputs; K2 on the postings
      route counts 2 operations per postings entry its rows meet at the f32
      rate and the bytes of its rows, the postings and table rows of the
      features met, the statistics and the outputs, the dense count beside
      as ``bound_dense_ms``; K4 / K5 count 2 r
      operations per edge of the block and the bytes of their operand,
      output and the list arrays they read (the slabs once, in the list
      build's bound), the dense 2 r block n with the slabs beside as
      ``bound_dense_ms``), share of bound, launches per window, K2's
      cluster split, K5's time without the username term, for K4 / K5 one
      cuSPARSE product of the block as a CSR tensor (``library_ms``), for
      K2 dot / jaccard the bare cuBLAS product's time as a yardstick, and
      for the coordinate metrics (K2 chord3 / l1, K3) both their
      instruction bound and the older FMA-rate bound (tolerances at the
      constants below); with ``--parent DIR`` also the earlier tree's K2
      (tags, text) and K3 (tags + text) on the same panels and its K4 / K5
      on the same block and operands, in a subprocess, in turns (earlier,
      this, earlier), its K2 bit-equal to this tree's tensor-core route and
      its K4 / K5 integers bit-equal; the union kernel writing the block's
      f32 rows from its candidates, bit-equal to its plain version on
      the same candidates, its time against the bytes it writes and reads
      (i4 repeats it at the batch subset's shape);
  (f) ``api.process_streaming_data`` on the card over that stream at
      window 98,304: SWFDMC with the candidate-native fold (exactly 96 K2,
      48 K3, 96 K4, 48 K5 and 48 list builds per window) and sSVDMC on the binned
      blocked SVD (576 K2, 288 K3 and 288 union blocks per window), every K2 on the postings
      route; 2 native hasher calls per window; metrics in [0, 1]; one more
      SWFDMC window's host syncs by call site under
      ``torch.cuda.set_sync_debug_mode("warn")``, none in
      ``ops/kernels/blocked_select`` (the postings build, the K2 / K3
      wrappers); with ``--parent DIR`` paired trials, each tree in a process
      of its own in turns (earlier, this, this, earlier): (f)'s windows/s
      for SWFDMC and sSVDMC and i1's SVDMC_batch seconds, NMI and F1 within
      0.01 of the earlier tree's;
  (g) on 3 blocks of the first huge window, the card's fused rows (K2 / K3,
      the union kernel) agree with the same columns' rows on the CPU (the
      plain versions) on >= 99.9% of edges,
      and the candidate fold's sq_frobenius equals the dense binned fold's;
  (h) the dense-window surface of slice 2 through its entry points, at
      window 2000, k_basis 50, reduced_dim 50:
      (each detector run after a 2-window warm-up of the same configuration)
      h1 the serving detector (SWFDMC, eigengap count, background bucket)
         over the first 60,000 records of (c)'s stream in pushes of 500:
         windows/s, push p50 / p99 ms, the largest lag, events, background
         rows, exactly 4 K1 launches and 2 native hasher calls per window;
         saved after 30,000 records and loaded into a fresh detector, its
         results equal the uninterrupted detector's;
      h2 BASELINE.md config #2 (a 20,000-row crisis embedding stream,
         sSpectral, eigengap count) with the background bucket off and on:
         windows/s, NMI, background rows (> 0 when on), exactly 2 K1 dot
         launches per window;
      h3 ``process_streaming_data`` on (c)'s first 20,000 records for
         sSpectral, DBSCAN_incr (at least one native incdbscan call) and
         DBSCAN_centr: 4 K1 launches per window, metrics in [0, 1];
      h4 SWFDMC over those records checkpointing every 4 windows; with the
         checkpoints after window 4 deleted, the rerun resumes at window 4
         and its metrics equal the first run's;
      h5 the detector on 2 huge windows of (e)'s stream (98,304 rows,
         SWFDMC, background): 96 K2, 48 K3, 96 K4, 48 K5 and 48 list
         launches per window;
  (i) slices 2c + 2d, the batch engine and the blocked clustering family:
      i1 ``api.process_batch_data`` on (c)'s 150,000 records (the
         reference's default subset: the blocked path, 151,552 padded rows,
         nbins 4096 over 37 groups) for SVDMC_batch, Spectral_batch,
         DBSCAN_batch and HDBSCAN_batch: seconds, rows/s, NMI, NMI_e, F1,
         and exactly 2 K2 + 1 K3 per block per sweep (6 sweeps of the
         blocked SVD, 8 of blocked spectral), no K1;
      i2 the dense path: the same approaches at 32,768 rows (HDBSCAN then
         takes the card's Borůvka) and Spectral_batch at 16,384, 4 K1 each;
         with ``--parent DIR`` (an unpacked tree of an earlier commit) also
         the earlier tree's i2 in a subprocess, which builds that tree's
         kernels, in turns: earlier, this, this, earlier; its first run
         also times that tree's K1 on the four main-path calls at window
         2000 and the n of i4, whose edges (a digest of their indices) must
         equal this tree's;
      i3 sSpectral and DBSCAN_centr over (f)'s stream at window 98,304
         (768 / 576 K2 and 384 / 288 K3 per window);
      i4 K2 (tags, text; postings route, then the tensor-core route, and
         with ``--parent DIR`` the earlier tree's K2 in turns), K3 tags +
         text on the postings route (bit-equal to two K2 launches, beside
         the tensor-core pair and the earlier tree's) and K3 location + time
         on the batch columns' last block (n = 151,552, nbins 4096) held to
         (e)'s rules; K1 at n = 8,192, 16,384 and
         32,768 on the stream's first n records' four main-path calls, plus
         Euclidean and dot on small-integer rows (exact products, so held
         bit-equal), held to (b)'s rules: ms, bound, share of bound,
         mismatched entries; at 32,768 text in 2048-row chunks (the chunking
         before the key scratch was sized from free memory: every tile
         computed) bit-equal to one chunk; blocked DBSCAN equal to the
         dense DBSCAN on a 20,000-row reduced embedding (on a grid that
         makes every squared distance exact); the card's Borůvka against
         host Prim at 16,384 rows: the same MST weights there, and the same
         partition on 16 separated blobs;
  (j) slice 4a, the column-sharded layouts:
      j1 K3 on tags jaccard + text dot (the column-sharded sweep's pair) on
         (e)'s first block, on the postings route: bit-equal to two K2
         launches on it and held to (e)'s rules against the plain version;
         its ms beside the two K2 launches', the tensor-core pair's and (with
         ``--parent``) the earlier tree's, its bound on the nonzero rule and
         the dense one;
      j2 on emulated 2- and 4-way column splits of that window, a shard's
         columns against a row block of another shard (shard-local start
         before and past the shard, row_stats pre-sliced): K2 on every
         metric and K3 on both standard pairs held to (e)'s rules, tags and
         text on the postings route with the shard's own postings, K4 / K5
         on the shard's candidate block with its g0, exact on integers;
      j3 the column-sharded entry points on the card at world size 1 (an
         NCCL group of one, mesh (1, 1)) on (f)'s first window: fused rows
         bit-equal to the single-device binned route on 3 blocks; the FD
         fold with exactly 96 K3, 0 K2, 96 K4, 48 K5 and 48 lists and the
         single-device fold's sq_frobenius; the blocked SVD (576 K3) and
         spectral embedding (768 K3); seconds beside (f)'s and (i3)'s;
  (k) slices 2f + 2g, the driver surface and the remaining options:
      k1 ``main.cli`` in this process at the reference defaults (the
         synthetic dataset, the sorting sweep, SWFDMC and sSVDMC: 4 points
         of 75 windows): seconds, windows/s, NMI and F1 per point, exactly 4
         K1 launches and 2 native hasher calls per window, the sweep's log
         file with one line per approach; then the 12-point demo sweep;
      k2 the SED2012 loader on a written 2,600-photo fixture (tied upload
         minutes, missing geotags, entities, CDATA, ``0000-00-00`` dates):
         the native scanner's table equal to the Python path's, prepared
         like the reference and run as one SWFDMC window (4 K1);
      k3 ``SeqBasedSWFD(N=10,000, d=300, sketch_dim=50)`` on the reference's
         sketch benchmark spec (m 10, zeta 10; n cut to 100,000 rows) in
         1,000-row fits and 2,000 single-row fits: rows/s, and at every
         10,000-row boundary ``get()``'s err bounding the live window's
         exact covariance error (float64 on the card);
      k4 SWFDMC on (c)'s stream with the window fold on the Newton-Schulz
         shrink (``fd_shrink="subspace_ns"``): windows/s, NMI, F1 beside
         (c)'s rr run, the shrinks that kept the fast branch and the eigh
         fallbacks (3 per window);
      k5 BASELINE.md config #2 (20,000 crisis rows) through sSVDMC with
         ``matching="centroid"`` against ``"auto"`` (2 K1 dot per window),
         and the detector with centroid matching saved and loaded halfway,
         equal to its uninterrupted run window for window;
      k6 the reference API on one 2000-row window: every
         ``create_adjacency_matrix`` graph bit-equal to the engine's graph
         of that modality with exactly 4 K1 launches, then
         ``fuse_matrices``, ``perform_svd_reduction`` and
         ``perform_clustering``;
  (l) slice 4b, the row-sharded layouts, at world size 1 (an NCCL group of
      one, mesh (1, 1), assigned to a ``StreamingEngine`` built with the
      phase's config and passed to ``process_streaming_data(...,
      engine=engine)``):
      l1 the sharded dense window step over (c)'s stream (75 windows) for
         SWFDMC with the allgather merge, SWFDMC with the ring merge (0 hops
         at size 1) and sSVDMC: windows/s, NMI, F1 beside (c)'s, no K1 (the
         step fuses through the plain strip, as the JAX package's does); the
         first window's fused shard on the card against the same function
         on the CPU, each modality alone: time, username and tags bit-equal,
         location and text on >= 99.9% of edges with every row's degree
         equal; its ms beside the single-device K1 fusion's;
      l2 the huge-window ``rows`` layout on the first window of (f)'s
         stream: SWFDMC with exactly 96 K2, 48 K3, 96 K4, 48 K5 and 48 lists
         and the
         single-device fold's sq_frobenius, sSVDMC with 576 K2 + 288 K3,
         sSpectral with 768 K2 + 384 K3; seconds beside (f)'s and (i3)'s;
      l3 ``main.cli --parallel-sweep`` on the demo sweep (one point per
         card) against the sequential demo, every point within 1e-6;
  (m) the scanned multi-window dispatch (``windows_per_batch`` = W) and the
      repaired host waits, after (c)'s warm-up:
      m1 (c)'s stream through SWFDMC and sSVDMC with the parent's host waits
         (a span timer synchronizing at every span end, Lloyd's loop reading
         the host twice per step; together and each alone) and at W = 1, 4
         and 8: windows/s, NMI, F1,
         every window's labels equal to W = 1's, exactly 4 K1 launches per
         window step (a padded tail group's included); the host syncs per
         window of the parent's sequence, the repaired one and W = 4 over 8
         windows (``torch.cuda.set_sync_debug_mode("warn")`` plus every
         ``torch.cuda.synchronize``), by call site and kind (span timer,
         Lloyd, FD, eigh / svd, label pull); Lloyd's loop per call, the
         parent's against ``kmeans.CHECK_EVERY`` 4 / 8 / 16, labels equal;
      m2 h1's detector at W = 4 against W = 1: the same results; windows/s,
         push p50 / p99 and the largest lag of each;
      m3 l1's row-sharded dense step (sSVDMC, world size 1) over 20 windows
         at W = 4 against W = 1: the same labels, no K1.

Every phase prints its seconds.  ``--phases`` runs a subset (for
development; the result lines are printed only when all phases ran).
The engine's spans measure host time unless they are compared: under
``--profile`` (c)'s and the traced row-sharded windows' spans synchronize
at their ends (``SpanTimer(sync_all=True)``), so each covers its device
work.  ``--profile`` also traces one huge window per approach with
torch.profiler (kernel time by name, device busy share, host time by
operator), with (e) ten calls each of one block's list build and fold
products (device time by kernel), with (i) K1's four calls at n = 32,768 and text in 2048-row
chunks (device time by kernel per call, over 20 calls), and with (l) 10 windows of the row-sharded
dense step per approach (SWFDMC, sSVDMC, beside the engine's spans), and
prints no result lines.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import inspect
import io
import json
import linecache
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mused_tpu_torch import api, native
from mused_tpu_torch import main as port_main
from mused_tpu_torch.data import sed2012
from mused_tpu_torch.data import synthetic as port_synthetic
from mused_tpu_torch.data.ingest import to_device
from mused_tpu_torch.data.synthetic import crisis_embedding_stream, make_stream
from mused_tpu_torch.engine import batch, streaming
from mused_tpu_torch.ops import affinity, blocked_dbscan, blocked_hdbscan, dbscan, fd
from mused_tpu_torch.ops import kmeans, spectral, swfd
from mused_tpu_torch.ops import blocked_affinity as ba
from mused_tpu_torch.ops.kernels import affinity_kernel as ak
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.ops.kernels import build
from mused_tpu_torch.ops.kernels import cand_matvec as cm
from mused_tpu_torch.parallel import colsharded as cs
from mused_tpu_torch.serving import StreamDetector
from mused_tpu_torch.utils.config import PipelineConfig
from mused_tpu_torch.utils.metrics import nmi
from mused_tpu_torch.utils.profiling import SpanTimer

WINDOW, K_BASIS, REDUCED_DIM = 2000, 50, 50     # reference default_params
N_RECORDS, NOISE_RATE, SEED = 150_000, 0.95, 0
EDGE_AGREEMENT = 0.999       # float-sum-order metrics: kernel vs plain edges
BIT_EQUAL = ("l1", "jaccard", "chord3")   # exact integer / unfused sums

# huge-window slice (BASELINE.md #3): 98,304 = 48 blocks of 2048 rows
HUGE_WINDOW, HUGE_BLOCK, HUGE_NBINS = 98_304, 2_048, 1_536
HUGE_RECORDS = 2 * HUGE_WINDOW
HUGE_BIT_EQUAL = ("jaccard", "l1", "chord3")   # K2 vals and grp bit-equal
# dot / chord: f32 sums in another order; |error| <= K * 2**-24 * sum|a_i b_i|,
# held at 1e-4 of the block's largest |value| (K = 4096 gives 2.4e-4 worst
# case, ~1e-6 typical), with budgeted_keep's masks >= 99.9% equal and every
# row's kept count identical
DOT_RTOL, KEEP_AGREEMENT = 1e-4, 0.999
PROBE_RTOL = 1e-5            # K4 / K5 on the real FD probe: max|err| / max|want|
K2_DOT_ATOL, K2_DOT_GROUP_AGREEMENT = 1e-5, 0.999   # K2 dot on the real text panel
K4_PROBE_RTOL = 1e-6         # K4 on the real probe (bf16 x 0/1, f32 sums in another order)
HEAVY_ROWS = 64              # K4's heavy columns: more kept rows than this (csrc kHeavy)

# H100 SXM dense peaks at 700 W (NVIDIA's data sheet) for the least time the
# card could take: max(operations / peak of their type, bytes / memory rate),
# each input read once and each output written once.  Products count as
# dense (2 * M * N * K), as the kernels and the TPU kernels compute them.
# "fp32_instr" is the FP32 instruction issue rate (128 lanes x 132 SMs x
# 1.98 GHz): the 67 TFLOP/s peak counts an FMA as two operations, and the
# coordinate metrics' unfused sub / mul / add and their running argmin's
# compare and selects are one instruction each.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12,
            "fp32_instr": 33.5e12}
# instructions per (row, column) pair: chord3 3 sub + 3 mul + 2 add, l1 2 sub
# + 1 add (|.| is an operand modifier), each + compare and 2 selects
COORD_INSTR_PER_PAIR = {"chord3": 11, "l1": 6}
COORDS = {"chord3": 3, "l1": 2}
HBM_BYTES_PER_S = 3.35e12
BLOCKS_PER_WINDOW = HUGE_WINDOW // HUGE_BLOCK
SSVD_SWEEPS = 6              # blocked randomized SVD: sweeps per huge window
SPECTRAL_SWEEPS = 8          # blocked spectral: degrees, 6 iterations, the Ritz product


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


CLOCKS = "clocks.sm,power.draw,temperature.gpu"   # sampled beside K1's timings


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


def bound(ops: float, peak: str, nbytes: float) -> dict:
    """The least time for the work, with the formula's inputs."""
    t_ops, t_bytes = ops / PEAK_OPS[peak] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "peak": peak, "peak_ops_per_s": PEAK_OPS[peak], "bytes": nbytes,
            "bytes_per_s": HBM_BYTES_PER_S}


def k1_bound(metric: str, n: int, d: int) -> dict:
    """One K1 call: an (n, d) f32 panel against itself -> (n, n) f32 0/1."""
    nbytes = n * d * 4 + n + n * n * 4
    if metric in ak.TENSOR_CORE:
        return bound(2.0 * n * n * d, "tf32", nbytes)
    return bound(3.0 * n * n * d, "fp32", nbytes)       # difference, square / abs, sum


def k2_bound(metric: str, n: int, block: int, nbins: int, k: int, esize: int) -> dict:
    """One K2 call: (block, k) rows against the (n, k) panel -> binned
    (block, nbins) f32 values + int8 groups."""
    nbytes = (n + block) * k * esize + n + block * nbins * 5
    if metric in bs.STAT_METRICS:
        nbytes += (n + block) * 4
    if metric in bs.MMA_METRICS:
        return bound(2.0 * block * n * k, "int8" if metric == "jaccard" else "bf16", nbytes)
    return coord_bound([(metric, k)], n, block, nbins)


def postings_met(post: bs.Postings, rows: torch.Tensor) -> dict:
    """What the postings route's work depends on, for this block: the
    postings entries its row-terms meet (each row term meets its feature's
    whole postings list), the row-terms, and the distinct features met."""
    df = (post.table[:, -1] - post.table[:, 0]).long()
    per_feature = torch.count_nonzero(rows != 0, dim=0).long()
    met = per_feature > 0
    return {"entries_met": int((per_feature * df).sum()),
            "row_terms": int(per_feature.sum()), "features_met": int(met.sum()),
            "postings_entries_of_features_met": int(df[met].sum()),
            "postings_entries": int(post.entries)}


def k2_postings_bound(metric: str, post: bs.Postings, rows: torch.Tensor, nbins: int) -> dict:
    """One K2 call on the postings route, counted on the nonzero rule: 2
    operations (an f32 multiply-add) per postings entry that the block's
    row-terms meet, at the f32 peak; bytes: the rows, the postings entries
    and table rows of the features met (each read once), column validity,
    the hoisted statistics (jaccard) and the (block, nbins) values and
    groups written."""
    n, (block, k) = post.n, rows.shape
    met = postings_met(post, rows)
    steps = post.table.shape[1]
    nbytes = (block * k * rows.element_size()
              + met["postings_entries_of_features_met"] * (4 + post.vals.element_size())
              + met["features_met"] * steps * 4 + n + block * nbins * 5)
    if metric in bs.STAT_METRICS:
        nbytes += (n + block) * 4
    out = bound(2.0 * met["entries_met"], "fp32", nbytes)
    out.update(met)
    return out


def postings_build_bound(n: int, k: int, ids: torch.Tensor, post: bs.Postings) -> dict:
    """One postings build, bytes-bound: the token ids and the panel values
    at them read, the entries (column, value) and the table written."""
    nbytes = (ids.numel() * (ids.element_size() + post.vals.element_size())
              + post.cols.numel() * (4 + post.vals.element_size()) + post.table.numel() * 4)
    return bound(0.0, "fp32", nbytes)


def coord_bound(items: list, n: int, block: int, nbins: int) -> dict:
    """One K2 coordinate call or one K3 call ((metric, K) per output): the
    instruction bound, with the older FMA-rate bound beside it (3 operations per
    coordinate per pair at the 67 TFLOP/s FMA-rate peak, no argmin)."""
    pairs = float(block) * n
    nbytes = sum((n + block) * k * 4 + n + block * nbins * 5 for _, k in items)
    per_pair = sum(COORD_INSTR_PER_PAIR[m] for m, _ in items)
    out = bound(per_pair * pairs, "fp32_instr", nbytes)
    old = bound(sum(3.0 * COORDS[m] for m, _ in items) * pairs, "fp32", nbytes)
    out.update(instructions_per_pair=per_pair, bound_fma_rate_ms=old["bound_ms"],
               fma_rate_ops=old["ops"])
    return out


def cand_bytes(cand: cm.CandBlock) -> int:
    return cand.slabs.numel() + (cand.block * 4 if cand.uid_rows is not None else 0) + \
        cand.uid_cols.numel() * 4


def product_bytes(name: str, rr: int, cand: cm.CandBlock, lists_row: dict) -> int:
    """The bytes K4 or K5 moves on a block whose lists are built (the list
    build reads the slabs, and its own bound counts them): the operand and
    the output once, and the int32 list arrays the kernel reads.  K4: x_t,
    out_t, the edge count, colptr, colrows, the heavy columns; with uids
    each column's and row's user, each user's rows.  K5: y, out, rowptr,
    rowcols; with uids each row's and column's user, each user's columns
    and their offsets."""
    n, block, e = cand.groups * cand.nbins, cand.block, lists_row["list_entries"]
    users, nu = cand.uid_rows is not None, lists_row["users"]
    if name == "K4":
        io = rr * block * 2 + rr * n * 4 + 8
        words = (n + 1) + e + lists_row["heavy_listed"] + 1
        if users:
            words += n + block + (nu + 1) + block + 1
    else:
        io = n * rr * 2 + block * rr * 4
        words = (block + 1) + e
        if users:
            words += block + n + (nu + 1) + lists_row["user_columns"] + 1
    return io + 4 * words


def with_bound(row: dict, b: dict) -> dict:
    row.update(b)
    row["share_of_bound"] = b["bound_ms"] / row["ms"]
    return row


def edge_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """|A and B| / |A or B| over the 0/1 entries (1.0 when both are empty)."""
    a, b = a.bool(), b.bool()
    union = int(torch.count_nonzero(a | b))
    inter = int(torch.count_nonzero(a & b))
    return 1.0 if union == 0 else inter / union


def main_cases(mods, engine: streaming.StreamingEngine, device, n_rows: int) -> list[tuple]:
    """(name, metric, x, valid, k, options) of the main path's four K1 calls on
    the stream's first ``n_rows`` records."""
    host = engine.featurize([m[:n_rows] for m in mods], streaming.STANDARD_TYPES)
    loc, tim, _, tags_ids, text_ids, text_cnt, tags_valid = to_device(host, device)
    fc = engine.cfg.features
    lv = torch.all(torch.isfinite(loc), dim=1)
    xyz = ak.location_to_unit_xyz(torch.where(lv[:, None], loc, 0.0)).contiguous()
    tv = affinity.time_valid(tim)
    t = torch.where(tv[:, None], tim, 0.0).contiguous()
    tags = affinity.counts_from_tokens(tags_ids, None, fc.tags_hash_dim)
    xt, xv = affinity.tfidf_rows(affinity.counts_from_tokens(text_ids, text_cnt,
                                                             fc.text_hash_dim))
    return [("location", "chord3", xyz, lv, K_BASIS, {}),
            ("time", "l1", t, tv, 3 * K_BASIS, {}),
            ("tags", "jaccard", tags.contiguous(), tags_valid, K_BASIS, {}),
            ("text", "dot", xt.contiguous(), xv, K_BASIS, {})]


def kernel_cases(mods, engine: streaming.StreamingEngine, device) -> list[tuple]:
    """(name, metric, x, valid, k, options) at the main path's shapes: its four
    calls and six more cases."""
    cases = main_cases(mods, engine, device, WINDOW)
    xt, xv = cases[3][2], cases[3][3]
    gen = torch.Generator(device=device).manual_seed(SEED)
    emb = torch.randn((WINDOW, 128), generator=gen, device=device)
    dense = torch.randn((WINDOW, 4096), generator=gen, device=device)
    dense /= torch.linalg.norm(dense, dim=1, keepdim=True)
    dup = emb / torch.linalg.norm(emb, dim=1, keepdim=True)
    dup[10:50] = dup[10]                                   # 40 exact duplicates
    side = int(np.ceil(np.sqrt(WINDOW)))                   # ~200 m grid in Barcelona
    ij = torch.arange(WINDOW, device=device)
    city = torch.stack([41.39 + (ij // side) * 0.0018,
                        2.16 + (ij % side) * 0.0024], dim=1).float()
    ones = torch.ones(WINDOW, dtype=torch.bool, device=device)
    return cases + [
        ("generic_euclidean", "euclidean", emb, ones, K_BASIS - 1, {}),
        ("duplicates_dot", "dot", dup.contiguous(), ones, K_BASIS, {}),
        ("city_200m_chord3", "chord3", ak.location_to_unit_xyz(city).contiguous(), ones,
         K_BASIS, {}),
        ("dense_dot_4096", "dot", dense, ones, K_BASIS, {}),
        ("text_512_row_chunks", "dot", xt, xv, K_BASIS, {"chunk_rows": 512}),
        ("text_bf16", "dot", xt, xv, K_BASIS, {"input_dtype": "bfloat16"}),
    ]


def edges_sha256(adj: torch.Tensor) -> str:
    """A digest of the 0/1 matrix's edges (their (row, column) indices)."""
    return hashlib.sha256(adj.nonzero().cpu().numpy().tobytes()).hexdigest()


def phase_b(cases, tag: str = "b", reps: int = 10, plain_reps: int = 10) -> list[dict]:
    rows = []
    for name, metric, x, valid, k, opts in cases:
        plain_opts = {o: v for o, v in opts.items() if o == "input_dtype"}
        got = ak.knn_adjacency(x, valid, k, metric, **opts)
        clocks = [nvidia_smi_line(CLOCKS)]
        ms = cuda_ms(lambda: ak.knn_adjacency(x, valid, k, metric, **opts), reps=reps,
                     warmup=min(2, reps))    # timed before the plain version fills the cache
        clocks.append(nvidia_smi_line(CLOCKS))
        want = ak.knn_adjacency_reference(x, valid, k, metric, **plain_opts)
        torch.cuda.synchronize()
        agree = edge_agreement(got, want)
        same_degree = bool(torch.equal(got.sum(1), want.sum(1)))
        row = {"case": name, "metric": metric, "route": ak.route(metric), **opts,
               "n": x.shape[0], "d": x.shape[1], "k": k, "edges_sha256": edges_sha256(got),
               "clocks_before_after": clocks,
               "edges": int(want.sum()), "mismatched_entries": int((got != want).sum()),
               "edge_agreement": agree, "same_degree": same_degree,
               "max_abs_err": float((got - want).abs().max()),
               "ms": ms,
               "plain_ms": cuda_ms(lambda: ak.knn_adjacency_reference(x, valid, k, metric,
                                                                      **plain_opts),
                                   reps=plain_reps, warmup=min(2, plain_reps - 1))}
        del got, want
        with_bound(row, k1_bound(metric, x.shape[0], x.shape[1]))
        print(f"[{tag}]", json.dumps(row), flush=True)
        ok = (row["mismatched_entries"] == 0 if metric in BIT_EQUAL or name.startswith("exact")
              else agree >= EDGE_AGREEMENT and same_degree)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def phase_c(mods, mtypes, labels, device, approach: str, n_records: int,
            tag: str = "c", sync_spans: bool = False) -> dict:
    cfg = PipelineConfig(seed=SEED, subset_size=n_records, noise_rate=NOISE_RATE,
                         label_mode="binary", sorting=True, window_size=WINDOW,
                         reduced_dim=REDUCED_DIM, k_basis=K_BASIS, approach=approach,
                         n_clusters_override=2)
    engine = streaming.StreamingEngine(cfg)          # the entry points' default: the card
    if engine.device.type != "cuda":
        raise AssertionError(f"StreamingEngine defaulted to {engine.device}")
    # spans that cover the device work (each span end synchronizes) only when
    # they are compared (--profile): the waits serialize the stream
    engine.timer = SpanTimer(engine.device, sync_all=sync_spans)
    n_windows = len(streaming.window_triggers(n_records, WINDOW, 1))
    before, hashed, incdb = ak.launches, native.calls, native.incdb_calls
    t0 = time.perf_counter()
    res = api.process_streaming_data(
        results=api.get_initial_results()[0], data_modalities=[m[:n_records] for m in mods],
        modality_types=mtypes, window_size=WINDOW, reduced_dim=REDUCED_DIM,
        k_basis=K_BASIS, n_clusters_total=2, seed=SEED, approach=approach,
        complete_true_labels=labels[:n_records], step_window_ratio=1,
        noise_rate=NOISE_RATE, label_mode="binary", sorting=True, eps=1.5,
        min_samples=2, cfg=cfg, engine=engine)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = {"approach": approach, "records": n_records, "windows": n_windows,
           "launches": ak.launches - before, "native_hasher_calls": native.calls - hashed,
           "native_incdbscan_calls": native.incdb_calls - incdb, "seconds": secs,
           "windows_per_s": n_windows / secs, "rows_per_s": n_windows * WINDOW / secs,
           "nmi": res["nmi_score"][0], "nmi_e": res["nmi_e_score"][0],
           "f1": res["f1_score"][0], "f1_aligned": res["f1_aligned"][0],
           "spans": engine.timer.summary()}
    print(f"[{tag}]", json.dumps(out), flush=True)
    if out["launches"] != 4 * n_windows:
        raise AssertionError(f"expected {4 * n_windows} kernel launches, got "
                             f"{out['launches']}")
    if out["native_hasher_calls"] != 2 * n_windows:   # text + tags per window
        raise AssertionError(f"featurization did not run the native hasher: "
                             f"{out['native_hasher_calls']} calls for {n_windows} windows "
                             f"({native.load_error})")
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


# ---------------------------------------------------------------------------
# huge-window slice: phases (e)-(g)
# ---------------------------------------------------------------------------

def huge_cfg(approach: str = "SWFDMC", n_records: int = HUGE_RECORDS) -> PipelineConfig:
    return PipelineConfig(seed=SEED, subset_size=n_records, noise_rate=NOISE_RATE,
                          label_mode="binary", sorting=True, window_size=HUGE_WINDOW,
                          reduced_dim=REDUCED_DIM, k_basis=K_BASIS, approach=approach,
                          n_clusters_override=2)


def huge_columns(mods, device, with_features: bool = False):
    """Column panels of the huge stream's first window, as the engine builds them
    (and its device features: the token ids, with ``with_features``)."""
    engine = streaming.StreamingEngine(huge_cfg(), device)
    host = engine.featurize([m[:HUGE_WINDOW] for m in mods], streaming.STANDARD_TYPES)
    feats = to_device(host, device)
    cols = engine.columns(host, feats, streaming.STANDARD_TYPES)
    return (cols, feats) if with_features else cols


def reset_counts() -> None:
    ak.reset_launches()
    bs.reset_launches()
    cm.reset_launches()


def huge_counts() -> dict:
    return {"K2": bs.launches, "K3": bs.pair_launches, "K4": cm.launches_t,
            "K5": cm.launches, "lists": cm.launches_lists,
            "K2_postings": bs.postings_launches, "K3_postings": bs.postings_pair_launches}


def with_routes(want: dict, k3_postings: int = 0) -> dict:
    """``want`` with the postings route's counts: every K2 call of a standard
    stream's huge path is tags or text, on the postings route; K3 pairs tags +
    text on it only in the column-sharded sweep (``k3_postings``)."""
    return {**want, "K2_postings": want["K2"], "K3_postings": k3_postings}


def gemm_yardstick(metric: str, cols: torch.Tensor, rows: torch.Tensor) -> dict:
    """Time of the bare (block, K) x (K, n) product by cuBLAS, a yardstick the
    port never calls (product only: no mask, no binning, the (block, n)
    result written out).  int8 goes through torch._int_mm."""
    if metric == "dot":
        fn, how = (lambda: torch.matmul(rows, cols.T)), "torch.matmul bf16"
    else:
        fn, how = (lambda: torch._int_mm(rows, cols.T)), "torch._int_mm int8"
    try:
        return {"gemm_ms": cuda_ms(fn, reps=5, warmup=1), "gemm": how + ", product only"}
    except RuntimeError as e:       # a yardstick: report, do not fail the run
        return {"gemm_ms": None, "gemm": f"{how} refused: {e}"[:200]}


def plain_rules(metric: str, got, want, row_valid, k: int) -> dict:
    """(e)'s rules for a K2 output against its plain version: bit-equal for
    jaccard / l1 / chord3; dot within K2_DOT_ATOL with the same real mask,
    >= 99.9% of groups and kept candidates; chord within DOT_RTOL of the
    values' scale with the same kept counts."""
    real = want[0] > bs.NEG / 2
    keep_got = bs.budgeted_keep(got[0], row_valid, k)
    keep_want = bs.budgeted_keep(want[0], row_valid, k)
    out = {"metric": metric,
           "bit_equal": bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
           "same_real_mask": bool(torch.equal(real, got[0] > bs.NEG / 2)),
           "max_abs_err": float((got[0] - want[0])[real].abs().max()) if real.any() else 0.0,
           "value_scale": float(want[0][real].abs().max()) if real.any() else 0.0,
           "grp_agreement": float((got[1] == want[1]).float().mean()),
           "keep_agreement": edge_agreement(keep_got, keep_want),
           "same_kept_counts": bool(torch.equal(keep_got.sum(1), keep_want.sum(1)))}
    if metric in HUGE_BIT_EQUAL:
        out["ok"] = out["bit_equal"]
    elif metric == "dot":
        out["ok"] = (out["same_real_mask"] and out["max_abs_err"] <= K2_DOT_ATOL
                     and out["grp_agreement"] >= K2_DOT_GROUP_AGREEMENT
                     and out["keep_agreement"] >= KEEP_AGREEMENT)
    else:
        out["ok"] = (out["same_real_mask"]
                     and out["max_abs_err"] <= DOT_RTOL * out["value_scale"]
                     and out["keep_agreement"] >= KEEP_AGREEMENT and out["same_kept_counts"])
    return out


def k2_check(name: str, metric: str, x, valid, row_sums, k: int, *, start: int,
             block: int, nbins: int, per_window: dict, tag: str = "e",
             postings: bs.Postings | None = None) -> dict:
    """K2 on rows [start, start + block) of the panel ``x`` against its plain
    version: bit-equal for jaccard / l1 / chord3 and integer-valued dot,
    within the tolerances above for dot / chord; times, bound, splits.  With
    ``postings`` on the postings route: also bit-equal to the postings plain
    version (the kernel's summation order), its bound counted on the nonzero
    rule, the dense count beside as ``bound_dense_ms``."""
    x = x.contiguous()
    n = x.shape[0]
    rows = slice(start, start + block)

    def run(fn, **kw):
        return fn(x, x[rows], valid, start, metric=metric, nbins=nbins, block=block,
                  row_sums=row_sums, **kw)

    def kernel():
        return run(bs.binned_candidates, postings=postings)

    before = bs.launches
    got, want = kernel(), run(bs.binned_candidates_plain)
    torch.cuda.synchronize()
    rules = plain_rules(metric, got, want, valid[rows], k)
    route = bs.route(metric, postings)
    row = {"case": name, "metric": metric, "route": route, "n": n, "block": block,
           "start": start, "nbins": nbins, "groups": n // nbins, "K": x.shape[1],
           "dtype": str(x.dtype).replace("torch.", ""), "launched": bs.launches - before,
           "splits": 1 if route == "postings" else bs.kernel_splits(n, block, nbins, metric),
           **{key: v for key, v in rules.items() if key not in ("metric", "ok")},
           "ms": cuda_ms(kernel, reps=5, warmup=1),
           "plain_ms": cuda_ms(lambda: run(bs.binned_candidates_plain), reps=3, warmup=1),
           "launches_per_window": per_window}
    dense = k2_bound(metric, n, block, nbins, x.shape[1], x.element_size())
    if postings is not None:
        same = bs.binned_candidates_postings_plain(postings, x[rows], valid, start,
                                                   metric=metric, nbins=nbins, block=block,
                                                   row_sums=row_sums)
        row["bit_equal_to_postings_plain"] = bool(torch.equal(got[0], same[0])
                                                  and torch.equal(got[1], same[1]))
        with_bound(row, k2_postings_bound(metric, postings, x[rows], nbins))
        row["bound_dense_ms"] = dense["bound_ms"]
        row["share_of_dense_bound"] = dense["bound_ms"] / row["ms"]
    else:
        with_bound(row, dense)
    if metric in bs.COORD_METRICS:
        row["share_of_fma_rate_bound"] = row["bound_fma_rate_ms"] / row["ms"]
    if (metric in ("dot", "jaccard") and postings is None
            and not name.startswith("text_integer_valued")):
        row.update(gemm_yardstick(metric, x, x[rows]))
    print(f"[{tag}] K2", json.dumps(row), flush=True)
    # integer-valued dot operands sum exactly in any order: bit-equal there
    ok = row["bit_equal"] if name.startswith("text_integer_valued") else rules["ok"]
    ok = ok and row.get("bit_equal_to_postings_plain", True)
    if not (ok and row["launched"] == 1):
        raise AssertionError(f"K2 disagrees with its plain version: {row}")
    return row


def revalued(post: bs.Postings, panel: torch.Tensor) -> bs.Postings:
    """``post`` with its values read from ``panel``, a panel of the same
    nonzero pattern (each entry's feature found from the table)."""
    e = torch.arange(post.cols.numel(), device=panel.device)
    feat = torch.searchsorted(post.table[:, -1].contiguous(), e.to(torch.int32), right=True)
    vals = panel[post.cols.long(), feat.clamp(max=post.k - 1)]
    return post._replace(vals=torch.where(feat < post.k, vals, torch.zeros_like(vals)))


def sum_rows(rows: list, what: str) -> dict:
    """ms, bound (nonzero rule where it applies) and the dense bound of calls
    made together, with their share."""
    out = {"ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
           "bound_ms": sum(r["bound_ms"] for r in rows),
           "bound_dense_ms": sum(r.get("bound_dense_ms", r["bound_ms"]) for r in rows),
           "routes": [r["route"] for r in rows], "timed": what}
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def k3_check(xyz, lv, tim, tv, *, start: int, block: int, nbins: int, per_window: dict,
             tag: str = "e") -> dict:
    """K3 (location chord3 + time l1) against two K2 launches and the plain
    version, bit-equal; times and bound."""
    n = xyz.shape[0]
    rows = slice(start, start + block)

    def pair():
        return bs.binned_candidates_pair(xyz, tim, xyz[rows], tim[rows], lv, tv, start,
                                         metricA="chord3", metricB="l1", nbins=nbins,
                                         block=block)

    def two_k2(fn):
        return (*fn(xyz, xyz[rows], lv, start, metric="chord3", nbins=nbins, block=block),
                *fn(tim, tim[rows], tv, start, metric="l1", nbins=nbins, block=block))

    got, singles, plain = pair(), two_k2(bs.binned_candidates), two_k2(bs.binned_candidates_plain)
    torch.cuda.synchronize()
    row = {"case": "location+time", "n": n, "start": start, "nbins": nbins,
           "groups": n // nbins,
           "bit_equal_to_two_k2": all(torch.equal(a, b) for a, b in zip(got, singles)),
           "bit_equal_to_plain": all(torch.equal(a, b) for a, b in zip(got, plain)),
           "ms": cuda_ms(pair, reps=5, warmup=1),
           "plain_ms": cuda_ms(lambda: two_k2(bs.binned_candidates_plain), reps=3, warmup=1),
           "launches_per_window": per_window}
    with_bound(row, coord_bound([("chord3", xyz.shape[1]), ("l1", tim.shape[1])], n, block,
                                nbins))
    row["share_of_fma_rate_bound"] = row["bound_fma_rate_ms"] / row["ms"]
    print(f"[{tag}] K3", json.dumps(row), flush=True)
    if not (row["bit_equal_to_two_k2"] and row["bit_equal_to_plain"]):
        raise AssertionError(f"K3 disagrees with two K2 launches: {row}")
    return row


def union_check(cols: ba.Columns, *, start: int, block: int, nbins: int, tag: str) -> dict:
    """The union kernel writing one block's f32 rows (the blocked SVD's
    operand) from its K2 / K3 candidates, bit-equal to its plain version
    (``cm.dense_rows_reference``) of the same candidates; times and bound
    (the bytes written and read; one comparison per plane and the uid's per
    element)."""
    n = cols.n
    cand = ba.candidate_rowblock(cols, start, block, K_BASIS, nbins)

    def plain():
        return cm.dense_rows_reference(cand).float()

    planes = cand.slabs.shape[0]
    row = {"n": n, "start": start, "nbins": nbins, "planes": planes,
           "bit_equal": bool(torch.equal(bs.union_rowblock(cand), plain())),
           "ms": cuda_ms(lambda: bs.union_rowblock(cand)),
           "plain_ms": cuda_ms(plain, reps=3, warmup=1)}
    nbytes = block * n * 4 + cand.slabs.numel() + cand.uid_cols.numel() * 4 + block * 4
    with_bound(row, bound(block * n * (planes + 1), "fp32_instr", nbytes))
    print(f"[{tag}] union", json.dumps(row), flush=True)
    if not row["bit_equal"]:
        raise AssertionError(f"the union kernel disagrees with its plain version: {row}")
    return row


def phase_e(cols: ba.Columns, device, parent: str | None = None, profile: bool = False,
            feats: tuple | None = None) -> dict:
    print(f"[e] card: {nvidia_smi_line()}", flush=True)
    n, block, start, nbins = cols.n, HUGE_BLOCK, 0, HUGE_NBINS
    if bs.default_nbins(n, k_max=3 * K_BASIS) != nbins:
        raise AssertionError(f"default_nbins({n}) != {nbins}")
    by_kind = dict(zip(cols.kinds, zip(cols.tensors, cols.valids)))
    by_post = dict(zip(cols.kinds, cols.postings_of()))
    (xyz, lv), (tim, tv) = by_kind["location_xyz"], by_kind["time"]
    ((tags, sums), tagv), (text, textv) = by_kind["tags"], by_kind["text_bf16"]
    ptags, ptext = by_post["tags"], by_post["text_bf16"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    generic = ba.generic_columns([torch.randn((n, 128), generator=gen, device=device)],
                                 ("default",), device)
    (dft, sq), dv = generic.tensors[0], generic.valids[0]
    # integer-valued text on text's nonzero pattern: sums exact in any order
    text_int = torch.where(text != 0, (torch.randint(1, 8, tuple(text.shape), generator=gen,
                                                     device=device) / 4).to(torch.bfloat16),
                           torch.zeros((), dtype=torch.bfloat16, device=device))
    ptext_int = revalued(ptext, text_int)
    per_window = {"tags": BLOCKS_PER_WINDOW, "text": BLOCKS_PER_WINDOW}
    out = {"K2": {}}
    if feats is not None:
        out["postings_build"] = postings_build_check(feats, tags, text, ptags, ptext)
    earlier = []
    if parent:
        saved = save_k2(tags, tagv, sums, text, textv, start, block, nbins)
        earlier.append(earlier_k2(parent, saved))
    for name, metric, x, valid, row_sums, k, post in [
            ("location", "chord3", xyz, lv, None, K_BASIS, None),
            ("time", "l1", tim, tv, None, 3 * K_BASIS, None),
            ("tags", "jaccard", tags, tagv, sums, K_BASIS, ptags),
            ("text", "dot", text, textv, None, K_BASIS, ptext),
            ("text_integer_valued", "dot", text_int, textv, None, K_BASIS, ptext_int),
            ("tags_dense", "jaccard", tags, tagv, sums, K_BASIS, None),
            ("text_dense", "dot", text, textv, None, K_BASIS, None),
            ("text_integer_valued_dense", "dot", text_int, textv, None, K_BASIS, None),
            ("generic_default", "chord", dft, dv, sq, K_BASIS - 1, None)]:
        out["K2"][name] = k2_check(
            name, metric, x, valid, row_sums, k, start=start, block=block, nbins=nbins,
            per_window={"SWFDMC": per_window.get(name, 0),
                        "sSVDMC": SSVD_SWEEPS * per_window.get(name, 0)}, postings=post)
    del text_int, ptext_int
    k2 = out["K2"]
    out["K2_per_block"] = {
        "postings": sum_rows([k2["tags"], k2["text"]], "tags + text, postings route"),
        "dense": sum_rows([k2["tags_dense"], k2["text_dense"]],
                          "tags + text, tensor-core route")}
    if parent:
        earlier.append(earlier_k2(parent, saved))
        shutil.rmtree(os.path.dirname(saved))
        rows = slice(start, start + block)
        dense_out = {"tags": bs.binned_candidates(tags, tags[rows], tagv, start,
                                                  metric="jaccard", nbins=nbins, block=block,
                                                  row_sums=sums),
                     "text": bs.binned_candidates(text, text[rows], textv, start,
                                                  metric="dot", nbins=nbins, block=block)}
        out["K2_per_block"]["earlier_tree"] = k2_against_earlier(
            earlier, {"tags": k2["tags_dense"], "text": k2["text_dense"]},
            {"tags": k2["tags"], "text": k2["text"]}, dense_out)
    print("[e] K2 per block", json.dumps(out["K2_per_block"]), flush=True)
    out["K3"] = k3_check(xyz, lv, tim, tv, start=start, block=block, nbins=nbins,
                         per_window={"SWFDMC": BLOCKS_PER_WINDOW,
                                     "sSVDMC": SSVD_SWEEPS * BLOCKS_PER_WINDOW})
    out["union"] = union_check(cols, start=start, block=block, nbins=nbins, tag="e")

    cand = ba.candidate_rowblock(cols, start, block, K_BASIS, nbins)
    dense = cm.dense_rows_reference(cand)
    edges_dense = int(dense.sum())
    out["lists"] = lists_check(cand, edges_dense)
    cand = cm.with_lists(cand)           # built once: the fold's three products share it
    bare = cm.with_lists(cand._replace(uid_rows=None, lists=None))   # the username term's share
    csr = sparse_yardstick(dense)
    del dense
    ell = min(REDUCED_DIM, n)
    r = ell + 16
    rp = -(-r // 128) * 128
    v = fd.default_probe(ell + block, r, device)
    v_r = v[ell:]
    v_hi = v_r.to(torch.bfloat16)
    v_lo = (v_r - v_hi.float()).to(torch.bfloat16)

    def pad_rows(x, m):
        return torch.nn.functional.pad(x, (0, 0, 0, m - x.shape[0]))

    # the fold's two K4 calls take the live rows (power step r, [hi | lo] 2r);
    # the JAX package's 128-padded operands (128 / 256 rows) are timed beside them
    probe_t = v_hi.T.contiguous()
    hilo_t = torch.cat([v_hi.T, v_lo.T]).contiguous()
    y0 = cm.matvec_t(cand, probe_t)[0].T                          # rows^T v, as the fold
    probe_y = y0.to(torch.bfloat16).contiguous()                 # K5's live r, as the fold
    probe_y_pad = torch.nn.functional.pad(y0, (0, rp - r)).to(torch.bfloat16).contiguous()
    ints = torch.Generator(device=device).manual_seed(SEED + 1)
    cases = []
    for name, x, per_win, tol in [
            ("K4", probe_t, BLOCKS_PER_WINDOW, K4_PROBE_RTOL),
            ("K4", hilo_t, BLOCKS_PER_WINDOW, K4_PROBE_RTOL),
            ("K4", pad_rows(v_hi.T, rp).contiguous(), 0, K4_PROBE_RTOL),
            ("K4", torch.cat([pad_rows(v_hi.T, rp), pad_rows(v_lo.T, rp)]).contiguous(), 0,
             K4_PROBE_RTOL),
            ("K5", probe_y, BLOCKS_PER_WINDOW, PROBE_RTOL),
            ("K5", probe_y_pad, 0, PROBE_RTOL)]:
        xi = torch.randint(-4, 5, tuple(x.shape), generator=ints, device=device).to(
            torch.bfloat16)
        rr = x.shape[1] if name == "K5" else x.shape[0]
        cases.append((f"{name}_{rr}", name, rr, x, xi, per_win, tol))
    earlier = []
    if parent:
        saved = save_products(cand, cases)
        earlier.append(earlier_products(parent, saved))
    checks = []
    for key, name, rr, x, xi, per_win, tol in cases:
        fn, ref = ((cm.matvec_t, cm.matvec_t_reference) if name == "K4"
                   else (cm.matvec, cm.matvec_reference))
        gi, wi = fn(cand, xi), ref(cand, xi)
        gp, wp, gp2 = fn(cand, x), ref(cand, x), fn(cand, x)
        torch.cuda.synchronize()
        if name == "K4":
            (gi, ge), (wi, we), (gp, _), (wp, _), (gp2, _) = gi, wi, gp, wp, gp2
        row = {"kernel": name, "r": rr, "on_main_path": per_win > 0,
               "exact_on_integers": bool(torch.equal(gi, wi)),
               "bit_identical_twice": bool(torch.equal(gp, gp2)),
               "probe_max_abs_err": float((gp - wp).abs().max()),
               "probe_rel_err": float((gp - wp).abs().max() / wp.abs().max().clamp(min=1e-30)),
               "ms": cuda_ms(lambda: fn(cand, x), reps=5, warmup=1),
               "plain_ms": cuda_ms(lambda: ref(cand, x), reps=3, warmup=1),
               "launches_per_window": {"SWFDMC": per_win, "sSVDMC": 0},
               "block_edges": edges_dense}
        row.update(csr(name, x))
        # the dense count is the tile-rebuilding design's: it reads the slabs
        io = rr * block * 2 + rr * n * 4 + 4 if name == "K4" else n * rr * 2 + block * rr * 4
        with_bound(row, bound(2.0 * rr * edges_dense, "bf16",
                              product_bytes(name, rr, cand, out["lists"])))
        row["bound_dense_ms"] = bound(2.0 * rr * block * n, "bf16",
                                      cand_bytes(cand) + io)["bound_ms"]
        row["share_of_dense_bound"] = row["bound_dense_ms"] / row["ms"]
        if name == "K4":
            row["edges"] = float(ge)
            row["edges_exact"] = float(ge) == float(we) == edges_dense
        if per_win:                          # the username term's share
            row["ms_without_usernames"] = cuda_ms(lambda: fn(bare, x), reps=5, warmup=1)
        print(f"[e] {name}", json.dumps(row), flush=True)
        if not (row["exact_on_integers"] and row["probe_rel_err"] <= tol
                and row["bit_identical_twice"] and row.get("edges_exact", True)):
            raise AssertionError(f"{name} disagrees with its plain version: {row}")
        checks.append(row)
    if parent:
        earlier.append(earlier_products(parent, saved))
        out["against_earlier_tree"] = products_against(cases, cand, checks, earlier)
    if profile:                          # device time by kernel, 10 calls each
        for name, fn in (("lists", lambda: cm.build_lists(cand._replace(lists=None))),
                         ("K4 r=66", lambda: cm.matvec_t(cand, probe_t)),
                         ("K4 r=132", lambda: cm.matvec_t(cand, hilo_t)),
                         ("K5 r=66", lambda: cm.matvec(cand, probe_y))):
            fn()

            def ten(fn=fn):
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            traced(ten, {"call": name, "calls": 10}, tag="e profile")
    out["K4"] = [c for c in checks if c["kernel"] == "K4"]
    out["K5"] = [c for c in checks if c["kernel"] == "K5"]
    return out


def lists_check(cand: cm.CandBlock, edges_dense: int) -> dict:
    """The list kernels on the block against their plain version (every
    array the products read, exact), the exact edge count; times and bound
    (bytes: the slabs and uids read once, the lists the products read
    written once)."""
    before = cm.launches_lists
    lists = cm.build_lists(cand)
    want = cm.lists_reference(cand)
    torch.cuda.synchronize()
    e, nu = want["rowcols"].numel(), int(want["nu"][0])
    got = {"rowptr": lists.array("rowptr"), "rowcols": lists.array("rowcols")[:e],
           "colptr": lists.array("colptr"), "colrows": lists.array("colrows")[:e],
           "uids": lists.array("uids")[:nu], "userptr": lists.array("userptr")[:nu + 1],
           "userrows": lists.array("userrows"), "row_user": lists.array("row_user"),
           "col_user": lists.array("col_user"),
           "ucolptr": lists.array("hoff")[torch.arange(nu + 1, device=lists.workspace.device)
                                          * lists.q],
           "ucols": lists.array("ucols")[:want["ucols"].numel()]}
    differ = [k for k, v in got.items() if not torch.equal(v.long(), want[k].long())]
    same_shape = [(v.long(), want[k].long()) for k, v in got.items()
                  if v.shape == want[k].shape]
    mismatched = sum(int((a != b).sum()) for a, b in same_shape) + sum(
        max(v.numel(), want[k].numel()) for k, v in got.items() if v.shape != want[k].shape)
    max_err = max((int((a - b).abs().max()) for a, b in same_shape if a.numel()), default=0)
    written = 4 * sum(v.numel() for v in got.values()) + 8
    lens = want["colptr"][1:] - want["colptr"][:-1]
    heavy = lens > HEAVY_ROWS
    row = {"kernel": "lists", "block_edges": edges_dense, "list_entries": e, "users": nu,
           "user_columns": int(want["ucols"].numel()), "edges": int(lists.edges[0]),
           "longest_column": int(lens.max()), "heavy_columns": int(heavy.sum()),
           "heavy_entries": int(lens[heavy].sum()),
           "heavy_listed": int(lists.array("nhubs")[0]),
           "launched": cm.launches_lists - before, "arrays_differ": differ,
           "mismatched_entries": mismatched, "max_abs_err": float(max_err),
           "ms": cuda_ms(lambda: cm.build_lists(cand), reps=5, warmup=1),
           "plain_ms": cuda_ms(lambda: cm.lists_reference(cand), reps=3, warmup=1),
           "launches_per_window": {"SWFDMC": BLOCKS_PER_WINDOW, "sSVDMC": 0},
           "library_ms": None}
    with_bound(row, bound(0.0, "int8", cand_bytes(cand) + written))
    print("[e] lists", json.dumps(row), flush=True)
    if differ or row["launched"] != 1 or not row["edges"] == want["edges"] == edges_dense \
            or row["heavy_listed"] != row["heavy_columns"]:
        raise AssertionError(f"the list kernels disagree with their plain version: {row}")
    return row


def sparse_yardstick(dense: torch.Tensor):
    """``library_ms`` of K4 / K5: one cuSPARSE product through torch.sparse of
    the same fused block as a CSR tensor (built here, outside the timed
    region): A @ y for K5, A^T (its own CSR) @ x for K4.  bf16 values as the
    kernels' operands, f32 where torch refuses bf16.  A yardstick the port
    never calls."""
    mats = {}

    def time_it(name: str, x: torch.Tensor) -> dict:
        dense_op = x if name == "K5" else x.T
        for dtype in (torch.bfloat16, torch.float32):
            try:
                if (name, dtype) not in mats:
                    a = dense if name == "K5" else dense.T
                    mats[name, dtype] = a.to(dtype).to_sparse_csr()
                a, b = mats[name, dtype], dense_op.to(dtype).contiguous()
                return {"library_ms": cuda_ms(lambda: torch.sparse.mm(a, b), reps=5,
                                              warmup=1),
                        "library": f"torch.sparse.mm, CSR {str(dtype)[6:]} (cuSPARSE)"}
            except RuntimeError as e:        # a yardstick: report, do not fail the run
                err = f"{str(dtype)[6:]} refused: {e}"[:200]
        return {"library_ms": None, "library": err}
    return time_it


EARLIER_K2 = """
import json, sys, torch
from mused_tpu_torch.ops.kernels import blocked_select as bs
d = torch.load(sys.argv[1])
dev = torch.device("cuda")
start, block, nbins = d["start"], d["block"], d["nbins"]
tags, tagv, sums = (t.to(dev) for t in d["tags"])
text, textv = (t.to(dev) for t in d["text"])
rows = slice(start, start + block)
def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
calls = {
    "tags": lambda: bs.binned_candidates(tags, tags[rows], tagv, start, metric="jaccard",
                                         nbins=nbins, block=block, row_sums=sums),
    "text": lambda: bs.binned_candidates(text, text[rows], textv, start, metric="dot",
                                         nbins=nbins, block=block),
    "tags+text": lambda: bs.binned_candidates_pair(
        tags, text, tags[rows], text[rows], tagv, textv, start, metricA="jaccard",
        metricB="dot", nbins=nbins, block=block, row_sumsA=sums)}
outs = {k: tuple(t.cpu() for t in fn()) for k, fn in calls.items()}
times = {k: ms(fn) for k, fn in calls.items()}
torch.save(outs, sys.argv[2])
print("[earlier-k2]", json.dumps(times), flush=True)
"""


def save_k2(tags, tagv, sums, text, textv, start: int, block: int, nbins: int) -> str:
    """The tags and text panels of a K2 check in a file an earlier tree can read."""
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_k2_"), "k2.pt")
    torch.save({"start": start, "block": block, "nbins": nbins,
                "tags": (tags.cpu(), tagv.cpu(), sums.cpu()),
                "text": (text.cpu(), textv.cpu())}, path)
    return path


def earlier_k2(tree: str, saved: str) -> dict:
    """K2 (tags, text) and K3 (tags + text) of the tree unpacked at ``tree``
    (its own kernels, built there) on the saved panels: ms and outputs."""
    torch.cuda.empty_cache()
    tree = os.path.abspath(tree)
    outs = saved + f".{len(os.listdir(os.path.dirname(saved)))}.out"
    proc = subprocess.run([sys.executable, "-c", EARLIER_K2, saved, outs], cwd=tree,
                          env={**os.environ, "PYTHONPATH": tree}, capture_output=True,
                          text=True, timeout=900)
    rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("[earlier-k2] ")]
    if proc.returncode != 0 or not rows:
        raise AssertionError(f"the tree at {tree} failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return {"ms": json.loads(rows[-1][len("[earlier-k2] "):]), "outputs": torch.load(outs)}


def k2_against_earlier(earlier: list, dense: dict, postings: dict,
                       dense_out: dict | None = None) -> dict:
    """The earlier tree's K2 / K3 ms (timed before and after this tree's)
    beside this tree's dense and postings routes; the earlier outputs equal
    to this tree's dense route's (the same tensor-core kernel) bit for bit."""
    out = {"earlier_ms": {k: [e["ms"][k] for e in earlier] for k in earlier[0]["ms"]},
           "dense_ms": {k: r["ms"] for k, r in dense.items()},
           "postings_ms": {k: r["ms"] for k, r in postings.items()}}
    out["earlier_per_block_ms"] = [e["ms"]["tags"] + e["ms"]["text"] for e in earlier]
    out["postings_per_block_ms"] = sum(out["postings_ms"].values())
    out["dense_per_block_ms"] = sum(out["dense_ms"].values())
    if dense_out is not None:
        out["earlier_equals_dense_route"] = all(
            torch.equal(a.cpu(), b.cpu()) for key in ("tags", "text")
            for a, b in zip(earlier[0]["outputs"][key], dense_out[key]))
        if not out["earlier_equals_dense_route"]:
            raise AssertionError(f"the earlier tree's K2 differs from the dense route: {out}")
    return out


def postings_build_check(feats: tuple, tags, text, ptags, ptext) -> dict:
    """The postings build of the window's tags and text, as the column
    builders run it (from the token ids): equal to the window's own postings,
    ms, bound (bytes)."""
    tags_ids, text_ids = feats[3], feats[4]
    out = {}
    for name, panel, ids, want in (("tags", tags, tags_ids, ptags),
                                   ("text", text, text_ids, ptext)):
        got = bs.build_postings(panel, ids)
        row = {"n": panel.shape[0], "K": panel.shape[1], "token_width": ids.shape[1],
               "capacity": got.cols.numel(), "entries": int(got.entries),
               "equal": all(torch.equal(a, b) for a, b in zip(got[:3], want[:3])),
               "ms": cuda_ms(lambda p=panel, i=ids: bs.build_postings(p, i), reps=5,
                             warmup=1)}
        with_bound(row, postings_build_bound(panel.shape[0], panel.shape[1], ids, got))
        out[name] = row
    out["ms"] = out["tags"]["ms"] + out["text"]["ms"]
    out["bound_ms"] = out["tags"]["bound_ms"] + out["text"]["bound_ms"]
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    print("[e] postings build", json.dumps(out), flush=True)
    if not (out["tags"]["equal"] and out["text"]["equal"]):
        raise AssertionError(f"the postings build differs from the window's: {out}")
    return out


EARLIER_PRODUCTS = """
import json, sys, torch
from mused_tpu_torch.ops.kernels import cand_matvec as cm
d = torch.load(sys.argv[1])
dev = torch.device("cuda")
cand = cm.CandBlock(d["slabs"].to(dev), d["uid_rows"].to(dev), d["uid_cols"].to(dev),
                    d["start"])
def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
outs, rows = {}, {}
for key, name, x, xi in d["cases"]:
    fn = cm.matvec_t if name == "K4" else cm.matvec
    x, xi = x.to(dev), xi.to(dev)
    first = lambda res: res[0] if name == "K4" else res
    outs[key] = (first(fn(cand, x)).cpu(), first(fn(cand, xi)).cpu())
    rows[key] = ms(lambda: fn(cand, x))
torch.save(outs, sys.argv[2])
print("[earlier-e]", json.dumps(rows), flush=True)
"""


def save_products(cand: cm.CandBlock, cases: list) -> str:
    """Phase e's block and operands in a file an earlier tree can read."""
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_e_"), "products.pt")
    torch.save({"slabs": cand.slabs.cpu(), "uid_rows": cand.uid_rows.cpu(),
                "uid_cols": cand.uid_cols.cpu(), "start": int(cand.start),
                "cases": [(key, name, x.cpu(), xi.cpu())
                          for key, name, _, x, xi, _, _ in cases]}, path)
    return path


def earlier_products(tree: str, saved: str) -> dict:
    """K4 / K5 of the tree unpacked at ``tree`` (its own kernels, built
    there) on phase e's saved block and operands: ms per case and the
    outputs (probe, integers)."""
    torch.cuda.empty_cache()
    tree = os.path.abspath(tree)
    outs = saved + f".{len(os.listdir(os.path.dirname(saved)))}.out"
    proc = subprocess.run([sys.executable, "-c", EARLIER_PRODUCTS, saved, outs], cwd=tree,
                          env={**os.environ, "PYTHONPATH": tree}, capture_output=True,
                          text=True, timeout=900)
    rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("[earlier-e] ")]
    if proc.returncode != 0 or not rows:
        raise AssertionError(f"the tree at {tree} failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return {"ms": json.loads(rows[-1][len("[earlier-e] "):]), "outputs": torch.load(outs)}


def products_against(cases: list, cand: cm.CandBlock, checks: list, earlier: list) -> dict:
    """This tree's K4 / K5 against the earlier tree's on the same block and
    operands, timed in turns (earlier, this, earlier): ms each, the integer
    outputs bit-equal, the probe outputs' largest difference over the
    largest value."""
    out = {}
    for (key, name, _, x, xi, _, _), row in zip(cases, checks):
        fn = cm.matvec_t if name == "K4" else cm.matvec
        first = (lambda res: res[0]) if name == "K4" else (lambda res: res)
        got_p, got_i = first(fn(cand, x)).cpu(), first(fn(cand, xi)).cpu()
        old_p, old_i = earlier[0]["outputs"][key]
        out[key] = {"earlier_ms": [e["ms"][key] for e in earlier], "ms": row["ms"],
                    "integers_equal": bool(torch.equal(got_i, old_i)),
                    "probe_rel_diff": float((got_p - old_p).abs().max()
                                            / old_p.abs().max().clamp(min=1e-30))}
    print("[e] K4 / K5 against the earlier tree", json.dumps(out), flush=True)
    if not all(v["integers_equal"] for v in out.values()):
        raise AssertionError(f"K4 / K5 differ from the earlier tree's on integers: {out}")
    return out


def phase_f(mods, mtypes, labels, device, approach: str, n_records: int,
            tag: str = "f") -> dict:
    cfg = huge_cfg(approach, n_records)
    engine = streaming.StreamingEngine(cfg, device)
    windows = len(streaming.window_triggers(n_records, HUGE_WINDOW, 1))
    reset_counts()
    hashed = native.calls
    t0 = time.perf_counter()
    res = api.process_streaming_data(
        results=api.get_initial_results()[0], data_modalities=[m[:n_records] for m in mods],
        modality_types=mtypes, window_size=HUGE_WINDOW, reduced_dim=REDUCED_DIM,
        k_basis=K_BASIS, n_clusters_total=2, seed=SEED, approach=approach,
        complete_true_labels=labels[:n_records], step_window_ratio=1,
        noise_rate=NOISE_RATE, label_mode="binary", sorting=True, eps=1.5,
        min_samples=2, device=device, cfg=cfg, engine=engine)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = huge_counts()
    blocks = HUGE_WINDOW // HUGE_BLOCK
    sweeps = SPECTRAL_SWEEPS if approach == "sSpectral" else SSVD_SWEEPS
    per_window = with_routes({"K2": 2 * blocks, "K3": blocks, "K4": 2 * blocks,
                              "K5": blocks, "lists": blocks}
                             if approach == "SWFDMC" else
                             {"K2": 2 * sweeps * blocks, "K3": sweeps * blocks, "K4": 0,
                              "K5": 0, "lists": 0})
    out = {"approach": approach, "records": n_records, "windows": windows,
           "launches": counts, "k1_launches": ak.launches,
           "union_launches": bs.union_launches,
           "native_hasher_calls": native.calls - hashed, "seconds": secs,
           "windows_per_s": windows / secs, "rows_per_s": windows * HUGE_WINDOW / secs,
           "nmi": res["nmi_score"][0], "nmi_e": res["nmi_e_score"][0],
           "f1": res["f1_score"][0], "f1_aligned": res["f1_aligned"][0],
           "spans": engine.timer.summary()}
    print(f"[{tag}]", json.dumps(out), flush=True)
    want = {k: v * windows for k, v in per_window.items()}
    if counts != want or ak.launches:
        raise AssertionError(f"{approach}: launches {counts} (K1 {ak.launches}), "
                             f"expected {want} and no K1")
    union = 0 if approach == "SWFDMC" else sweeps * blocks * windows   # one per swept block
    if bs.union_launches != union:
        raise AssertionError(f"{approach}: {bs.union_launches} union launches, expected {union}")
    if out["native_hasher_calls"] != 2 * windows:
        raise AssertionError(f"featurization did not run the native hasher: {out}")
    metric_vals = [out[k] for k in ("nmi", "nmi_e", "f1", "f1_aligned")]
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in metric_vals):
        raise AssertionError(f"metrics out of range: {metric_vals}")
    return out


def postings_syncs(mods, mtypes, labels, device) -> dict:
    """Host synchronizations of one huge SWFDMC window by call site, under
    ``torch.cuda.set_sync_debug_mode("warn")``: none may come from the
    postings build or the K2 / K3 wrappers (``ops/kernels/blocked_select``)."""
    with contextlib.redirect_stdout(io.StringIO()):
        out = sync_count(lambda: phase_f(mods, mtypes, labels, device, "SWFDMC", HUGE_WINDOW,
                                         tag="f syncs"), 1)
    out["blocked_select_sites"] = [x for x in out["sites"]
                                   if "ops/kernels/blocked_select.py" in x["site"]]
    print("[f] host syncs of one huge SWFDMC window", json.dumps(out), flush=True)
    if out["blocked_select_sites"]:
        raise AssertionError(f"the postings build or K2 / K3 wait on the host: {out}")
    return out


# phase f's huge windows and i1's blocked SVDMC_batch call in a tree, run from
# its root (that tree's chip_smoke, modules and kernels): paired trials
TRIAL = """
import json, sys, torch
import chip_smoke as cs
cs.streaming.configure_precision()
device = torch.device("cuda")
cs.build.load()
hmods, hmtypes, hlabels = cs.make_stream(cs.HUGE_RECORDS, noise_rate=cs.NOISE_RATE,
                                         binary=True, sort_by_uploaded=True, seed=cs.SEED)
out = {}
for approach in ("SWFDMC", "sSVDMC"):
    r = cs.phase_f(hmods, hmtypes, hlabels, device, approach, cs.HUGE_RECORDS, tag="trial f")
    out[approach] = {k: r[k] for k in ("seconds", "windows", "windows_per_s", "nmi", "f1")}
del hmods, hmtypes, hlabels
torch.cuda.empty_cache()
mods, mtypes, labels = cs.make_stream(cs.N_RECORDS, noise_rate=cs.NOISE_RATE, binary=True,
                                      sort_by_uploaded=True, seed=cs.SEED)
r = cs.batch_run(mods, mtypes, labels, "SVDMC_batch", cs.N_RECORDS, tag="trial i1")
out["SVDMC_batch"] = {k: r[k] for k in ("seconds", "rows_per_s", "nmi", "f1")}
print("[trial]", json.dumps(out), flush=True)
"""


def paired_trials(parent: str) -> dict:
    """Phase f's huge windows (SWFDMC, sSVDMC: windows/s) and i1's blocked
    SVDMC_batch call (seconds), each tree in a process of its own, in turns
    (earlier, this, this, earlier) and spaced a few seconds apart; NMI and F1
    within 0.01 of the earlier tree's."""
    here = os.path.dirname(os.path.abspath(__file__))
    trials = []
    for which, tree in (("earlier", parent), ("this", here), ("this", here),
                        ("earlier", parent)):
        torch.cuda.empty_cache()
        time.sleep(5)
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", TRIAL], cwd=tree,
                              env={**os.environ, "PYTHONPATH": tree}, capture_output=True,
                              text=True, timeout=900)
        rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("[trial] ")]
        if proc.returncode != 0 or not rows:
            raise AssertionError(f"the trial in {tree} failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        trials.append({"tree": which, **json.loads(rows[-1][len("[trial] "):])})
    out = {"order": [t["tree"] for t in trials], "trials": trials}
    for key, metric in (("SWFDMC", "windows_per_s"), ("sSVDMC", "windows_per_s"),
                        ("SVDMC_batch", "seconds")):
        out[key] = {tree: [t[key][metric] for t in trials if t["tree"] == tree]
                    for tree in ("earlier", "this")}
        out[key]["metric"] = metric
        for q in ("nmi", "f1"):
            old = [t[key][q] for t in trials if t["tree"] == "earlier"]
            new = [t[key][q] for t in trials if t["tree"] == "this"]
            out[key][f"{q}_max_diff"] = max(abs(a - b) for a in old for b in new)
    print("[f] paired trials against the earlier tree", json.dumps(out), flush=True)
    bad = {k: v for k, v in out.items() if isinstance(v, dict) and
           max(v.get("nmi_max_diff", 0), v.get("f1_max_diff", 0)) > 0.01}
    if bad:
        raise AssertionError(f"NMI / F1 moved by more than 0.01 from the earlier tree's: {bad}")
    return out


def profile_huge_window(mods, mtypes, labels, approach: str) -> dict:
    """Device time by kernel and the busy share of one huge window, traced
    with torch.profiler after a warm-up window (``--profile``)."""
    kw = dict(modality_types=mtypes, window_size=HUGE_WINDOW, reduced_dim=REDUCED_DIM,
              k_basis=K_BASIS, n_clusters_total=2, seed=SEED, approach=approach,
              step_window_ratio=1, noise_rate=NOISE_RATE, label_mode="binary",
              sorting=True, eps=1.5, min_samples=2)

    def one_window(w: int):
        rows = slice(w * HUGE_WINDOW, (w + 1) * HUGE_WINDOW)
        cfg = huge_cfg(approach, HUGE_WINDOW)
        api.process_streaming_data(results=api.get_initial_results()[0],
                                   data_modalities=[m[rows] for m in mods],
                                   complete_true_labels=labels[rows], cfg=cfg, **kw)
        torch.cuda.synchronize()

    one_window(0)
    return traced(lambda: one_window(1), {"approach": approach})


def traced(run, what: dict, tag: str = "profile") -> dict:
    """Trace ``run()`` with torch.profiler: wall ms, device busy ms and
    share, device time by kernel and host time by operator (self time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    host: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            by_name[ev.key[:90]] = by_name.get(ev.key[:90], 0.0) + ev.self_device_time_total / 1e3
        elif ev.device_type == torch.autograd.DeviceType.CPU and ev.self_cpu_time_total > 0:
            host[ev.key[:60]] = host.get(ev.key[:60], 0.0) + ev.self_cpu_time_total / 1e3
    busy = sum(by_name.values())
    out = {**what, "wall_ms": wall * 1e3, "device_busy_ms": busy,
           "busy_share": busy / (wall * 1e3),
           "kernels_ms": [{"name": k, "ms": v, "share_of_busy": v / busy}
                          for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]],
           "host_ops_ms": [{"name": k, "ms": v}
                           for k, v in sorted(host.items(), key=lambda kv: -kv[1])[:12]]}
    print(f"[{tag}]", json.dumps(out), flush=True)
    return out


def phase_g(cols: ba.Columns) -> dict:
    """Edge agreement of 3 rebuilt blocks on the card (K2 / K3, the union
    kernel) with the same columns' blocks on the CPU (the plain versions),
    and both folds' sq_frobenius."""
    n, block, nbins = cols.n, HUGE_BLOCK, HUGE_NBINS
    host = ba.Columns(kinds=cols.kinds,
                      tensors=tuple(tuple(x.cpu() for x in t) if isinstance(t, tuple)
                                    else t.cpu() for t in cols.tensors),
                      valids=tuple(v.cpu() for v in cols.valids),
                      idf=None if cols.idf is None else cols.idf.cpu())
    agreements = []
    for start in (0, n // 2, n - block):
        got = ba.fused_rowblock(cols, start, block, K_BASIS, select="binned", nbins=nbins,
                                out_dtype=torch.bool).cpu()
        want = ba.fused_rowblock(host, start, block, K_BASIS, select="binned", nbins=nbins,
                                 out_dtype=torch.bool)
        agree = edge_agreement(got, want)
        print(f"[g] block at row {start}: edges kernel {int(got.sum())} plain "
              f"{int(want.sum())} mismatched {int((got != want).sum())} agreement "
              f"{agree:.6f}", flush=True)
        if agree < EDGE_AGREEMENT:
            raise AssertionError(f"block {start}: agreement {agree} < {EDGE_AGREEMENT}")
        agreements.append(agree)
    ell = min(REDUCED_DIM, n)
    kw = dict(ell=ell, block=block, k_basis=K_BASIS, select="binned", nbins=nbins)
    _, sq_cand, loss_cand = ba.blocked_fd_sketch(cols, cand_fold=True, **kw)
    _, sq_dense, loss_dense = ba.blocked_fd_sketch(cols, cand_fold=False, **kw)
    out = {"agreements": agreements, "sq_frobenius_cand": float(sq_cand),
           "sq_frobenius_dense": float(sq_dense), "shrink_loss_cand": float(loss_cand),
           "shrink_loss_dense": float(loss_dense)}
    print("[g]", json.dumps(out), flush=True)
    if out["sq_frobenius_cand"] != out["sq_frobenius_dense"]:
        raise AssertionError(f"cand fold sq_frobenius != dense fold's: {out}")
    return out


# ---------------------------------------------------------------------------
# slice 2 on dense windows: phase (h)
# ---------------------------------------------------------------------------

SERVE_RECORDS, SERVE_CHUNK = 60_000, 500
SLICE2_RECORDS = 20_000


def serve(det: StreamDetector, rows: list, lo: int, hi: int, chunk: int) -> list:
    """Push rows [lo, hi) in chunks; returns the windows finalized meanwhile."""
    out = []
    for a in range(lo, hi, chunk):
        out.extend(det.push([m[a:min(a + chunk, hi)] for m in rows]))
    return out


BACKGROUND_AGREEMENT = 0.999   # mark_background card vs CPU: sort / cumsum order


def background_agreement(det: StreamDetector, rows: list) -> dict:
    """``mark_background`` on the card against the same function on the CPU,
    on the first window's residuals as the detector's approach forms them
    (the transposed sketch for SWFDMC, the NJW embedding for sSpectral)."""
    eng, cfg = det.engine, det.engine.cfg
    host = eng.featurize([m[:cfg.window_size] for m in rows], det.modality_types)
    fused = eng.fuse_from_features(host, to_device(host, eng.device), det.modality_types)
    gen = streaming.window_generator(cfg.seed, 0, eng.device)
    if cfg.approach == "sSpectral":
        lam, vecs = spectral._normalized_spectrum(fused)
        k = spectral.eigengap_k_from_spectrum(lam, k_max=eng.k_max)
        x = spectral._njw_embedding(vecs, k, eng.k_max)
        labels, _ = kmeans.kmeans(x, k, gen, k_max=eng.k_max)
    else:
        _, x, labels = streaming._window_step_impl(
            streaming.StreamingEngine(cfg).state, fused, eng.k_max, gen,
            approach=cfg.approach, k_basis=cfg.k_basis, reduced_dim=cfg.reduced_dim,
            k_max=eng.k_max, window=cfg.window_size, fd_shrink=cfg.fd_shrink,
            k_source="eigengap", eigengap_theta=cfg.eigengap_theta)
    card = kmeans.mark_background(x, labels, k_max=eng.k_max).cpu()
    cpu = kmeans.mark_background(x.cpu(), labels.cpu(), k_max=eng.k_max)
    out = {"rows": len(card), "flagged_card": int((card == -1).sum()),
           "flagged_cpu": int((cpu == -1).sum()),
           "agreement": float((card == cpu).float().mean())}
    if out["agreement"] < BACKGROUND_AGREEMENT:
        raise AssertionError(f"mark_background on the card disagrees with the CPU: {out}")
    return out


def warm_up(make, rows: list, windows: int = 2) -> None:
    """Serve ``windows`` windows through a throw-away detector, so the timed
    run does not pay the libraries' first calls (cuBLAS / cuSOLVER handles,
    kernel loads)."""
    det = make()
    serve(det, rows, 0, windows * det.cfg.window_size, SERVE_CHUNK)
    det.flush()
    torch.cuda.synchronize()


def detector_run(det: StreamDetector, rows: list, n: int, chunk: int) -> dict:
    """Serve rows [0, n) through ``det`` with K1 / hasher counts read around
    it: results, windows/s, push latency and the largest lag (windows fired
    but not yet returned after a push)."""
    reset_counts()
    hashed = native.calls
    push_ms, results, lag = [], [], 0
    t0 = time.perf_counter()
    for a in range(0, n, chunk):
        t = time.perf_counter()
        results.extend(det.push([m[a:min(a + chunk, n)] for m in rows]))
        push_ms.append((time.perf_counter() - t) * 1e3)
        lag = max(lag, det._window_index - len(results))
    results.extend(det.flush())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"results": results, "windows": len(results), "seconds": secs,
            "windows_per_s": len(results) / secs,
            "push_p50_ms": float(np.percentile(push_ms, 50)),
            "push_p99_ms": float(np.percentile(push_ms, 99)), "max_lag_windows": lag,
            "k1_launches": ak.launches, "native_hasher_calls": native.calls - hashed,
            "huge_launches": huge_counts(), "spans": det.engine.timer.summary()}


def phase_h1(mods, device) -> dict:
    rows = [m[:SERVE_RECORDS] for m in mods]

    def make():
        return StreamDetector(streaming.STANDARD_TYPES, WINDOW, approach="SWFDMC",
                              reduced_dim=REDUCED_DIM, k_basis=K_BASIS,
                              k_estimate="eigengap", background=True)

    warm_up(make, rows)
    det = make()
    if det.engine.device.type != "cuda":
        raise AssertionError(f"StreamDetector defaulted to {det.engine.device}")
    run = detector_run(det, rows, SERVE_RECORDS, SERVE_CHUNK)
    full = run.pop("results")
    n_win = len(full)
    out = {**run, "records": SERVE_RECORDS, "chunk": SERVE_CHUNK,
           "events_per_window": float(np.mean([len(r.event_ids) for r in full])),
           "new_events_per_window": float(np.mean([len(r.new_events) for r in full])),
           "background_rows": int(sum(r.background for r in full)),
           "windows_with_background": int(sum(r.background > 0 for r in full)),
           "mark_background_card_vs_cpu": background_agreement(det, rows)}
    # resume: save after half the records, load into a fresh detector
    half = SERVE_RECORDS // 2
    first = make()
    resumed = serve(first, rows, 0, half, SERVE_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "detector.npz")
        resumed.extend(first.save(path))
        second = StreamDetector.load(path)
    resumed.extend(serve(second, rows, half, SERVE_RECORDS, SERVE_CHUNK))
    resumed.extend(second.flush())
    shares = [float(np.mean(a.clusters == b.clusters)) for a, b in zip(full, resumed)]
    out["resume"] = {"windows": len(resumed), "saved_at_record": half,
                     "identical_windows": sum(s == 1.0 for s in shares),
                     "min_label_share": min(shares) if shares else 0.0,
                     "same_events": all(np.array_equal(a.new_events, b.new_events)
                                        for a, b in zip(full, resumed))}
    print("[h1]", json.dumps(out), flush=True)
    if out["k1_launches"] != 4 * n_win or out["native_hasher_calls"] != 2 * n_win:
        raise AssertionError(f"h1: expected {4 * n_win} K1 launches and {2 * n_win} "
                             f"hasher calls: {out}")
    if n_win != len(streaming.window_triggers(SERVE_RECORDS, WINDOW, 1)):
        raise AssertionError(f"h1: {n_win} windows")
    r = out["resume"]
    # every device op on this path is deterministic on the card (the float
    # scatter-add in counts_from_tokens adds small integers, exactly), so
    # the resumed detector must match label for label
    if not (r["windows"] == n_win and r["identical_windows"] == n_win and r["same_events"]):
        raise AssertionError(f"h1: resumed detector differs: {r}")
    return out


def phase_h2() -> dict:
    mods, mtypes, labels = crisis_embedding_stream(n_rows=SLICE2_RECORDS, n_events=8,
                                                   noise_rate=0.3, seed=SEED)
    out = {"records": SLICE2_RECORDS, "events": 8, "noise_rate": 0.3}
    for bg in (False, True):
        def make(bg=bg):
            return StreamDetector(mtypes, WINDOW, approach="sSpectral",
                                  reduced_dim=REDUCED_DIM, k_basis=K_BASIS,
                                  k_estimate="eigengap", background=bg)

        warm_up(make, mods)
        det = make()
        run = detector_run(det, mods, SLICE2_RECORDS, SERVE_CHUNK)
        res = run.pop("results")
        clus = np.concatenate([r.clusters for r in res])
        truth = labels[:len(clus)]
        out["background_on" if bg else "background_off"] = {
            **{k: run[k] for k in ("windows", "windows_per_s", "push_p50_ms",
                                   "push_p99_ms", "k1_launches", "spans")},
            "nmi": nmi(truth, clus), "background_rows": int((clus == -1).sum()),
            "background_share_of_noise_rows": float((clus[truth == 0] == -1).mean())}
        if bg:
            out["background_on"]["mark_background_card_vs_cpu"] = background_agreement(
                det, mods)
        if run["k1_launches"] != 2 * run["windows"]:
            raise AssertionError(f"h2: {run['k1_launches']} K1 launches for "
                                 f"{run['windows']} windows (expected 2 per window)")
    print("[h2]", json.dumps(out), flush=True)
    if out["background_on"]["background_rows"] <= 0:
        raise AssertionError(f"h2: the background bucket never fired: {out}")
    return out


def phase_h3(mods, mtypes, labels, device) -> list:
    runs = []
    for approach in ("sSpectral", "DBSCAN_incr", "DBSCAN_centr"):
        reset_counts()
        out = phase_c(mods, mtypes, labels, device, approach, SLICE2_RECORDS, tag="h3")
        if approach == "DBSCAN_incr" and out["native_incdbscan_calls"] < 1:
            raise AssertionError(f"DBSCAN_incr did not run the native incdbscan core "
                                 f"({native.incdb_load_error})")
        runs.append(out)
    return runs


def phase_h4(mods, mtypes, labels) -> dict:
    kw = dict(results=None, data_modalities=[m[:SLICE2_RECORDS] for m in mods],
              modality_types=mtypes, window_size=WINDOW, reduced_dim=REDUCED_DIM,
              k_basis=K_BASIS, n_clusters_total=2, seed=SEED, approach="SWFDMC",
              complete_true_labels=labels[:SLICE2_RECORDS], step_window_ratio=1,
              noise_rate=NOISE_RATE, label_mode="binary", sorting=True, eps=1.5,
              min_samples=2, checkpoint_every=4)
    keys = ("nmi_score", "nmi_e_score", "f1_score", "f1_aligned")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        first = api.process_streaming_data(**{**kw, "results": api.get_initial_results()[0]},
                                           checkpoint_dir=tmp)
        secs = time.perf_counter() - t0
        saved = sorted(os.listdir(tmp))
        for name in saved:
            if name != "stream_00000004.npz":
                os.remove(os.path.join(tmp, name))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            second = api.process_streaming_data(
                **{**kw, "results": api.get_initial_results()[0]}, checkpoint_dir=tmp)
    line = next((ln for ln in printed.getvalue().splitlines()
                 if ln.startswith("resumed from")), "")
    out = {"checkpoints": saved, "seconds_first_run": secs, "resume_line": line,
           "first": {k: first[k][0] for k in keys}, "resumed": {k: second[k][0] for k in keys}}
    print("[h4]", json.dumps(out), flush=True)
    if "resumed from" not in line or not line.endswith("at window 4"):
        raise AssertionError(f"h4: no resume line: {line!r}")
    if out["first"] != out["resumed"] or saved != ["stream_00000004.npz",
                                                   "stream_00000008.npz"]:
        raise AssertionError(f"h4: resumed run differs: {out}")
    return out


def phase_h5(hmods) -> dict:
    n = 2 * HUGE_WINDOW
    det = StreamDetector(streaming.STANDARD_TYPES, HUGE_WINDOW, approach="SWFDMC",
                         reduced_dim=REDUCED_DIM, k_basis=K_BASIS, background=True)
    run = detector_run(det, [m[:n] for m in hmods], n, 16_384)
    res = run.pop("results")
    out = {k: run[k] for k in ("windows", "seconds", "windows_per_s", "max_lag_windows",
                               "huge_launches", "k1_launches", "native_hasher_calls")}
    out["max_lag"] = det.max_lag
    out["background_rows"] = int(sum(r.background for r in res))
    print("[h5]", json.dumps(out), flush=True)
    want = {k: v * out["windows"] for k, v in
            with_routes({"K2": 2 * BLOCKS_PER_WINDOW, "K3": BLOCKS_PER_WINDOW,
                         "K4": 2 * BLOCKS_PER_WINDOW, "K5": BLOCKS_PER_WINDOW,
                         "lists": BLOCKS_PER_WINDOW}).items()}
    if out["windows"] != 2 or out["huge_launches"] != want or out["k1_launches"]:
        raise AssertionError(f"h5: launches {out['huge_launches']} (K1 "
                             f"{out['k1_launches']}) for {out['windows']} windows, "
                             f"expected {want} and no K1")
    return out

# ---------------------------------------------------------------------------
# slices 2c + 2d: the batch engine and the blocked clustering family, phase (i)
# ---------------------------------------------------------------------------

# the reference's own batch subset (PipelineConfig.subset_size) pads to
# 74 blocks = 151,552 rows, where default_nbins gives 4096 bins over 37 groups
BATCH_PADDED_ROWS, BATCH_NBINS = 151_552, 4_096
BATCH_DENSE_ROWS, BATCH_SPECTRAL_ROWS = 32_768, 16_384   # i2: the dense path
CHECK_DBSCAN_ROWS, CHECK_HDBSCAN_ROWS = 20_000, 16_384   # i4: blocked against dense
BATCH_APPROACHES = ("SVDMC_batch", "Spectral_batch", "DBSCAN_batch", "HDBSCAN_batch")
K1_ROWS = (8_192, 16_384, 32_768)    # i4: K1 at the dense batch's sizes
K1_CHUNK_BEFORE = 2_048      # rows per chunk at n = 32,768 under the former 256 MB key scratch
MAIN_CASES = ("location", "time", "tags", "text")


def batch_cfg(approach: str, n_rows: int) -> PipelineConfig:
    return PipelineConfig(seed=SEED, subset_size=n_rows, noise_rate=NOISE_RATE,
                          label_mode="binary", sorting=True, window_size=WINDOW,
                          reduced_dim=REDUCED_DIM, k_basis=K_BASIS, approach=approach,
                          n_clusters_override=2)


def batch_run(mods, mtypes, labels, approach: str, n_rows: int, tag: str) -> dict:
    """``api.process_batch_data`` on the stream's first ``n_rows`` records
    (the card by default), with the launch counts read around it: 4 K1 on
    the dense path; on the blocked path 2 K2 and 1 K3 per block per sweep
    (6 sweeps of the blocked SVD, 8 of blocked spectral) and no K1."""
    blocked = n_rows > batch.MAX_DENSE_ROWS
    blocks = -(-n_rows // batch.BLOCK_ROWS)
    sweeps = SPECTRAL_SWEEPS if approach == "Spectral_batch" else SSVD_SWEEPS
    want = with_routes({"K1": 0, "K2": 2 * sweeps * blocks, "K3": sweeps * blocks, "K4": 0,
                        "K5": 0, "lists": 0}
                       if blocked else {"K1": 4, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                                        "lists": 0})
    reset_counts()
    hashed = native.calls
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = api.process_batch_data(
        results=api.get_initial_results()[0], data_modalities=[m[:n_rows] for m in mods],
        modality_types=mtypes, reduced_dim=REDUCED_DIM, k_basis=K_BASIS, n_clusters=2,
        seed=SEED, approach=approach, complete_true_labels=labels[:n_rows],
        noise_rate=NOISE_RATE, label_mode="binary", sorting=True, eps=1.5, min_samples=2,
        min_cluster_size=3, window_size=WINDOW, cfg=batch_cfg(approach, n_rows))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {"K1": ak.launches, **huge_counts()}
    out = {"approach": approach, "rows": n_rows, "path": "blocked" if blocked else "dense",
           "padded_rows": blocks * batch.BLOCK_ROWS if blocked else n_rows,
           "nbins": bs.default_nbins(blocks * batch.BLOCK_ROWS, k_max=3 * K_BASIS)
           if blocked else None, "launches": counts,
           "native_hasher_calls": native.calls - hashed, "seconds": secs,
           "rows_per_s": n_rows / secs, "nmi": res["nmi_score"][0],
           "nmi_e": res["nmi_e_score"][0], "f1": res["f1_score"][0],
           "f1_aligned": res["f1_aligned"][0],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}
    print(f"[{tag}]", json.dumps(out), flush=True)
    if counts != want:
        raise AssertionError(f"{tag} {approach}: launches {counts}, expected {want}")
    if out["native_hasher_calls"] != 2:           # text + tags, featurized once
        raise AssertionError(f"featurization did not run the native hasher: {out}")
    metric_vals = [out[k] for k in ("nmi", "nmi_e", "f1", "f1_aligned")]
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in metric_vals):
        raise AssertionError(f"metrics out of range: {metric_vals}")
    return out


def phase_i1(mods, mtypes, labels) -> list:
    return [batch_run(mods, mtypes, labels, a, N_RECORDS, "i1") for a in BATCH_APPROACHES]


def phase_i2(mods, mtypes, labels) -> list:
    return [batch_run(mods, mtypes, labels, a,
                      BATCH_SPECTRAL_ROWS if a == "Spectral_batch" else BATCH_DENSE_ROWS, "i2")
            for a in BATCH_APPROACHES]


# K1 and i2 in an earlier tree, run from its root: that tree's chip_smoke, modules and
# kernels; argv[1] lists the n of K1's four main-path calls (none: i2 alone)
EARLIER = """
import hashlib, json, sys
import torch
import chip_smoke as cs
cs.streaming.configure_precision()
device = torch.device("cuda")
mods, mtypes, labels = cs.make_stream(cs.N_RECORDS, noise_rate=cs.NOISE_RATE, binary=True,
                                      sort_by_uploaded=True, seed=cs.SEED)
cs.build.load()
engine = cs.streaming.StreamingEngine(cs.batch_cfg("SVDMC_batch", cs.BATCH_DENSE_ROWS), device)
k1 = {}
for n in json.loads(sys.argv[1]):
    k1[n] = {}
    for name, metric, x, valid, k, _ in cs.main_cases(mods, engine, device, n):
        got = cs.ak.knn_adjacency(x, valid, k, metric)
        k1[n][name] = {
            "edges_sha256": hashlib.sha256(got.nonzero().cpu().numpy().tobytes()).hexdigest(),
            "ms": cs.cuda_ms(lambda: cs.ak.knn_adjacency(x, valid, k, metric), reps=3)}
        del got
    torch.cuda.empty_cache()
print("[earlier]", json.dumps({"k1": k1, "i2": cs.phase_i2(mods, mtypes, labels)}), flush=True)
"""


def earlier_tree(tree: str, k1_rows: tuple = ()) -> dict:
    """K1's four main-path calls at ``k1_rows`` (ms, digest of the edges)
    and phase i2, run by the tree unpacked at ``tree`` (its own kernels,
    built there) in a subprocess on this card."""
    torch.cuda.empty_cache()
    tree = os.path.abspath(tree)
    env = {**os.environ, "PYTHONPATH": tree}
    proc = subprocess.run([sys.executable, "-c", EARLIER, json.dumps(list(k1_rows))], cwd=tree,
                          env=env, capture_output=True, text=True, timeout=900)
    rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("[earlier] ")]
    if proc.returncode != 0 or not rows:
        raise AssertionError(f"the tree at {tree} failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(rows[-1][len("[earlier] "):])


def phase_i2_against(mods, mtypes, labels, tree: str) -> dict:
    """i2's dense batch seconds per approach with this tree's K1 and the
    earlier tree's, in turns (earlier, this, this, earlier); the first
    earlier run also times K1 at window 2000 and ``K1_ROWS``."""
    first = earlier_tree(tree, (WINDOW, *K1_ROWS))
    runs = {"earlier": [first["i2"]],
            "this": [phase_i2(mods, mtypes, labels) for _ in range(2)]}
    runs["earlier"].append(earlier_tree(tree)["i2"])
    out = {"earlier_tree": tree, "k1": first["k1"], "i2_seconds": {
        a: {who: [r[i]["seconds"] for r in rr] for who, rr in runs.items()}
        for i, a in enumerate(BATCH_APPROACHES)}}
    print("[i2] earlier tree against this one", json.dumps(out["i2_seconds"]), flush=True)
    return out


def k1_against(rows_by_n: dict, earlier: dict) -> dict:
    """This tree's K1 main-path calls against the earlier tree's on the same
    inputs: ms each and the same edges (digests equal), or the run fails."""
    out = {}
    for n, rows in rows_by_n.items():
        for r in rows:
            old = earlier.get(str(n), {}).get(r["case"])
            if old is not None:
                out.setdefault(n, {})[r["case"]] = {
                    "earlier_ms": old["ms"], "ms": r["ms"],
                    "same_edges": old["edges_sha256"] == r["edges_sha256"]}
    print("[i4] K1 against the earlier tree", json.dumps(out), flush=True)
    differ = [(n, c) for n, by_case in out.items() for c, v in by_case.items()
              if not v["same_edges"]]
    if differ:
        raise AssertionError(f"K1's edges differ from the earlier tree's at {differ}")
    return out


def exact_grid(x: torch.Tensor) -> tuple[torch.Tensor, float]:
    """``x`` rounded to a power-of-two grid fine enough to keep its shape and
    coarse enough that every squared distance of the expanded-norm form
    (norms and dot products included) is exact in float32, so the blocked
    and the dense paths, whatever their product shapes and summation orders,
    decide every eps test and every MST weight alike.  Returns (grid points,
    grid step)."""
    m2 = float(torch.max(torch.sum(x * x, dim=1)))
    scale = float(2.0 ** np.floor(0.5 * np.log2(2.0 ** 21 / max(m2, 1e-30))))
    return torch.round(x * scale) / scale, 1.0 / scale


def exact_cases(n: int, device) -> list[tuple]:
    """Euclidean and dot on (n, 64) integers in [-3, 3]: every product and
    sum exact in float32, so kernel and plain version see the same keys, with
    many ties at the k-th."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    xi = torch.randint(-3, 4, (n, 64), generator=gen, device=device).float()
    ones = torch.ones(n, dtype=torch.bool, device=device)
    return [("exact_euclidean", "euclidean", xi, ones, K_BASIS - 1, {}),
            ("exact_dot", "dot", xi, ones, K_BASIS, {})]


def k1_chunk_check(case: tuple, tag: str = "i4") -> dict:
    """One K1 case in ``K1_CHUNK_BEFORE``-row chunks (every tile computed)
    against one chunk of all rows (upper triangle, mirrored): bit-equal,
    with both times."""
    name, metric, x, valid, k, _ = case
    whole = ak.knn_adjacency(x, valid, k, metric)
    chunked = ak.knn_adjacency(x, valid, k, metric, chunk_rows=K1_CHUNK_BEFORE)
    out = {"case": f"{name}_{K1_CHUNK_BEFORE}_row_chunks", "n": x.shape[0],
           "chunk_rows": K1_CHUNK_BEFORE, "equal_to_one_chunk": bool(torch.equal(whole, chunked)),
           "ms": cuda_ms(lambda: ak.knn_adjacency(x, valid, k, metric,
                                                  chunk_rows=K1_CHUNK_BEFORE), reps=3),
           "one_chunk_ms": cuda_ms(lambda: ak.knn_adjacency(x, valid, k, metric), reps=3)}
    print(f"[{tag}]", json.dumps(out), flush=True)
    if not out["equal_to_one_chunk"]:
        raise AssertionError(f"row chunks differ from one chunk: {out}")
    return out


K1_PROFILE_CALLS = 20    # calls per trace: traces of a few calls held no device events


def profile_k1(mods, device) -> list:
    """Device time by kernel per call of K1's four calls at the dense
    batch's n, and of text in ``K1_CHUNK_BEFORE``-row chunks (``--profile``)."""
    engine = streaming.StreamingEngine(batch_cfg("SVDMC_batch", BATCH_DENSE_ROWS), device)
    cases = main_cases(mods, engine, device, BATCH_DENSE_ROWS)
    text = cases[MAIN_CASES.index("text")]
    cases.append((f"text_{K1_CHUNK_BEFORE}_row_chunks", *text[1:5],
                  {"chunk_rows": K1_CHUNK_BEFORE}))
    out = []
    for name, metric, x, valid, k, opts in cases:
        def run(calls: int = K1_PROFILE_CALLS):
            for _ in range(calls):
                ak.knn_adjacency(x, valid, k, metric, **opts)
            torch.cuda.synchronize()
        run(1)
        row = traced(run, {"k1_case": name, "n": x.shape[0], "calls": K1_PROFILE_CALLS})
        per_call = {r["name"]: r["ms"] / K1_PROFILE_CALLS for r in row["kernels_ms"]}
        print("[profile] K1 per call", json.dumps({"k1_case": name, "kernels_ms": per_call}),
              flush=True)
        out.append(row)
    return out


def phase_i4(mods, mtypes, device, parent: str | None = None) -> dict:
    """K2 / K3 at the batch subset's shapes (K2 on the postings route, the
    dense route and, with ``parent``, the earlier tree's K2 on the same
    block), K1 at the dense batch's, and the blocked DBSCAN / HDBSCAN against
    their dense counterparts."""
    out = {}
    cfg = batch_cfg("SVDMC_batch", N_RECORDS)
    cols, block = batch._blocked_columns([m[:N_RECORDS] for m in mods], mtypes, cfg, device)
    n, nbins = cols.n, bs.default_nbins(cols.n, k_max=3 * K_BASIS)
    if (n, nbins) != (BATCH_PADDED_ROWS, BATCH_NBINS):
        raise AssertionError(f"batch columns: n={n}, nbins={nbins}")
    start = n - block                     # the last block: 1,552 padding rows
    by_kind = dict(zip(cols.kinds, zip(cols.tensors, cols.valids)))
    by_post = dict(zip(cols.kinds, cols.postings_of()))
    (xyz, lv), (tim, tv) = by_kind["location_xyz"], by_kind["time"]
    ((tags, sums), tagv), (text, textv) = by_kind["tags"], by_kind["text_bf16"]
    blocks = n // block
    per = {"SVDMC_batch": SSVD_SWEEPS * blocks, "Spectral_batch": SPECTRAL_SWEEPS * blocks}
    earlier = []
    if parent:
        saved = save_k2(tags, tagv, sums, text, textv, start, block, nbins)
        earlier.append(earlier_k2(parent, saved))
    out["K2"] = {name: k2_check(name, metric, x, valid, row_sums, K_BASIS, start=start,
                                block=block, nbins=nbins, per_window=per, tag="i4",
                                postings=post)
                 for name, metric, x, valid, row_sums, post in [
                     ("tags", "jaccard", tags, tagv, sums, by_post["tags"]),
                     ("text", "dot", text, textv, None, by_post["text_bf16"])]}
    out["K2_dense"] = {name: k2_check(name, metric, x, valid, row_sums, K_BASIS, start=start,
                                      block=block, nbins=nbins, per_window={}, tag="i4")
                       for name, metric, x, valid, row_sums in [
                           ("tags_dense", "jaccard", tags, tagv, sums),
                           ("text_dense", "dot", text, textv, None)]}
    out["K2_per_block"] = {
        "postings": sum_rows(list(out["K2"].values()), "tags + text, postings route"),
        "dense": sum_rows(list(out["K2_dense"].values()), "tags + text, tensor-core route")}
    if parent:
        earlier.append(earlier_k2(parent, saved))
        shutil.rmtree(os.path.dirname(saved))
        rows = slice(start, start + block)
        dense_out = {"tags": bs.binned_candidates(tags, tags[rows], tagv, start,
                                                  metric="jaccard", nbins=nbins, block=block,
                                                  row_sums=sums),
                     "text": bs.binned_candidates(text, text[rows], textv, start,
                                                  metric="dot", nbins=nbins, block=block)}
        out["K2_per_block"]["earlier_tree"] = k2_against_earlier(
            earlier, {"tags": out["K2_dense"]["tags_dense"],
                      "text": out["K2_dense"]["text_dense"]}, out["K2"], dense_out)
    print("[i4] K2 per block", json.dumps(out["K2_per_block"]), flush=True)
    out["K3_tags_text"] = tags_text_pair(
        tags, tagv, sums, text, textv, by_post["tags"], by_post["text_bf16"], start=start,
        block=block, nbins=nbins,
        earlier=out["K2_per_block"].get("earlier_tree", {}).get("earlier_ms"))
    out["K3"] = k3_check(xyz, lv, tim, tv, start=start, block=block, nbins=nbins,
                         per_window=per, tag="i4")
    out["union"] = union_check(cols, start=start, block=block, nbins=nbins, tag="i4")
    del cols, xyz, tim, tags, sums, text, by_kind, by_post
    torch.cuda.empty_cache()

    engine = streaming.StreamingEngine(batch_cfg("SVDMC_batch", BATCH_DENSE_ROWS), device)
    out["K1_by_rows"] = {}
    for n in K1_ROWS:
        cases = main_cases(mods, engine, device, n) + exact_cases(n, device)
        out["K1_by_rows"][n] = phase_b(cases, tag="i4", reps=3, plain_reps=1)
        if n == BATCH_DENSE_ROWS:
            out["K1_chunks"] = k1_chunk_check(cases[MAIN_CASES.index("text")])
        del cases
        torch.cuda.empty_cache()
    out["K1"] = [r for r in out["K1_by_rows"][BATCH_DENSE_ROWS] if r["case"] in MAIN_CASES]

    n_rows = CHECK_DBSCAN_ROWS
    reduced = batch._blocked_reduce([m[:n_rows] for m in mods], mtypes,
                                    batch_cfg("DBSCAN_batch", n_rows),
                                    batch.batch_generator(SEED, device), device)
    x, step = exact_grid(reduced)
    t0 = time.perf_counter()
    got = blocked_dbscan.dbscan_blocked(x, eps=1.5, min_samples=2)
    t1 = time.perf_counter()
    want = dbscan.dbscan(x, eps=1.5, min_samples=2)
    t2 = time.perf_counter()
    out["dbscan"] = {"rows": n_rows, "eps": 1.5, "min_samples": 2, "grid_step": step,
                     "clusters": int(want.max()) + 1, "noise_rows": int((want == -1).sum()),
                     "equal": bool(np.array_equal(got, want)), "blocked_seconds": t1 - t0,
                     "dense_seconds": t2 - t1}
    print("[i4] dbscan", json.dumps(out["dbscan"]), flush=True)
    if not out["dbscan"]["equal"]:
        raise AssertionError(f"dbscan_blocked differs from the dense dbscan: {out['dbscan']}")

    out["hdbscan"] = hdbscan_check(x[:CHECK_HDBSCAN_ROWS], device)
    return out


def tags_text_pair(tags, tagv, sums, text, textv, ptags, ptext, *, start: int, block: int,
                   nbins: int, earlier: dict | None = None, tag: str = "i4") -> dict:
    """K3 on tags jaccard + text dot at this shape on the postings route:
    bit-equal to two K2 launches on it; its ms beside theirs, the
    tensor-core pair's and (``earlier``) the earlier tree's, its bound on
    the nonzero rule and the dense one."""
    rows = slice(start, start + block)
    kw = dict(nbins=nbins, block=block)

    def pair(postings=True):
        return bs.binned_candidates_pair(tags, text, tags[rows], text[rows], tagv, textv,
                                         start, metricA="jaccard", metricB="dot",
                                         row_sumsA=sums, postingsA=ptags if postings else None,
                                         postingsB=ptext if postings else None, **kw)

    def two_k2():
        return (*bs.binned_candidates(tags, tags[rows], tagv, start, metric="jaccard",
                                      row_sums=sums, postings=ptags, **kw),
                *bs.binned_candidates(text, text[rows], textv, start, metric="dot",
                                      postings=ptext, **kw))

    got, singles = pair(), two_k2()
    torch.cuda.synchronize()
    n = tags.shape[0]
    row = {"case": "tags+text", "route": "postings", "n": n, "nbins": nbins, "start": start,
           "bit_equal_to_two_k2": all(torch.equal(a, b) for a, b in zip(got, singles)),
           "ms": cuda_ms(pair, reps=5, warmup=1), "two_k2_ms": cuda_ms(two_k2, reps=5, warmup=1),
           "tensor_core_pair_ms": cuda_ms(lambda: pair(False), reps=5, warmup=1),
           "earlier_tree_ms": earlier and earlier["tags+text"],
           "bound_ms": (k2_postings_bound("jaccard", ptags, tags[rows], nbins)["bound_ms"]
                        + k2_postings_bound("dot", ptext, text[rows], nbins)["bound_ms"]),
           "bound_dense_ms": (
               k2_bound("jaccard", n, block, nbins, tags.shape[1], 1)["bound_ms"]
               + k2_bound("dot", n, block, nbins, text.shape[1], 2)["bound_ms"])}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    print(f"[{tag}] K3", json.dumps(row), flush=True)
    if not row["bit_equal_to_two_k2"]:
        raise AssertionError(f"{tag}: K3 tags + text differs from two K2 launches: {row}")
    return row


def same_partition(a, b) -> bool:
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


def hdbscan_check(xh: torch.Tensor, device) -> dict:
    """The card's Borůvka HDBSCAN against host Prim at ``len(xh)`` rows:
      * on ``xh`` (grid points of the reduced embedding: every squared
        weight exact): the same MST weights, sorted (every MST of a graph has
        them), within one float32 ulp (torch's and numpy's square roots may
        round apart), and the
        labels' agreement, which ties may move: a point whose mutual-
        reachability edges to two clusters weigh the same joins whichever
        its MST holds, and Prim and Borůvka break such ties differently;
      * on as many rows of 16 separated Gaussian blobs (no weight ties
        across blobs): the same partition, labels included."""
    n = xh.shape[0]
    t0 = time.perf_counter()
    mst_card = blocked_hdbscan._mst_boruvka(xh, 2, batch.BLOCK_ROWS)
    t1 = time.perf_counter()
    mst_host = dbscan._prim_mst_mreach(xh.cpu().numpy(), 2)
    t2 = time.perf_counter()
    got = blocked_hdbscan.hdbscan_blocked(xh, min_cluster_size=3, min_samples=2)
    want = dbscan.hdbscan(xh.cpu().numpy(), min_cluster_size=3, min_samples=2, device="cpu")
    rng = np.random.default_rng(SEED)
    centers = rng.normal(size=(16, REDUCED_DIM)) * 8
    blobs = (centers[np.arange(n) % 16] + rng.normal(size=(n, REDUCED_DIM)) * 0.1
             ).astype(np.float32)
    t3 = time.perf_counter()
    got_b = blocked_hdbscan.hdbscan_blocked(torch.from_numpy(blobs).to(device),
                                            min_cluster_size=3, min_samples=2)
    t4 = time.perf_counter()
    want_b = dbscan.hdbscan(blobs, min_cluster_size=3, min_samples=2, device="cpu")
    t5 = time.perf_counter()
    out = {"rows": n, "min_cluster_size": 3, "min_samples": 2,
           "mst_edges": len(mst_card),
           "same_mst_weights": bool(np.allclose(sorted(w for w, _, _ in mst_card),
                                                sorted(w for w, _, _ in mst_host),
                                                rtol=2.0 ** -23, atol=0.0)),
           "mst_weight_sum": float(sum(w for w, _, _ in mst_card)),
           "clusters_card": int(got.max()) + 1, "clusters_host": int(want.max()) + 1,
           "noise_rows_card": int((got == -1).sum()), "noise_rows_host": int((want == -1).sum()),
           "same_partition": same_partition(got, want),
           "rows_in_equal_clusters": rows_in_equal_clusters(got, want),
           "boruvka_mst_card_seconds": t1 - t0, "prim_mst_host_seconds": t2 - t1,
           "blobs": {"clusters": int(want_b.max()) + 1,
                     "same_partition": same_partition(got_b, want_b),
                     "labels_equal": bool(np.array_equal(got_b, want_b)),
                     "boruvka_card_seconds": t4 - t3, "prim_host_seconds": t5 - t4}}
    print("[i4] hdbscan", json.dumps(out), flush=True)
    if not (out["same_mst_weights"] and out["blobs"]["same_partition"]
            and out["blobs"]["clusters"] == 16):
        raise AssertionError(f"hdbscan_blocked disagrees with host Prim: {out}")
    return out


def rows_in_equal_clusters(a, b) -> float:
    """Share of rows whose cluster (noise counted as one) holds the same rows
    in both labellings."""
    a, b = np.asarray(a), np.asarray(b)
    pairs, inv = np.unique(np.stack([a, b], 1), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    size_pair = np.bincount(inv)[inv]
    size_a = np.unique(a, return_counts=True)
    size_b = np.unique(b, return_counts=True)
    na = size_a[1][np.searchsorted(size_a[0], a)]
    nb = size_b[1][np.searchsorted(size_b[0], b)]
    return float(np.mean((size_pair == na) & (size_pair == nb)))


# ---------------------------------------------------------------------------
# slice 4a: the column-sharded layouts' kernels and entry points, phase (j)
# ---------------------------------------------------------------------------

J_SHARDS = (2, 4)            # the emulated column splits of j2


def huge_operands(cols: ba.Columns, device) -> dict:
    """name -> (metric, panel, valid, row_sums, k) of the huge window's kNN
    modalities, and a 128-wide random generic panel for chord."""
    by_kind = dict(zip(cols.kinds, zip(cols.tensors, cols.valids)))
    (xyz, lv), (tim, tv) = by_kind["location_xyz"], by_kind["time"]
    ((tags, sums), tagv), (text, textv) = by_kind["tags"], by_kind["text_bf16"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    generic = ba.generic_columns([torch.randn((cols.n, 128), generator=gen, device=device)],
                                 ("default",), device)
    (dft, sq), dv = generic.tensors[0], generic.valids[0]
    return {"location": ("chord3", xyz, lv, None, K_BASIS),
            "time": ("l1", tim, tv, None, 3 * K_BASIS),
            "tags": ("jaccard", tags, tagv, sums, K_BASIS),
            "text": ("dot", text, textv, None, K_BASIS),
            "generic_default": ("chord", dft, dv, sq, K_BASIS - 1)}


def phase_j1(ops: dict, posts: dict, per_window: dict, earlier: dict | None = None) -> dict:
    """K3 on tags jaccard + text dot (the column-sharded sweep's pair) on the
    first block, on the postings route: bit-equal to two K2 launches on it,
    held to (e)'s rules against the plain version; its ms beside the two K2
    launches', the tensor-core pair's on the same block and (``earlier``,
    from phase e) the earlier tree's K3; bound on the nonzero rule, the
    dense count beside."""
    block, nbins, start = HUGE_BLOCK, HUGE_NBINS, 0
    _, tags, tagv, sums, _ = ops["tags"]
    _, text, textv, _, _ = ops["text"]
    ptags, ptext = posts["tags"], posts["text"]
    n = tags.shape[0]
    rows = slice(start, start + block)
    kw = dict(nbins=nbins, block=block)

    def pair(postings=True):
        return bs.binned_candidates_pair(tags, text, tags[rows], text[rows], tagv, textv,
                                         start, metricA="jaccard", metricB="dot",
                                         row_sumsA=sums, postingsA=ptags if postings else None,
                                         postingsB=ptext if postings else None, **kw)

    def two(fn, **pk):
        return (*fn(tags, tags[rows], tagv, start, metric="jaccard", row_sums=sums,
                    **pk.get("a", {}), **kw),
                *fn(text, text[rows], textv, start, metric="dot", **pk.get("b", {}), **kw))

    def two_k2():
        return two(bs.binned_candidates, a={"postings": ptags}, b={"postings": ptext})

    before = (bs.pair_launches, bs.postings_pair_launches)
    got, singles, plain = pair(), two_k2(), two(bs.binned_candidates_plain)
    torch.cuda.synchronize()
    rules = [plain_rules("jaccard", got[:2], plain[:2], tagv[rows], K_BASIS),
             plain_rules("dot", got[2:], plain[2:], textv[rows], K_BASIS)]
    bounds = [k2_postings_bound("jaccard", ptags, tags[rows], nbins),
              k2_postings_bound("dot", ptext, text[rows], nbins)]
    dense = [k2_bound("jaccard", n, block, nbins, tags.shape[1], tags.element_size()),
             k2_bound("dot", n, block, nbins, text.shape[1], text.element_size())]
    t_ops = sum(b["ops"] / b["peak_ops_per_s"] * 1e3 for b in bounds)
    t_bytes = sum(b["bytes"] / b["bytes_per_s"] * 1e3 for b in bounds)
    row = {"case": "tags+text", "route": bs.pair_route("jaccard", "dot", postings=True),
           "n": n, "block": block, "nbins": nbins,
           "launched": bs.pair_launches - before[0],
           "launched_postings": bs.postings_pair_launches - before[1],
           "bit_equal_to_two_k2": all(torch.equal(a, b) for a, b in zip(got, singles)),
           "plain_rules": rules,
           "max_abs_err": max(r["max_abs_err"] for r in rules),
           "ms": cuda_ms(pair, reps=5, warmup=1),
           "two_k2_ms": cuda_ms(two_k2, reps=5, warmup=1),
           "tensor_core_pair_ms": cuda_ms(lambda: pair(False), reps=5, warmup=1),
           "plain_ms": cuda_ms(lambda: two(bs.binned_candidates_plain), reps=3, warmup=1),
           "bound_ms": sum(b["bound_ms"] for b in bounds),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound": "the sum of the two K2 postings bounds (k2_postings_bound)",
           "bound_dense_ms": sum(b["bound_ms"] for b in dense),
           "entries_met": [b["entries_met"] for b in bounds],
           "library_ms": None, "launches_per_window": per_window}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["share_of_dense_bound"] = row["bound_dense_ms"] / row["ms"]
    if earlier:
        row["earlier_tree_ms"] = earlier["earlier_ms"]["tags+text"]
    # the tensor-core pair with both halves of one metric, against two K2s
    row["same_metric_pairs"] = {}
    for m, x, v, sums_ in (("dot", text, textv, None), ("jaccard", tags, tagv, sums)):
        def same_pair(m=m, x=x, v=v, sums_=sums_):
            return bs.binned_candidates_pair(x, x, x[rows], x[rows], v, v, start, metricA=m,
                                             metricB=m, row_sumsA=sums_, row_sumsB=sums_, **kw)

        def same_two(m=m, x=x, v=v, sums_=sums_):
            one = bs.binned_candidates(x, x[rows], v, start, metric=m, row_sums=sums_, **kw)
            return (*one, *bs.binned_candidates(x, x[rows], v, start, metric=m,
                                                row_sums=sums_, **kw))

        equal = all(torch.equal(a, b) for a, b in zip(same_pair(), same_two()))
        row["same_metric_pairs"][f"{m}+{m}"] = {
            "bit_equal_to_two_k2": equal, "ms": cuda_ms(same_pair, reps=5, warmup=1),
            "two_k2_ms": cuda_ms(same_two, reps=5, warmup=1)}
    print("[j1] K3", json.dumps(row), flush=True)
    if not (row["bit_equal_to_two_k2"] and all(r["ok"] for r in rules)
            and row["launched"] == row["launched_postings"] == 1
            and all(p["bit_equal_to_two_k2"] for p in row["same_metric_pairs"].values())):
        raise AssertionError(f"j1: K3 jaccard + dot disagrees: {row}")
    return row


def shard_cases(n: int) -> list:
    """(p, shard q, first row of the block) of j2: a row block from another
    shard, before this shard's columns (start local < 0) and past them."""
    out = []
    for p in J_SHARDS:
        n_local = n // p
        out += [(p, 1, 0), (p, 0, n - HUGE_BLOCK)]
        assert n_local % HUGE_NBINS == 0
    return out


def phase_j2(ops: dict, uid: torch.Tensor, uid_valid: torch.Tensor, device,
             token_ids: dict) -> list:
    """K2 on every metric, K3 on both standard pairs and K4 / K5 with the
    shard's offset g0, on a column shard of the huge window and a row block
    of another shard (shard-local start, row_stats pre-sliced), against the
    plain versions; tags and text on the postings route, with the shard's
    own postings (built from its rows' token ids, as the column-sharded
    sweep builds them)."""
    block, nbins = HUGE_BLOCK, HUGE_NBINS
    n = uid.shape[0]
    results = []
    for p, q, r0 in shard_cases(n):
        n_local = n // p
        cs_, rows = slice(q * n_local, (q + 1) * n_local), slice(r0, r0 + block)
        start = r0 - q * n_local
        case = {"p": p, "shard": q, "rows_from": r0, "start_local": start, "checks": []}

        def shard(name):
            metric, x, valid, sums, k = ops[name]
            return (metric, x[cs_], x[rows], valid[cs_], valid[rows],
                    None if sums is None else sums[cs_],
                    None if sums is None else sums[rows].contiguous(), k)

        posts = {name: bs.build_postings(ops[name][1][cs_], ids[cs_])
                 for name, ids in token_ids.items()}
        cands = {}
        for name in ops:
            metric, cx, rx, cv, rv, sc, sr, k = shard(name)
            kw = dict(metric=metric, nbins=nbins, block=block, row_sums=sc, row_stats=sr)
            before = bs.launches
            got = bs.binned_candidates(cx, rx, cv, start, postings=posts.get(name), **kw)
            want = bs.binned_candidates_plain(cx, rx, cv, start, **kw)
            torch.cuda.synchronize()
            chk = {"kernel": "K2", "case": name, "route": bs.route(metric, posts.get(name)),
                   "launched": bs.launches - before,
                   **plain_rules(metric, got, want, rv, k)}
            case["checks"].append(chk)
            cands[name] = (got, rv, k)
        for a, b in (("location", "time"), ("tags", "text")):
            ma, ca, ra, cva, rva, sca, sra, ka = shard(a)
            mb, cb, rb, cvb, rvb, scb, srb, kb = shard(b)
            before = bs.pair_launches
            got = bs.binned_candidates_pair(ca, cb, ra, rb, cva, cvb, start, metricA=ma,
                                            metricB=mb, nbins=nbins, block=block,
                                            row_sumsA=sca, row_statsA=sra, row_sumsB=scb,
                                            row_statsB=srb, postingsA=posts.get(a),
                                            postingsB=posts.get(b))
            torch.cuda.synchronize()
            for half, (m, rv, k, single) in enumerate(((ma, rva, ka, cands[a][0]),
                                                       (mb, rvb, kb, cands[b][0]))):
                pair_out = got[2 * half:2 * half + 2]
                want = bs.binned_candidates_plain(*(shard(a if half == 0 else b)[1:4]),
                                                  start, metric=m, nbins=nbins, block=block,
                                                  row_sums=(sca, scb)[half],
                                                  row_stats=(sra, srb)[half])
                chk = {"kernel": "K3", "case": f"{a}+{b}", "half": half,
                       "route": bs.pair_route(ma, mb, postings=a in posts),
                       "launched": bs.pair_launches - before,
                       "equal_to_k2": all(torch.equal(x, y) for x, y in zip(pair_out, single)),
                       **plain_rules(m, pair_out, want, rv, k)}
                chk["ok"] = chk["ok"] and chk["equal_to_k2"]
                case["checks"].append(chk)
        # K4 / K5 on this shard's candidate block: local group ids, g0 != 0
        # where the shard is not the first
        groups_local = n_local // nbins
        slabs = torch.stack([cm.pack_slab(bs.budgeted_keep(v[0], rv, k), v[1])
                             for v, rv, k in (cands[name] for name in
                                              ("location", "time", "tags", "text"))])
        uid_rows = torch.where(uid_valid[rows], uid[rows], -1).to(torch.int32).reshape(-1, 1)
        uid_cols = torch.where(uid_valid[cs_], uid[cs_], -2).to(torch.int32).reshape(
            groups_local, nbins)
        cand = cm.CandBlock(slabs.contiguous(), uid_rows.contiguous(), uid_cols.contiguous(),
                            r0, q * groups_local)
        ints = torch.Generator(device=device).manual_seed(SEED + 2)
        for name, fn, ref, shape in (("K4", cm.matvec_t, cm.matvec_t_reference, (66, block)),
                                     ("K5", cm.matvec, cm.matvec_reference, (n_local, 66))):
            xi = torch.randint(-4, 5, shape, generator=ints, device=device).to(torch.bfloat16)
            g, w = fn(cand, xi), ref(cand, xi)
            torch.cuda.synchronize()
            if name == "K4":
                (g, ge), (w, we) = g, w
            chk = {"kernel": name, "g0": cand.g0, "exact_on_integers": bool(torch.equal(g, w))}
            if name == "K4":
                chk["edges_exact"] = float(ge) == float(we)
            chk["ok"] = chk["exact_on_integers"] and chk.get("edges_exact", True)
            case["checks"].append(chk)
        print("[j2]", json.dumps(case), flush=True)
        bad = [c for c in case["checks"] if not c["ok"] or c.get("launched", 1) != 1]
        if bad:
            raise AssertionError(f"j2: p={p} shard {q}: kernels disagree with their plain "
                                 f"versions: {bad}")
        results.append(case)
    return results


@contextlib.contextmanager
def nccl_world_of_one():
    """A torch.distributed process group of one NCCL rank on this card (the
    column-sharded entry points at world size 1), and its (1, 1) mesh."""
    import socket

    import torch.distributed as dist
    from mused_tpu_torch.parallel import mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield mesh.make_mesh(1, 1, "cuda")
    finally:
        dist.destroy_process_group()


def phase_j3(hmods, cols: ba.Columns, device, single_seconds: dict) -> dict:
    """The column-sharded entry points at world size 1 on the huge stream's
    first window at full width: fused rows bit-equal to the single-device
    binned route on 3 blocks; the FD fold (candidate fold) with exactly
    96 K3, 0 K2, 96 K4, 48 K5 and the single-device fold's sq_frobenius;
    the blocked SVD (576 K3) and spectral embedding (768 K3); seconds of
    each beside the single-device path's per window."""
    engine = streaming.StreamingEngine(huge_cfg(), device)
    host = engine.featurize([m[:HUGE_WINDOW] for m in hmods], streaming.STANDARD_TYPES)
    feats, types = tuple(host), streaming.types_for(host, streaming.STANDARD_TYPES)
    n, block, nbins = HUGE_WINDOW, HUGE_BLOCK, HUGE_NBINS
    out = {"n": n, "block": block, "nbins": nbins, "world_size": 1}
    with nccl_world_of_one() as mesh:
        kw = dict(block=block, k_basis=K_BASIS, mesh=mesh, nbins=nbins)
        if cs.default_nbins_colsharded(n, 1, k_max=3 * K_BASIS) != nbins:
            raise AssertionError("j3: the column-sharded bins differ from the single path's")
        rows_equal = []
        for start in (0, n // 2, n - block):
            got = cs.colsharded_fused_rows(feats, types, start=start, **kw)
            want = ba.fused_rowblock(cols, start, block, K_BASIS, select="binned",
                                     nbins=nbins, out_dtype=torch.bool)
            rows_equal.append(bool(torch.equal(got, want)))
        out["fused_rows_bit_equal"] = rows_equal
        ell = min(REDUCED_DIM, n)
        _, sq1, _ = ba.blocked_fd_sketch(cols, ell=ell, block=block, k_basis=K_BASIS,
                                         select="binned", nbins=nbins, cand_fold=True)
        runs = {}
        gen = streaming.window_generator(SEED, 0, device)
        for name, fn in (
                ("fd", lambda: cs.colsharded_blocked_fd_sketch(feats, types, ell=ell, **kw)),
                ("svd", lambda: cs.colsharded_blocked_svd_reduce(feats, types, gen,
                                                                 rank=REDUCED_DIM, **kw)),
                ("spectral", lambda: cs.colsharded_spectral_embedding(
                    feats, types, gen, k_max=2, **kw))):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            runs[name] = {"seconds": time.perf_counter() - t0, "launches": huge_counts(),
                          "finite": bool(all(torch.isfinite(r).all() for r in
                                             (res if isinstance(res, tuple) else (res,))))}
            if name == "fd":
                runs[name]["sq_frobenius"] = float(res[1])
                runs[name]["sq_frobenius_single_device"] = float(sq1)
    out["runs"] = runs
    out["single_device_seconds_per_window"] = single_seconds
    print("[j3]", json.dumps(out), flush=True)
    blocks = n // block
    want = {"fd": with_routes({"K2": 0, "K3": 2 * blocks, "K4": 2 * blocks, "K5": blocks,
                               "lists": blocks}, blocks),
            "svd": with_routes({"K2": 0, "K3": 2 * SSVD_SWEEPS * blocks, "K4": 0, "K5": 0,
                                "lists": 0}, SSVD_SWEEPS * blocks),
            "spectral": with_routes({"K2": 0, "K3": 2 * SPECTRAL_SWEEPS * blocks, "K4": 0,
                                     "K5": 0, "lists": 0}, SPECTRAL_SWEEPS * blocks)}
    if not all(rows_equal):
        raise AssertionError(f"j3: column-sharded fused rows differ: {rows_equal}")
    for name, w in want.items():
        if runs[name]["launches"] != w or not runs[name]["finite"]:
            raise AssertionError(f"j3 {name}: {runs[name]}, expected launches {w}")
    if runs["fd"]["sq_frobenius"] != runs["fd"]["sq_frobenius_single_device"]:
        raise AssertionError(f"j3: sq_frobenius differs from the single-device fold: {runs}")
    return out


# ---------------------------------------------------------------------------
# slices 2f + 2g: the driver surface, row-granular SWFD, the NS fold and
# centroid matching, phase (k)
# ---------------------------------------------------------------------------

SWEEP_ARGS = ["--dataset", "synthetic", "--experiments", "sorting",
              "--approaches", "SWFDMC", "sSVDMC", "--second-pass-label-mode", "none"]
SED_FIXTURE_RECORDS = 2_600          # k2: 15% event photos, the rest noise
SKETCH_ROWS, SKETCH_N, SKETCH_D, SKETCH_DIM = 100_000, 10_000, 300, 50   # k3
SKETCH_BLOCK, SKETCH_SINGLE_ROWS = 1_000, 2_000


def phase_k1(smi: str) -> dict:
    """``main.cli`` in this process at the reference defaults (the sorting
    sweep: 2 approaches x 2 values, subset 150,000, window 2000), the
    per-point metrics read through a spy on ``output.log_metrics`` (which
    still writes the log), then the demo sweep."""
    captured = []
    log_metrics = port_main.output.log_metrics

    def spy(**kw):
        captured.append(kw)
        return log_metrics(**kw)

    n_windows = len(streaming.window_triggers(N_RECORDS, WINDOW, 1))
    with tempfile.TemporaryDirectory() as tmp:
        port_main.output.log_metrics = spy
        reset_counts()
        hashed = native.calls
        t0 = time.perf_counter()
        try:
            rc = port_main.cli(SWEEP_ARGS + ["--log-dir", tmp, "--plot-dir", tmp])
        finally:
            port_main.output.log_metrics = log_metrics
        secs = time.perf_counter() - t0
        launches, hasher_calls = ak.launches, native.calls - hashed
        logs = sorted(f for f in os.listdir(tmp) if f.startswith("exp=sorting,"))
        log_lines = [ln.split(":")[0] for ln in open(os.path.join(tmp, logs[0]))
                     if ": {" in ln] if logs else []
        t1 = time.perf_counter()
        demo_rc = port_main.cli(["--dataset", "demo", "--no-tee", "--log-dir", tmp,
                                 "--plot-dir", tmp])
        demo_secs = time.perf_counter() - t1
        demo_launches = ak.launches - launches
    metrics = captured[0]["metrics"] if captured else {}
    points = [{"approach": a, "sorting": r["sorting"][i], "windows": n_windows,
               "seconds": r["processing_time"][i],
               "windows_per_s": n_windows / r["processing_time"][i],
               "nmi": r["nmi_score"][i], "f1": r["f1_score"][i]}
              for a, r in metrics.items() for i in range(len(r["sorting"]))]
    out = {"card": smi, "args": SWEEP_ARGS, "rc": rc, "seconds": secs, "points": points,
           "k1_launches": launches, "windows": n_windows * len(points),
           "native_hasher_calls": hasher_calls, "log_files": logs, "log_lines": log_lines,
           "demo": {"rc": demo_rc, "seconds": demo_secs, "k1_launches": demo_launches}}
    print("[k1]", json.dumps(out), flush=True)
    if rc != 0 or demo_rc != 0 or len(points) != 4:
        raise AssertionError(f"k1: the CLI failed: {out}")
    if launches != 4 * out["windows"] or hasher_calls != 2 * out["windows"]:
        raise AssertionError(f"k1: expected {4 * out['windows']} K1 launches and "
                             f"{2 * out['windows']} hasher calls: {out}")
    if len(logs) != 1 or log_lines != ["SWFDMC", "sSVDMC"]:
        raise AssertionError(f"k1: the sweep's log file is missing or wrong: {out}")
    if not all(0.0 <= p[k] <= 1.0 for p in points for k in ("nmi", "f1")):
        raise AssertionError(f"k1: metrics out of range: {points}")
    return out


def sed2012_fixture(dataset_dir: str, n: int, seed: int = SEED) -> None:
    """A SED2012-shaped corpus of ``n`` photos: the three ground-truth files
    and a metadata XML with tied upload seconds, missing geotags, entities,
    CDATA, markup in text and ``0000-00-00`` dates."""
    rng = np.random.default_rng(seed)
    events = rng.integers(1, 7, n) * (rng.random(n) < 0.15)      # 6 events, 15% of photos
    homes = rng.uniform([-40, -120], [40, 120], size=(7, 2))
    parts = ['<?xml version="1.0" encoding="UTF-8"?>\n<photos>\n']
    for i in range(n):
        e = int(events[i])
        up = 1_335_000_000 + (e * 86_400 if e else int(rng.integers(0, 8 * 86_400)))
        up += int(rng.integers(0, 600)) // 60 * 60                  # whole minutes: ties
        taken = ("0000-00-00 00:00:00" if rng.random() < 0.05 else
                 time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(up - 300)) + ".0")
        lat, lon = homes[e] + rng.normal(size=2) * (0.02 if e else 30.0)
        loc = ("" if rng.random() < 0.1 else
               f'<location latitude="{lat:.6f}" longitude="{lon:.6f}"/>')
        word = f"event{e}" if e else f"noise{int(rng.integers(0, 50))}"
        title = (f"<![CDATA[{word} <b>live</b> & more]]>" if i % 7 == 0
                 else f"{word} &amp; friends &#233;t&#xe9; {i % 13}")
        tags = "".join(f"<tag>{word}{k}</tag>" for k in range(int(rng.integers(0, 4))))
        parts.append(
            f'<photo id="{10_000_000 + i}" dateTaken="{taken}" '
            f'dateUploaded="{time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(up))}.0" '
            f'username="u{int(rng.integers(0, 40)) if not e else e * 100 + i % 5}">'
            f'{loc}<title>{title}</title><description>photo {i} of {word}</description>'
            f'<tags>{tags}</tags></photo>\n')
    parts.append("</photos>\n")
    with open(os.path.join(dataset_dir, "sed2012_metadata.xml"), "w") as f:
        f.write("".join(parts))
    ids = {e: [str(10_000_000 + i) for i in np.flatnonzero(events == e)] for e in range(1, 7)}
    for fname, evs in (("technical_events.txt", (1, 2)), ("soccer_events.txt", (3, 4)),
                       ("indignados_events.txt", (5, 6))):
        with open(os.path.join(dataset_dir, fname), "w") as f:
            f.write("".join(",".join(ids[e]) + "\n" for e in evs))


def tables_equal(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        (a[k] == b[k]) if isinstance(a[k], list) else
        (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k],
                                                      equal_nan=a[k].dtype.kind == "f"))
        for k in a)


def phase_k2(smi: str, device) -> dict:
    """The SED2012 loader on a written fixture: the native scanner's table
    equals the Python path's; prepared like the reference (subset 2000,
    noise 0.95, binary, sorted) it runs one SWFDMC window on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        sed2012_fixture(tmp, SED_FIXTURE_RECORDS)
        scans = native.sed_calls
        t0 = time.perf_counter()
        table = sed2012.load_sed2012_dataset(tmp)
        native_secs = time.perf_counter() - t0
        os.environ["MUSED_TPU_NO_NATIVE_PARSER"] = "1"
        try:
            t0 = time.perf_counter()
            py_table = sed2012.load_sed2012_dataset(tmp)
            python_secs = time.perf_counter() - t0
        finally:
            del os.environ["MUSED_TPU_NO_NATIVE_PARSER"]
    mods, mtypes, labels = sed2012.prepare_modalities(table, subset_size=WINDOW,
                                                      binary=True, sort_by_uploaded=True,
                                                      noise_rate=NOISE_RATE, seed=SEED)
    up = np.asarray(mods[1][:, 1])
    reset_counts()
    res = api.process_streaming_data(
        results=api.get_initial_results()[0], data_modalities=mods, modality_types=mtypes,
        window_size=WINDOW, reduced_dim=REDUCED_DIM, k_basis=K_BASIS, n_clusters_total=2,
        seed=SEED, approach="SWFDMC", complete_true_labels=labels, step_window_ratio=1,
        noise_rate=NOISE_RATE, label_mode="binary", sorting=True, eps=1.5, min_samples=2)
    out = {"card": smi, "records": SED_FIXTURE_RECORDS, "native_scans": native.sed_calls - scans,
           "native_seconds": native_secs, "python_seconds": python_secs,
           "tables_equal": tables_equal(table, py_table),
           "event_photos": int(table["is_event"].sum()),
           "missing_geotags": int(np.isnan(table["latitude"]).sum()),
           "epoch_dates": int((table["datetaken"] == 0).sum()),
           "tied_upload_rows": int(len(up) - len(np.unique(up))),
           "window_rows": len(labels), "k1_launches": ak.launches,
           "nmi": res["nmi_score"][0], "f1": res["f1_score"][0]}
    print("[k2]", json.dumps(out), flush=True)
    if out["native_scans"] != 1 or not out["tables_equal"]:
        raise AssertionError(f"k2: the native scanner's table differs: {out}")
    if len(labels) != WINDOW or out["k1_launches"] != 4 or out["tied_upload_rows"] == 0 \
            or np.any(np.diff(up) < 0) or not 0.0 <= out["nmi"] <= 1.0:
        raise AssertionError(f"k2: {out}")
    return out


def phase_k3(smi: str) -> dict:
    """``SeqBasedSWFD`` on the reference's sketch benchmark spec (m = 10,
    d = 300, zeta = 10; n cut from 500,000 to 100,000), N = 10,000: 1,000-row
    fits and a stretch of 2,000 single-row fits; at every 10,000-row
    boundary ``get()``'s err must bound the live window's exact covariance
    error (float64 on the card)."""
    stream = port_synthetic.load_synthetic_dataset(SKETCH_ROWS, d=SKETCH_D, seed=SEED)[0]
    dev = torch.from_numpy(stream).cuda()              # float64 rows for the exact error
    r = float(np.max(np.sum(stream[:SKETCH_N] ** 2, axis=1)))
    sk = swfd.SeqBasedSWFD(N=SKETCH_N, R=r, d=SKETCH_D, sketch_dim=SKETCH_DIM)
    rows32 = stream.astype(np.float32)
    checks, fed, fit_secs, single_secs = [], 0, 0.0, 0.0
    single_at = SKETCH_ROWS // 2
    while fed < SKETCH_ROWS:
        t0 = time.perf_counter()
        if fed == single_at:
            for i in range(fed, fed + SKETCH_SINGLE_ROWS):      # reference main.py:65-67
                sk.fit(rows32[i].reshape(1, -1))
            fed += SKETCH_SINGLE_ROWS
            torch.cuda.synchronize()
            single_secs += time.perf_counter() - t0
        else:
            sk.fit(rows32[fed:fed + SKETCH_BLOCK])
            fed += SKETCH_BLOCK
            torch.cuda.synchronize()
            fit_secs += time.perf_counter() - t0
        if fed % SKETCH_N == 0:
            b, err, sq_fro, live = sk.get()
            w = dev[fed - SKETCH_N:fed]
            diff = w.T @ w - b.double().T @ b.double()
            true = float(torch.linalg.eigvalsh(diff).abs().max())
            checks.append({"rows": fed, "err": float(err), "true_error": true,
                           "sq_frobenius": float(sq_fro), "live_rows": live})
    out = {"card": smi, "rows": SKETCH_ROWS, "reduced": "n 500,000 -> 100,000 (time limit)",
           "N": SKETCH_N, "d": SKETCH_D, "sketch_dim": SKETCH_DIM, "ell": sk.ell,
           "block_rows": sk.block_rows, "chunk": sk.chunk,
           "rows_per_s_blocks": (SKETCH_ROWS - SKETCH_SINGLE_ROWS) / fit_secs,
           "rows_per_s_single_rows": SKETCH_SINGLE_ROWS / single_secs,
           "seals": sk.state.seal_cursor, "checks": checks}
    print("[k3]", json.dumps(out), flush=True)
    bad = [c for c in checks if not (c["true_error"] <= c["err"] and c["live_rows"] == SKETCH_N)]
    if len(checks) != SKETCH_ROWS // SKETCH_N or bad:
        raise AssertionError(f"k3: err does not bound the live window's error: {bad}")
    return out


def phase_k4(mods, mtypes, labels, smi: str, rr_run: dict | None) -> dict:
    """SWFDMC on (c)'s stream with the window fold on the Newton-Schulz
    shrink (``fd_shrink="subspace_ns"``), beside (c)'s rr run."""
    fast, slow = fd.fast_shrinks, fd.fallback_shrinks
    cfg = PipelineConfig(seed=SEED, subset_size=N_RECORDS, noise_rate=NOISE_RATE,
                         label_mode="binary", sorting=True, window_size=WINDOW,
                         reduced_dim=REDUCED_DIM, k_basis=K_BASIS, approach="SWFDMC",
                         n_clusters_override=2, fd_shrink="subspace_ns")
    reset_counts()
    t0 = time.perf_counter()
    res = api.process_streaming_data(
        results=api.get_initial_results()[0], data_modalities=mods, modality_types=mtypes,
        window_size=WINDOW, reduced_dim=REDUCED_DIM, k_basis=K_BASIS, n_clusters_total=2,
        seed=SEED, approach="SWFDMC", complete_true_labels=labels, step_window_ratio=1,
        noise_rate=NOISE_RATE, label_mode="binary", sorting=True, eps=1.5, min_samples=2,
        cfg=cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_windows = len(streaming.window_triggers(N_RECORDS, WINDOW, 1))
    out = {"card": smi, "windows": n_windows, "seconds": secs,
           "windows_per_s": n_windows / secs, "nmi": res["nmi_score"][0],
           "f1": res["f1_score"][0], "k1_launches": ak.launches,
           "fast_shrinks": fd.fast_shrinks - fast, "fallback_shrinks": fd.fallback_shrinks - slow,
           "rr_phase_c": rr_run and {k: rr_run[k] for k in ("windows_per_s", "nmi", "f1")}}
    print("[k4]", json.dumps(out), flush=True)
    shrinks = out["fast_shrinks"] + out["fallback_shrinks"]
    if shrinks != 3 * n_windows or out["k1_launches"] != 4 * n_windows \
            or not 0.0 <= out["nmi"] <= 1.0:
        raise AssertionError(f"k4: expected {3 * n_windows} shrinks (three 800-row blocks "
                             f"per window) and {4 * n_windows} K1 launches: {out}")
    return out


def phase_k5(smi: str) -> dict:
    """BASELINE.md config #2 (20,000 crisis rows, two 512-wide embeddings,
    unsorted) through sSVDMC with centroid matching against the positional
    matching; then the detector with centroid matching, saved and loaded
    halfway, against its uninterrupted run."""
    mods, mtypes, labels = crisis_embedding_stream(n_rows=SLICE2_RECORDS, n_events=8,
                                                   noise_rate=0.3, seed=SEED)
    n_windows = SLICE2_RECORDS // WINDOW
    out = {"card": smi, "records": SLICE2_RECORDS, "windows": n_windows}
    for matching in ("centroid", "auto"):
        reset_counts()
        t0 = time.perf_counter()
        res = api.process_streaming_data(
            results=api.get_initial_results()[0], data_modalities=mods, modality_types=mtypes,
            window_size=WINDOW, reduced_dim=REDUCED_DIM, k_basis=K_BASIS, n_clusters_total=9,
            seed=SEED, approach="sSVDMC", complete_true_labels=labels, step_window_ratio=1,
            noise_rate=0.3, label_mode="all", sorting=False, eps=1.5, min_samples=2,
            matching=matching)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[matching] = {"nmi": res["nmi_score"][0], "f1": res["f1_score"][0],
                         "windows_per_s": n_windows / secs, "k1_launches": ak.launches}
        if ak.launches != 2 * n_windows:
            raise AssertionError(f"k5 {matching}: {ak.launches} K1 launches for "
                                 f"{n_windows} windows (expected 2 dot per window)")

    def make():
        return StreamDetector(mtypes, WINDOW, approach="sSVDMC", reduced_dim=REDUCED_DIM,
                              k_basis=K_BASIS, k_estimate="eigengap", matching="centroid")

    warm_up(make, mods)
    run = detector_run(make(), mods, SLICE2_RECORDS, SERVE_CHUNK)
    full = run.pop("results")
    half = SLICE2_RECORDS // 2
    first = make()
    resumed = serve(first, mods, 0, half, SERVE_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "detector.npz")
        resumed.extend(first.save(path))
        second = StreamDetector.load(path)
    registry = len(second.engine.centroid_matcher.ids)
    resumed.extend(serve(second, mods, half, SLICE2_RECORDS, SERVE_CHUNK))
    resumed.extend(second.flush())
    clus = np.concatenate([r.clusters for r in full])
    out["detector"] = {**{k: run[k] for k in ("windows", "windows_per_s", "push_p50_ms",
                                               "push_p99_ms", "k1_launches")},
                       "nmi": nmi(labels[:len(clus)], clus),
                       "registry_at_save": registry,
                       "identical_windows": sum(np.array_equal(a.clusters, b.clusters)
                                                for a, b in zip(full, resumed)),
                       "resumed_windows": len(resumed)}
    print("[k5]", json.dumps(out), flush=True)
    d = out["detector"]
    if d["k1_launches"] != 2 * d["windows"] or d["windows"] != n_windows:
        raise AssertionError(f"k5: detector launches {d}")
    if d["identical_windows"] != n_windows or d["resumed_windows"] != n_windows:
        raise AssertionError(f"k5: the resumed detector differs: {d}")
    return out


def phase_k6(mods, device, smi: str) -> dict:
    """The reference API on one 2000-row window: each ``create_adjacency_matrix``
    graph bit-equal to the engine's graph of that modality (the standard
    path's for location, username, tags and text; the numeric-modality path's
    for time, which the JAX package's API also takes raw), 4 K1 launches;
    then fuse_matrices, perform_svd_reduction and perform_clustering."""
    window = [m[:WINDOW] for m in mods]
    engine = streaming.StreamingEngine(PipelineConfig(window_size=WINDOW, k_basis=K_BASIS,
                                                      reduced_dim=REDUCED_DIM), device)
    host = engine.featurize(window, streaming.STANDARD_TYPES)
    fc = engine.cfg.features
    loc, tim, uid, tags, text, text_cnt, tags_valid = to_device(host, device)
    graphs = streaming.standard_kernel_graphs(
        loc, tim, uid, tags, text, text_cnt, tags_valid, k_basis=K_BASIS,
        tags_dim=fc.tags_hash_dim, text_dim=fc.text_hash_dim, sparse=True)
    graphs[1] = streaming.kernel_graph(torch.from_numpy(window[1].astype(np.float32)).to(
        device), "time", K_BASIS)
    reset_counts()
    t0 = time.perf_counter()
    got = [api.create_adjacency_matrix(m, t, k_basis=K_BASIS)
           for m, t in zip(window, streaming.STANDARD_TYPES)]
    secs = time.perf_counter() - t0
    launches = ak.launches
    fused = api.fuse_matrices(got)
    reduced = api.perform_svd_reduction(fused, REDUCED_DIM, SEED)
    labels = api.perform_clustering(reduced, 2, SEED)
    out = {"card": smi, "rows": WINDOW, "seconds": secs, "k1_launches": launches,
           "edges": {t: int(g.sum()) for t, g in zip(streaming.STANDARD_TYPES, got)},
           "mismatched_entries": {t: int((g != w.cpu().numpy()).sum()) for t, g, w in
                                  zip(streaming.STANDARD_TYPES, got, graphs)},
           "fused_edges": int(fused.sum()), "reduced_shape": list(reduced.shape),
           "clusters": int(len(np.unique(labels)))}
    print("[k6]", json.dumps(out), flush=True)
    if launches != 4 or any(out["mismatched_entries"].values()):
        raise AssertionError(f"k6: {out}")
    if reduced.shape != (WINDOW, REDUCED_DIM) or not np.isfinite(reduced).all() \
            or out["clusters"] != 2:
        raise AssertionError(f"k6: the reference API's reduction / clustering: {out}")
    return out


# ---------------------------------------------------------------------------
# slice 4b: the row-sharded layouts at world size 1, phase (l)
# ---------------------------------------------------------------------------

L1_RUNS = (("SWFDMC", "allgather"), ("SWFDMC", "ring"), ("sSVDMC", "allgather"))
L2_APPROACHES = ("SWFDMC", "sSVDMC", "sSpectral")
MODALITIES = ("location", "time", "username", "tags", "text")
L1_BIT_EQUAL = ("time", "username", "tags")


class LocalAxis:
    """A world of one on the CPU: every collective is the identity, so the
    row-sharded functions run there as they run on the card's group of one."""

    size, index = 1, 0

    def psum(self, x):
        return x

    def all_gather(self, x):
        return x[None]


def only_modality(host, keep: str):
    """A standard window's features with every modality but ``keep``
    invalid (NaN location, zero times, uid -1, no tag or text tokens)."""
    f = {k: np.array(v) for k, v in host._asdict().items()}
    if keep != "location":
        f["location"][:] = np.nan
    if keep != "time":
        f["times"][:] = 0.0
    if keep != "username":
        f["user_ids"][:] = -1
    if keep != "tags":
        f["tags_valid"][:] = False
        if "tags_ids" in f:
            f["tags_ids"][:] = -1
        else:
            f["tags"][:] = 0
    if keep != "text":
        if "text_ids" in f:
            f["text_ids"][:] = -1
            f["text_cnt"][:] = 0
        else:
            f["text"][:] = 0
    return type(host)(**f)


def row_engine(cfg: PipelineConfig, mesh, device,
               sync_spans: bool = False) -> streaming.StreamingEngine:
    """A StreamingEngine of ``cfg`` on the row-sharded code: the mesh of the
    NCCL group of one assigned to it (data_shards=1 builds none); its spans
    synchronize at their ends when ``sync_spans`` (to compare them)."""
    engine = streaming.StreamingEngine(cfg, device)
    engine.mesh = mesh
    engine.timer = SpanTimer(engine.device, sync_all=sync_spans)
    return engine


def phase_l1(mods, mtypes, labels, device, mesh, runs_c: list, smi: str) -> dict:
    """The row-sharded dense window step (``parallel/sharded.sharded_engine_step``)
    through ``process_streaming_data`` over (c)'s stream, no K1; the first
    window's fused shard on the card against the same function on the CPU,
    modality by modality, and its ms beside the single-device K1 fusion's."""
    from mused_tpu_torch.parallel import sharded
    out = {"card": smi, "world_size": 1, "runs": [], "single_device": [
        {k: r[k] for k in ("approach", "windows_per_s", "nmi", "f1")} for r in runs_c]}
    for approach, topology in L1_RUNS:
        cfg = PipelineConfig(seed=SEED, subset_size=N_RECORDS, noise_rate=NOISE_RATE,
                             label_mode="binary", sorting=True, window_size=WINDOW,
                             reduced_dim=REDUCED_DIM, k_basis=K_BASIS, approach=approach,
                             n_clusters_override=2, merge_topology=topology)
        engine = row_engine(cfg, mesh, device)
        n_windows = len(streaming.window_triggers(N_RECORDS, WINDOW, 1))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = api.process_streaming_data(
            results=api.get_initial_results()[0], data_modalities=mods,
            modality_types=mtypes, window_size=WINDOW, reduced_dim=REDUCED_DIM,
            k_basis=K_BASIS, n_clusters_total=2, seed=SEED, approach=approach,
            complete_true_labels=labels, step_window_ratio=1, noise_rate=NOISE_RATE,
            label_mode="binary", sorting=True, eps=1.5, min_samples=2, cfg=cfg,
            engine=engine)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out["runs"].append({"approach": approach, "topology": topology, "windows": n_windows,
                            "seconds": secs, "windows_per_s": n_windows / secs,
                            "nmi": res["nmi_score"][0], "f1": res["f1_score"][0],
                            "k1_launches": ak.launches, "launches": huge_counts(),
                            "spans": engine.timer.summary()})
    engine = streaming.StreamingEngine(PipelineConfig(window_size=WINDOW, k_basis=K_BASIS,
                                                      reduced_dim=REDUCED_DIM), device)
    host = engine.featurize([m[:WINDOW] for m in mods], streaming.STANDARD_TYPES)
    types = streaming.types_for(host, streaming.STANDARD_TYPES)
    dims = dict(tags_dim=engine.cfg.features.tags_hash_dim,
                text_dim=engine.cfg.features.text_hash_dim)
    parity = {}
    for modality in MODALITIES:
        masked = only_modality(host, modality)
        got = sharded.fused_shard(to_device(masked, device), types, k_basis=K_BASIS,
                                  mesh=mesh, **dims).cpu()
        want = sharded.features_to_fused_shard(to_device(masked, torch.device("cpu")), types,
                                               K_BASIS,
                                               axis=LocalAxis(), **dims)
        parity[modality] = {"edges": int(want.sum()), "mismatched": int((got != want).sum()),
                            "agreement": edge_agreement(got, want),
                            "degrees_equal": bool(torch.equal(got.sum(1), want.sum(1)))}
    feats = to_device(host, device)
    out["fused_shard_parity"] = parity
    out["ms_per_window"] = {
        "row_shard_strip": cuda_ms(lambda: sharded.fused_shard(feats, types, k_basis=K_BASIS,
                                                               mesh=mesh, **dims), reps=5),
        "single_device_k1": cuda_ms(lambda: engine.fuse_from_features(host, feats,
                                                                      streaming.STANDARD_TYPES),
                                    reps=5)}
    print("[l1]", json.dumps(out), flush=True)
    for r in out["runs"]:
        if r["k1_launches"] or any(r["launches"].values()):
            raise AssertionError(f"l1: the row-sharded dense step launched a kernel: {r}")
        if not all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0 for k in ("nmi", "f1")):
            raise AssertionError(f"l1: metrics out of range: {r}")
    for modality, p in parity.items():
        ok = (p["mismatched"] == 0 if modality in L1_BIT_EQUAL
              else p["agreement"] >= EDGE_AGREEMENT and p["degrees_equal"])
        if not ok or not p["edges"]:
            raise AssertionError(f"l1: {modality} shard on the card against the CPU: {p}")
    return out


def profile_row_windows(mods, mtypes, labels, device, mesh, approach: str,
                        windows: int = 10) -> dict:
    """The row-sharded dense step's ``approach`` windows traced
    (``--profile``): ``windows`` windows of (c)'s stream after a warm-up run
    of 4, with the engine's own spans beside the trace."""
    spans = {}

    def run(n_windows: int):
        n = n_windows * WINDOW
        cfg = PipelineConfig(window_size=WINDOW, reduced_dim=REDUCED_DIM, k_basis=K_BASIS,
                             approach=approach, n_clusters_override=2, label_mode="binary")
        engine = row_engine(cfg, mesh, device, sync_spans=True)
        api.process_streaming_data(
            results=api.get_initial_results()[0], data_modalities=[m[:n] for m in mods],
            modality_types=mtypes, window_size=WINDOW, reduced_dim=REDUCED_DIM,
            k_basis=K_BASIS, n_clusters_total=2, seed=SEED, approach=approach,
            complete_true_labels=labels[:n], step_window_ratio=1, noise_rate=NOISE_RATE,
            label_mode="binary", sorting=True, eps=1.5, min_samples=2, cfg=cfg,
            engine=engine)
        torch.cuda.synchronize()
        spans.update(engine.timer.summary())

    run(4)
    out = traced(lambda: run(windows), {"path": f"row-sharded dense {approach}",
                                        "windows": windows}, tag="profile-rows")
    return {**out, "spans": spans}


def phase_l2(hmods, hmtypes, hlabels, cols: ba.Columns, device, mesh, single_seconds: dict,
             smi: str) -> dict:
    """The huge-window ``rows`` layout through ``process_streaming_data`` on the
    first window of (f)'s stream: exact K2-K5 counts per approach, seconds
    beside (f)'s and (i3)'s single-device windows; the row-sharded fold's
    sq_frobenius against the single-device fold's."""
    from mused_tpu_torch.parallel import sharded
    out = {"card": smi, "world_size": 1, "window": HUGE_WINDOW, "runs": {},
           "single_device_seconds_per_window": single_seconds}
    blocks = BLOCKS_PER_WINDOW
    want = {"SWFDMC": with_routes({"K2": 2 * blocks, "K3": blocks, "K4": 2 * blocks,
                                   "K5": blocks, "lists": blocks}),
            "sSVDMC": with_routes({"K2": 2 * SSVD_SWEEPS * blocks, "K3": SSVD_SWEEPS * blocks,
                                   "K4": 0, "K5": 0, "lists": 0}),
            "sSpectral": with_routes({"K2": 2 * SPECTRAL_SWEEPS * blocks,
                                      "K3": SPECTRAL_SWEEPS * blocks, "K4": 0, "K5": 0,
                                      "lists": 0})}
    for approach in L2_APPROACHES:
        cfg = huge_cfg(approach, HUGE_WINDOW)
        engine = row_engine(cfg, mesh, device)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = api.process_streaming_data(
            results=api.get_initial_results()[0],
            data_modalities=[m[:HUGE_WINDOW] for m in hmods], modality_types=hmtypes,
            window_size=HUGE_WINDOW, reduced_dim=REDUCED_DIM, k_basis=K_BASIS,
            n_clusters_total=2, seed=SEED, approach=approach,
            complete_true_labels=hlabels[:HUGE_WINDOW], step_window_ratio=1,
            noise_rate=NOISE_RATE, label_mode="binary", sorting=True, eps=1.5, min_samples=2,
            cfg=cfg, engine=engine)
        torch.cuda.synchronize()
        out["runs"][approach] = {"seconds": time.perf_counter() - t0,
                                 "launches": huge_counts(), "k1_launches": ak.launches,
                                 "nmi": res["nmi_score"][0], "f1": res["f1_score"][0],
                                 "spans": engine.timer.summary()}
    ell = min(REDUCED_DIM, HUGE_WINDOW)
    kw = dict(ell=ell, block=HUGE_BLOCK, k_basis=K_BASIS, select="binned", nbins=HUGE_NBINS)
    _, sq1, _ = ba.blocked_fd_sketch(cols, **kw)
    _, sq, _ = sharded.sharded_blocked_fd_sketch(cols, mesh=mesh, **kw)
    out["sq_frobenius"], out["sq_frobenius_single_device"] = float(sq), float(sq1)
    print("[l2]", json.dumps(out), flush=True)
    for approach, r in out["runs"].items():
        if r["launches"] != want[approach] or r["k1_launches"]:
            raise AssertionError(f"l2 {approach}: launches {r['launches']} (K1 "
                                 f"{r['k1_launches']}), expected {want[approach]}")
        if not all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0 for k in ("nmi", "f1")):
            raise AssertionError(f"l2 {approach}: metrics out of range: {r}")
    if out["sq_frobenius"] != out["sq_frobenius_single_device"]:
        raise AssertionError(f"l2: sq_frobenius differs from the single-device fold: {out}")
    return out


def phase_l3(smi: str) -> dict:
    """``main.cli --parallel-sweep`` on the demo sweep (one point per card)
    against the sequential demo: every point's metrics within 1e-6."""
    logged = {}
    log_metrics = port_main.output.log_metrics
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("sequential", []), ("parallel", ["--parallel-sweep"])):
            def spy(**kw):
                logged.setdefault(name, []).append(kw["metrics"])
                return log_metrics(**kw)
            port_main.output.log_metrics = spy
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = port_main.cli(["--dataset", "demo", "--no-tee", "--log-dir", tmp,
                                        "--plot-dir", tmp, *extra])
            finally:
                port_main.output.log_metrics = log_metrics
            secs[name] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"l3: the {name} demo exited {rc}")
    diffs = []
    for seq, par in zip(logged["sequential"], logged["parallel"]):
        for approach, want in seq.items():
            for key, vals in want.items():
                if key == "processing_time" or not isinstance(vals[0], float):
                    continue
                diffs += [abs(a - b) for a, b in zip(par[approach][key], vals)]
    points = sum(len(m[a]["nmi_score"]) for m in logged["parallel"] for a in m)
    out = {"card": smi, "devices": [str(d) for d in port_main.sweep.sweep_devices("cuda")],
           "points": points, "seconds": secs, "max_abs_diff": max(diffs)}
    print("[l3]", json.dumps(out), flush=True)
    if len(logged["parallel"]) != len(logged["sequential"]) or out["max_abs_diff"] > 1e-6:
        raise AssertionError(f"l3: the parallel sweep differs from the sequential one: {out}")
    return out


# ---------------------------------------------------------------------------
# the scanned multi-window dispatch and the repaired host waits: phase (m)
# ---------------------------------------------------------------------------

# m1's runs per approach, (W, the parent's host waits): the parent's and the
# repaired per-window dispatch first and last (in turns), the groups between;
# SWFDMC also runs each parent wait alone
M1_RUNS = (("SWFDMC", ((1, "both"), (1, ""), (4, ""), (8, ""), (1, "lloyd"), (1, "timer"),
                       (1, ""), (1, "both"))),
           ("sSVDMC", ((1, "both"), (1, ""), (4, ""), (8, ""), (1, ""), (1, "both"))))
M_SYNC_WINDOWS = 8               # windows of (c)'s stream in the sync count
M3_WINDOWS = 20                  # windows of (c)'s stream in m3
LLOYD_WINDOWS, LLOYD_REPS = 5, 8
LLOYD_CHECKS = (4, 8, 16)        # kmeans.CHECK_EVERY candidates timed in m1


def parent_kmeans(x, k, generator=None, *, k_max: int, max_iters: int = 100,
                  tol: float = 1e-4, init=None):
    """``ops/kmeans.kmeans`` as it was before its Lloyd loop stopped reading
    the host every step (two reads per step: any empty cluster, and the
    shift test); kept here only to time it and count its syncs."""
    n = x.shape[0]
    x = x.float()
    k = torch.as_tensor(k, device=x.device)
    alive = torch.arange(k_max, device=x.device) < k
    c = kmeans.kmeanspp_init(x, k_max, k, generator) if init is None else init.float()
    arange_k = torch.arange(k_max, device=x.device)

    def assign(cent):
        return torch.argmin(torch.where(alive[None, :], kmeans._sq_dists(x, cent), torch.inf),
                            dim=1)

    for _ in range(max_iters):
        labels = assign(c)
        onehot = (labels[:, None] == arange_k[None, :]).float()
        counts = torch.sum(onehot, dim=0)
        new_c = torch.where((counts > 0)[:, None],
                            (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None], c)
        empty = alive & (counts == 0)
        if bool(torch.any(empty)):
            dist_own = torch.gather(kmeans._sq_dists(x, new_c), 1, labels[:, None])[:, 0]
            k_eff = min(k_max, n)
            far = torch.sort(dist_own, descending=True, stable=True)[1][:k_eff]
            slot = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0, k_eff - 1)
            new_c = torch.where(empty[:, None], x[far[slot]], new_c)
        shift = torch.sum((new_c - c) ** 2)
        c = new_c
        if not bool(shift > tol):
            break
    return assign(c), c


@contextlib.contextmanager
def parent_sequence(engine: streaming.StreamingEngine, waits: str):
    """The host waits of the code before the repair, ``waits`` naming which:
    "timer" a span timer that synchronizes at every span end, "lloyd"
    Lloyd's loop reading the host twice per step, "both", or "" none."""
    if waits in ("timer", "both"):
        engine.timer = SpanTimer(engine.device, sync_all=True)
    repaired = kmeans.kmeans
    if waits in ("lloyd", "both"):
        kmeans.kmeans = parent_kmeans
    try:
        yield
    finally:
        kmeans.kmeans = repaired


@contextlib.contextmanager
def captured_clusters(into: list):
    """Append each ``process_streaming_data`` run's matched labels (every
    window's, concatenated) to ``into``."""
    compute = streaming.metrics_mod.compute_all_metrics

    def spy(*args):
        into.append(np.array(args[8]))
        return compute(*args)

    streaming.metrics_mod.compute_all_metrics = spy
    try:
        yield
    finally:
        streaming.metrics_mod.compute_all_metrics = compute


def m_stream_run(mods, mtypes, labels, device, approach: str, n_records: int, group: int,
                 parent: str = "", mesh=None) -> dict:
    """(c)'s configuration over the first ``n_records`` records with
    ``windows_per_batch=group`` (and the parent's host waits that ``parent``
    names, see :func:`parent_sequence`): windows/s, NMI, F1, K1 launches,
    window steps (a padded tail group's included) and the matched labels."""
    cfg = PipelineConfig(seed=SEED, subset_size=n_records, noise_rate=NOISE_RATE,
                         label_mode="binary", sorting=True, window_size=WINDOW,
                         reduced_dim=REDUCED_DIM, k_basis=K_BASIS, approach=approach,
                         n_clusters_override=2, windows_per_batch=group)
    engine = streaming.StreamingEngine(cfg, device)
    engine.mesh = mesh
    n_windows = len(streaming.window_triggers(n_records, WINDOW, 1))
    clusters = []
    torch.cuda.synchronize()
    reset_counts()
    with captured_clusters(clusters), parent_sequence(engine, parent):
        t0 = time.perf_counter()
        res = api.process_streaming_data(
            results=api.get_initial_results()[0], data_modalities=[m[:n_records] for m in mods],
            modality_types=mtypes, window_size=WINDOW, reduced_dim=REDUCED_DIM,
            k_basis=K_BASIS, n_clusters_total=2, seed=SEED, approach=approach,
            complete_true_labels=labels[:n_records], step_window_ratio=1,
            noise_rate=NOISE_RATE, label_mode="binary", sorting=True, eps=1.5,
            min_samples=2, cfg=cfg, engine=engine)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return {"approach": approach, "group": group, "parent_waits": parent or None,
            "windows": n_windows, "window_steps": -(-n_windows // group) * group,
            "seconds": secs, "windows_per_s": n_windows / secs, "nmi": res["nmi_score"][0],
            "f1": res["f1_score"][0], "k1_launches": ak.launches,
            "spans": engine.timer.summary(), "clusters": clusters[0]}


def sync_category(filename: str, lineno: int, parent_lines: range) -> str:
    """Which host wait a synchronizing call site is."""
    line = linecache.getline(filename, lineno)
    if filename.endswith("profiling.py"):
        return "span timer"
    if "linalg." in line:
        return "eigh / svd"
    if filename.endswith("kmeans.py") or (filename == __file__ and lineno in parent_lines):
        return "lloyd"
    if filename.endswith("/fd.py"):
        return "fd"
    if filename.endswith("/swfd.py"):
        return "swfd ring"
    if ".cpu()" in line or ".numpy()" in line:
        return "label pull"
    return "other"


def sync_count(run, n_windows: int) -> dict:
    """Host synchronizations of ``run()`` per window, by category and call
    site: the operations ``torch.cuda.set_sync_debug_mode("warn")`` flags,
    plus every ``torch.cuda.synchronize`` call (which it does not flag)."""
    import collections
    import warnings
    sites = collections.Counter()
    real_sync = torch.cuda.synchronize

    def counting_sync(*a, **k):
        caller = sys._getframe(1)
        sites[(caller.f_code.co_filename, caller.f_lineno)] += 1
        return real_sync(*a, **k)

    torch.cuda.synchronize = counting_sync
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize = real_sync
    for w in caught:
        if "synchroniz" in str(w.message):
            sites[(w.filename, w.lineno)] += 1
    src, first = inspect.getsourcelines(parent_kmeans)
    parent_lines = range(first, first + len(src))
    # this script's own waits around the run are the measurement's, not the path's
    sites = collections.Counter({(f, ln): c for (f, ln), c in sites.items()
                                 if f != __file__ or ln in parent_lines})
    by_cat = collections.Counter()
    for (f, ln), c in sites.items():
        by_cat[sync_category(f, ln, parent_lines)] += c
    return {"per_window": {k: v / n_windows for k, v in sorted(by_cat.items())},
            "total_per_window": sum(by_cat.values()) / n_windows,
            "sites": [{"site": f"{os.path.relpath(f)}:{ln}",
                       "category": sync_category(f, ln, parent_lines),
                       "per_window": c / n_windows}
                      for (f, ln), c in sites.most_common(12)]}


def lloyd_timing(mods, device) -> dict:
    """Lloyd's loop per call on the first windows' sSVDMC reductions of (c)'s
    stream, at m1's count (k from the labels, k_max 2) and at the detector's
    (the eigengap count, k_max 150): the parent loop against ``CHECK_EVERY``
    4, 8 and 16, each from the same k-means++ centres, labels bit-equal."""
    from mused_tpu_torch.ops import reduction
    engine = streaming.StreamingEngine(PipelineConfig(window_size=WINDOW, k_basis=K_BASIS,
                                                      reduced_dim=REDUCED_DIM), device)
    xs = []
    for w in range(LLOYD_WINDOWS):
        host = engine.featurize([m[w * WINDOW:(w + 1) * WINDOW] for m in mods],
                                streaming.STANDARD_TYPES)
        fused = engine.fuse_from_features(host, to_device(host, device),
                                          streaming.STANDARD_TYPES)
        xs.append(reduction.svd_reduce(fused, REDUCED_DIM,
                                       streaming.window_generator(SEED, w, device)))
    out = {}
    check = kmeans.CHECK_EVERY
    for name, k_max in (("labels_k_max_2", 2), ("eigengap_k_max_150", 150)):
        calls = []
        for w, x in enumerate(xs):
            k = 2 if k_max == 2 else int(reduction.eigengap_k(x, k_max=k_max))
            calls.append((x, k, kmeans.kmeanspp_init(
                x, k_max, k, streaming.window_generator(SEED, w, device))))
        variants = ["parent"] + [f"check_every_{m}" for m in LLOYD_CHECKS]
        secs = dict.fromkeys(variants, 0.0)
        labels = {}
        try:
            # variants in turns, the order rotating each round (host time is noisy)
            for rnd in range(LLOYD_REPS + 1):
                for variant in variants[rnd % len(variants):] + variants[:rnd % len(variants)]:
                    fn = parent_kmeans if variant == "parent" else kmeans.kmeans
                    if fn is kmeans.kmeans:
                        kmeans.CHECK_EVERY = int(variant.rsplit("_", 1)[1])
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = [fn(x, k, k_max=k_max, init=init)[0] for x, k, init in calls]
                    torch.cuda.synchronize()
                    if rnd:                                         # round 0 warms up
                        secs[variant] += time.perf_counter() - t0
                    labels[variant] = torch.stack(got).cpu()
        finally:
            kmeans.CHECK_EVERY = check
        ms = {v: t * 1e3 / (LLOYD_REPS * len(calls)) for v, t in secs.items()}
        equal = all(torch.equal(v, labels["parent"]) for v in labels.values())
        out[name] = {"k": [k for _, k, _ in calls], "ms_per_call": ms,
                     "labels_equal_parent": equal}
        if not equal:
            raise AssertionError(f"m1: the repaired Lloyd loop's labels differ: {name}")
    return out


def phase_m1(mods, mtypes, labels, device, smi: str) -> dict:
    """(c)'s stream through SWFDMC and sSVDMC with the parent's host waits
    and at W = 1, 4 and 8: windows/s, NMI, F1; every window's labels equal
    across them; 4 K1 launches per window step.  Then the host syncs per
    window of the parent's sequence, the repaired one and W = 4, and
    Lloyd's loop per call."""
    out = {"card": smi, "records": N_RECORDS, "check_every": kmeans.CHECK_EVERY, "runs": []}
    for approach, order in M1_RUNS:
        runs = [m_stream_run(mods, mtypes, labels, device, approach, N_RECORDS, g, parent=p)
                for g, p in order]
        per_window = runs[1]["clusters"]
        for r in runs:
            r["labels_equal_per_window"] = bool(np.array_equal(r.pop("clusters"), per_window))
        out["runs"].extend(runs)
    n_sync = M_SYNC_WINDOWS * WINDOW
    out["syncs"] = {}
    for approach in ("SWFDMC", "sSVDMC"):
        for name, group, parent in (("parent", 1, "both"), ("repaired", 1, ""),
                                    ("repaired_w4", 4, "")):
            out["syncs"][f"{approach}_{name}"] = sync_count(
                lambda: m_stream_run(mods, mtypes, labels, device, approach, n_sync, group,
                                     parent=parent), M_SYNC_WINDOWS)
    out["lloyd"] = lloyd_timing(mods, device)
    m_launches = sum(r["k1_launches"] for r in out["runs"])
    out["k1_launches"] = m_launches
    print("[m1]", json.dumps(out), flush=True)
    for r in out["runs"]:
        if not r["labels_equal_per_window"]:
            raise AssertionError(f"m1: labels differ from per-window dispatch: {r}")
        if r["k1_launches"] != 4 * r["window_steps"]:
            raise AssertionError(f"m1: expected {4 * r['window_steps']} K1 launches: {r}")
        if not all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0 for k in ("nmi", "f1")):
            raise AssertionError(f"m1: metrics out of range: {r}")
    return out


def phase_m2(mods, smi: str) -> dict:
    """h1's detector at ``windows_per_batch=4`` against W = 1: the same
    results; windows/s, push p50 / p99 and the largest lag of each."""
    rows = [m[:SERVE_RECORDS] for m in mods]
    out = {"card": smi, "records": SERVE_RECORDS, "chunk": SERVE_CHUNK}
    results = {}
    for group in (1, 4):
        def make():
            cfg = PipelineConfig(window_size=WINDOW, reduced_dim=REDUCED_DIM, k_basis=K_BASIS,
                                 approach="SWFDMC", label_mode="all", n_clusters_override=150,
                                 k_estimate="eigengap", background_bucket=True,
                                 windows_per_batch=group)
            return StreamDetector(streaming.STANDARD_TYPES, WINDOW, cfg=cfg)

        warm_up(make, rows)
        det = make()
        run = detector_run(det, rows, SERVE_RECORDS, SERVE_CHUNK)
        results[group] = run.pop("results")
        out[f"w{group}"] = {k: run[k] for k in ("windows", "seconds", "windows_per_s",
                                                "push_p50_ms", "push_p99_ms",
                                                "max_lag_windows", "k1_launches", "spans")}
        out[f"w{group}"]["batch_w"] = det._batch_w
    same = (len(results[1]) == len(results[4]) and all(
        a.window_index == b.window_index and np.array_equal(a.clusters, b.clusters)
        for a, b in zip(results[1], results[4])))
    out["results_equal"] = same
    out["k1_launches"] = out["w1"]["k1_launches"] + out["w4"]["k1_launches"]
    print("[m2]", json.dumps(out), flush=True)
    if not same or out["w4"]["batch_w"] != 4:
        raise AssertionError(f"m2: the grouped detector differs from per-window: {out}")
    for w in ("w1", "w4"):
        if out[w]["k1_launches"] != 4 * out[w]["windows"]:
            raise AssertionError(f"m2: expected 4 K1 launches per window: {out[w]}")
    return out


def phase_m3(mods, mtypes, labels, device, mesh, smi: str) -> dict:
    """l1's row-sharded dense step (sSVDMC, world size 1) over the first
    ``M3_WINDOWS`` windows of (c)'s stream with W = 4 against W = 1: the
    same labels, no K1."""
    n = M3_WINDOWS * WINDOW
    runs = [m_stream_run(mods, mtypes, labels, device, "sSVDMC", n, g, mesh=mesh)
            for g in (1, 4)]
    same = bool(np.array_equal(runs[0].pop("clusters"), runs[1].pop("clusters")))
    out = {"card": smi, "world_size": 1, "runs": runs, "labels_equal": same}
    print("[m3]", json.dumps(out), flush=True)
    if not same:
        raise AssertionError(f"m3: the sharded groups differ from per-window dispatch: {out}")
    if any(r["k1_launches"] for r in runs):
        raise AssertionError(f"m3: the row-sharded dense step launched K1: {out}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="abcdefghijklm",
                        help="phases to run (a always runs); the result lines print "
                             "only when all ran")
    parser.add_argument("--parent", metavar="DIR",
                        help="an unpacked earlier tree: phase i2 (and K1 at i4's n) and "
                             "phase e's K4 / K5 also run there, in turns with this tree's")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one huge window per approach with torch.profiler "
                             "(kernel time by name, busy share), and with (e) ten calls of "
                             "each K4 / K5 / list call; prints no result lines")
    args = parser.parse_args()
    phases = set(args.phases) | {"a"}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    streaming.configure_precision()
    smi = nvidia_smi_line()
    print(f"[a] device {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    seconds = {}

    t0 = time.perf_counter()
    lib = build.load()
    print(f"[a] kernel library {build.library_path()} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds} s); K1 shared "
          f"memory per CTA: sim_keys {lib.mused_knn_smem_bytes(0)} B, radix_select "
          f"{lib.mused_knn_smem_bytes(1)} B", flush=True)
    for line in build.build_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")) or \
                line.startswith("=="):
            print("[a] ptxas:", line.strip())
    t1 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native hasher did not build: {native.load_error}")
    print(f"[a] hasher: native, {native.library_path()} ready in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    t1 = time.perf_counter()
    if not native.incdb_available():
        raise AssertionError(f"the native incdbscan core did not build: "
                             f"{native.incdb_load_error}")
    print(f"[a] incdbscan core: native, {native.library_path(native.INCDB_SOURCE)} "
          f"ready in {time.perf_counter() - t1:.2f} s", flush=True)
    seconds["a"] = time.perf_counter() - t0

    rows_b, runs, main_launches = [], [], 0
    if phases & set("bcdhiklm"):
        t0 = time.perf_counter()
        mods, mtypes, labels = make_stream(N_RECORDS, noise_rate=NOISE_RATE, binary=True,
                                           sort_by_uploaded=True, seed=SEED)
        print(f"[c] synthetic stream: {len(labels)} records, {int(labels.sum())} event "
              f"rows, {time.perf_counter() - t0:.1f} s", flush=True)
    if "b" in phases:
        t0 = time.perf_counter()
        probe_engine = streaming.StreamingEngine(
            PipelineConfig(window_size=WINDOW, k_basis=K_BASIS, reduced_dim=REDUCED_DIM),
            device)
        rows_b = phase_b(kernel_cases(mods, probe_engine, device))
        seconds["b"] = time.perf_counter() - t0
    if "c" in phases:
        t0 = time.perf_counter()
        phase_c(mods, mtypes, labels, device, "sSVDMC", 4 * WINDOW)   # warm-up, not counted
        reset_counts()
        runs = [phase_c(mods, mtypes, labels, device, a, N_RECORDS, sync_spans=args.profile)
                for a in ("SWFDMC", "sSVDMC")]
        main_launches = ak.launches
        seconds["c"] = time.perf_counter() - t0
    if "d" in phases:
        t0 = time.perf_counter()
        phase_d(mods, mtypes, device)
        seconds["d"] = time.perf_counter() - t0

    kernels_e, huge_runs, huge_launches = {}, [], dict.fromkeys(huge_counts(), 0)
    single_seconds = {}           # single-device seconds per huge window (f, i3)
    if phases & set("efghijl"):
        t0 = time.perf_counter()
        hmods, hmtypes, hlabels = make_stream(HUGE_RECORDS, noise_rate=NOISE_RATE,
                                              binary=True, sort_by_uploaded=True,
                                              seed=SEED)
        cols, hfeats = huge_columns(hmods, device, with_features=True)
        torch.cuda.synchronize()
        print(f"[e] huge stream: {len(hlabels)} records, {int(hlabels.sum())} event rows; "
              f"first window's columns {cols.kinds}, {time.perf_counter() - t0:.1f} s",
              flush=True)
        seconds["huge_stream"] = time.perf_counter() - t0
    if "e" in phases:
        t0 = time.perf_counter()
        kernels_e = phase_e(cols, device, args.parent, args.profile, hfeats)
        seconds["e"] = time.perf_counter() - t0
    if "f" in phases:
        t0 = time.perf_counter()
        for approach in ("SWFDMC", "sSVDMC"):
            huge_runs.append(phase_f(hmods, hmtypes, hlabels, device, approach,
                                     HUGE_RECORDS))
            single_seconds[approach] = huge_runs[-1]["seconds"] / huge_runs[-1]["windows"]
            for k, v in huge_runs[-1]["launches"].items():
                huge_launches[k] += v
        postings_syncs(hmods, hmtypes, hlabels, device)
        if args.parent:
            paired_trials(args.parent)
        seconds["f"] = time.perf_counter() - t0
    if "g" in phases:
        t0 = time.perf_counter()
        phase_g(cols)
        seconds["g"] = time.perf_counter() - t0
    if "h" in phases:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()    # the huge phases' cached blocks: start as if alone
        phase_h1(mods, device)
        phase_h2()
        phase_h3(mods, mtypes, labels, device)
        phase_h4(mods, mtypes, labels)
        phase_h5(hmods)
        seconds["h"] = time.perf_counter() - t0
    kernels_i, i2_against, k1_earlier = {}, None, None
    if "i" in phases:
        t0 = time.perf_counter()
        cols = hfeats = None        # the huge window's panels: the batch needs the room
        torch.cuda.empty_cache()
        phase_i1(mods, mtypes, labels)
        seconds["i1"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        if args.parent:
            i2_against = phase_i2_against(mods, mtypes, labels, args.parent)
        else:
            phase_i2(mods, mtypes, labels)
        seconds["i2"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        for approach in ("sSpectral", "DBSCAN_centr"):
            r = phase_f(hmods, hmtypes, hlabels, device, approach, HUGE_RECORDS, tag="i3")
            single_seconds[approach] = r["seconds"] / r["windows"]
        seconds["i3"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        kernels_i = phase_i4(mods, mtypes, device, args.parent)
        if i2_against:
            k1_earlier = k1_against({WINDOW: rows_b, **kernels_i["K1_by_rows"]},
                                    i2_against["k1"])
        seconds["i4"] = time.perf_counter() - t1
        seconds["i"] = time.perf_counter() - t0
    kernels_j = {}
    if "j" in phases:
        t0 = time.perf_counter()
        if cols is None:            # phase (i) dropped the huge window's panels
            cols, hfeats = huge_columns(hmods, device, with_features=True)
        ops = huge_operands(cols, device)
        by_kind = dict(zip(cols.kinds, zip(cols.tensors, cols.valids)))
        by_post = dict(zip(cols.kinds, cols.postings_of()))
        uid, uid_valid = by_kind["username"]
        blocks = BLOCKS_PER_WINDOW
        kernels_j["K3"] = phase_j1(
            ops, {"tags": by_post["tags"], "text": by_post["text_bf16"]},
            {"colsharded SWFDMC": blocks, "colsharded sSVDMC": SSVD_SWEEPS * blocks,
             "colsharded sSpectral": SPECTRAL_SWEEPS * blocks},
            kernels_e.get("K2_per_block", {}).get("earlier_tree"))
        seconds["j1"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        phase_j2(ops, uid, uid_valid, device, {"tags": hfeats[3], "text": hfeats[4]})
        seconds["j2"] = time.perf_counter() - t1
        del ops, by_kind, uid, uid_valid
        t1 = time.perf_counter()
        j3 = phase_j3(hmods, cols, device, single_seconds)
        for run in j3["runs"].values():
            for k, v in run["launches"].items():
                huge_launches[k] += v
        seconds["j3"] = time.perf_counter() - t1
        seconds["j"] = time.perf_counter() - t0
    k_launches = 0               # K1 launches on phase (k)'s main paths
    if "k" in phases:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        k1 = phase_k1(smi)
        k_launches += k1["k1_launches"] + k1["demo"]["k1_launches"]
        seconds["k1"] = time.perf_counter() - t0
        for name, run in (("k2", lambda: phase_k2(smi, device)),
                          ("k3", lambda: phase_k3(smi)),
                          ("k4", lambda: phase_k4(mods, mtypes, labels, smi,
                                                  runs[0] if runs else None)),
                          ("k5", lambda: phase_k5(smi)),
                          ("k6", lambda: phase_k6(mods, device, smi))):
            t1 = time.perf_counter()
            out = run()
            k_launches += sum(v.get("k1_launches", 0) for v in [out, *out.values()]
                              if isinstance(v, dict))
            seconds[name] = time.perf_counter() - t1
        seconds["k"] = time.perf_counter() - t0
    if "l" in phases:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        with nccl_world_of_one() as mesh:
            phase_l1(mods, mtypes, labels, device, mesh, runs, smi)
            seconds["l1"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            if cols is None:            # phase (i) dropped the huge window's panels
                cols = huge_columns(hmods, device)
            l2 = phase_l2(hmods, hmtypes, hlabels, cols, device, mesh, single_seconds, smi)
            for run in l2["runs"].values():
                for k, v in run["launches"].items():
                    huge_launches[k] += v
            seconds["l2"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        phase_l3(smi)
        seconds["l3"] = time.perf_counter() - t1
        seconds["l"] = time.perf_counter() - t0
    m_launches = 0               # K1 launches on phase (m)'s main paths
    if "m" in phases:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        m_launches += phase_m1(mods, mtypes, labels, device, smi)["k1_launches"]
        seconds["m1"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        m_launches += phase_m2(mods, smi)["k1_launches"]
        seconds["m2"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        with nccl_world_of_one() as mesh:
            phase_m3(mods, mtypes, labels, device, mesh, smi)
        seconds["m3"] = time.perf_counter() - t1
        seconds["m"] = time.perf_counter() - t0
    if args.profile:
        t0 = time.perf_counter()
        if not phases & set("efghijl"):
            hmods, hmtypes, hlabels = make_stream(HUGE_RECORDS, noise_rate=NOISE_RATE,
                                                  binary=True, sort_by_uploaded=True,
                                                  seed=SEED)
        if "i" in phases:
            profile_k1(mods, device)
        for approach in ("SWFDMC", "sSVDMC"):
            profile_huge_window(hmods, hmtypes, hlabels, approach)
        if "l" in phases:
            with nccl_world_of_one() as mesh:
                for approach in ("SWFDMC", "sSVDMC"):
                    with contextlib.redirect_stdout(io.StringIO()):
                        row_profile = profile_row_windows(mods, mtypes, labels, device, mesh,
                                                          approach)
                    print("[profile]", json.dumps(row_profile), flush=True)
        seconds["profile"] = time.perf_counter() - t0
    print("[seconds]", json.dumps(seconds), flush=True)
    if phases != set("abcdefghijklm") or args.profile:
        return 0

    main_rows = [r for r in rows_b if r["case"] in ("location", "time", "tags", "text")]
    k2 = kernels_e["K2"]
    k2_main = [k2["tags"], k2["text"]]
    k4_main = [r for r in kernels_e["K4"] if r["on_main_path"]]
    k5_main = [r for r in kernels_e["K5"] if r["on_main_path"]]
    wps = {f"huge_{r['approach']}": r["windows_per_s"] for r in huge_runs}

    def products(rows: list, what: str) -> dict:
        """timed() with the CSR yardstick and the dense-count bound beside."""
        out = timed(rows, what)
        lib = [r["library_ms"] for r in rows]
        out.update(library_ms=None if None in lib else sum(lib),
                   library=rows[0]["library"],
                   bound_dense_ms=sum(r["bound_dense_ms"] for r in rows),
                   block_edges=rows[0]["block_edges"],
                   ms_without_usernames=sum(r["ms_without_usernames"] for r in rows))
        return out

    def timed(rows: list, what: str) -> dict:
        """ms, plain_ms and the bound of the rows' calls together."""
        ms = sum(r["ms"] for r in rows)
        ops_ms = sum(r["ops"] / r["peak_ops_per_s"] * 1e3 for r in rows)
        bytes_ms = sum(r["bytes"] / r["bytes_per_s"] * 1e3 for r in rows)
        bound_ms = sum(r["bound_ms"] for r in rows)
        return {"ms": ms, "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None, "share_of_bound": bound_ms / ms, "timed": what}

    kernels = [{
        "name": "knn_adjacency", "route": "cuda",
        "source": "mused_tpu_torch/csrc/knn_adjacency.cu",
        "replaces": "mused_tpu/ops/pallas/affinity_kernel.py:185",
        "launches": main_launches + k_launches + m_launches,
        "launches_by_phase": {"c": main_launches, "k": k_launches, "m": m_launches},
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        **timed(main_rows, "one window's four main-path calls (location, time, tags, text)"),
        "per_metric": {r["case"]: {"route": r["route"], "ms": r["ms"],
                                   "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                                   "mismatched_entries": r["mismatched_entries"]}
                       for r in rows_b},
        "e2e_windows_per_s": {r["approach"]: r["windows_per_s"] for r in runs},
        "at_dense_batch_rows": timed(kernels_i["K1"], f"the dense batch's four calls at "
                                                      f"n = {BATCH_DENSE_ROWS} (phase i4)"),
        "by_rows": {n: {r["case"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                      "share_of_bound", "mismatched_entries")}
                        for r in rows}
                    for n, rows in kernels_i["K1_by_rows"].items()},
        "row_chunks_at_dense_batch_rows": kernels_i["K1_chunks"],
        "against_earlier_tree": k1_earlier and {"k1": k1_earlier,
                                                "i2_seconds": i2_against["i2_seconds"]},
    }, {
        "name": "binned_candidates", "route": "cuda",
        "source": "mused_tpu_torch/csrc/blocked_select.cu",
        "replaces": "mused_tpu/ops/pallas/blocked_select.py:169",
        "launches": huge_launches["K2"],
        "launches_by_route": {"postings": huge_launches["K2_postings"],
                              "other": huge_launches["K2"] - huge_launches["K2_postings"]},
        "max_abs_err": max(r["max_abs_err"] for r in k2_main),
        **timed(k2_main, "one 2048-row block's two main-path calls (tags, text) on the "
                         "postings route; bound on the nonzero rule"),
        "bound_dense_ms": sum(r["bound_dense_ms"] for r in k2_main),
        "per_metric": {name: {"route": r["route"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                              "bound_ms": r["bound_ms"],
                              "bound_dense_ms": r.get("bound_dense_ms", r["bound_ms"]),
                              "splits": r["splits"], "gemm_ms": r.get("gemm_ms")}
                       for name, r in k2.items()},
        "per_block": kernels_e["K2_per_block"],
        "postings_build": {k: kernels_e["postings_build"][k]
                           for k in ("ms", "bound_ms", "share_of_bound")},
        "e2e_windows_per_s": wps,
        "at_batch_subset": {**timed(list(kernels_i["K2"].values()),
                                    f"one block's two calls (tags, text) at n = "
                                    f"{BATCH_PADDED_ROWS}, nbins = {BATCH_NBINS} (phase i4), "
                                    f"postings route"),
                            "per_block": kernels_i["K2_per_block"]},
    }, {
        "name": "binned_candidates_pair", "route": "cuda",
        "source": "mused_tpu_torch/csrc/blocked_select.cu",
        "replaces": "mused_tpu/ops/pallas/blocked_select.py:305",
        "launches": huge_launches["K3"],
        "launches_by_route": {"postings": huge_launches["K3_postings"],
                              "other": huge_launches["K3"] - huge_launches["K3_postings"]},
        "max_abs_err": max(0.0, kernels_j["K3"]["max_abs_err"]),
        **timed([kernels_e["K3"]], "one block's call (location chord3 + time l1)"),
        "bound_fma_rate_ms": kernels_e["K3"]["bound_fma_rate_ms"],
        "per_pair": {
            "chord3+l1": {"route": "coordinate", "ms": kernels_e["K3"]["ms"],
                          "plain_ms": kernels_e["K3"]["plain_ms"],
                          "bound_ms": kernels_e["K3"]["bound_ms"]},
            "jaccard+dot": {k: kernels_j["K3"].get(k) for k in
                            ("route", "ms", "two_k2_ms", "tensor_core_pair_ms",
                             "earlier_tree_ms", "plain_ms", "bound_ms", "bound_by",
                             "share_of_bound", "bound_dense_ms", "max_abs_err")}},
        "at_batch_subset": {**timed([kernels_i["K3"]], f"one block's call at n = "
                                                       f"{BATCH_PADDED_ROWS}, nbins = "
                                                       f"{BATCH_NBINS} (phase i4)"),
                            "tags+text": kernels_i["K3_tags_text"]},
    }, {
        "name": "matvec_t", "route": "cuda",
        "source": "mused_tpu_torch/csrc/cand_matvec.cu",
        "replaces": "mused_tpu/ops/pallas/cand_matvec.py:176",
        "launches": huge_launches["K4"],
        "max_abs_err": max(r["probe_max_abs_err"] for r in k4_main),
        **products(k4_main, "one block's two fold calls (r = 66 probe, r = 132 hi/lo), "
                            "with the block's lists built"),
        "padded_rows_ms": {r["r"]: r["ms"] for r in kernels_e["K4"] if not r["on_main_path"]},
    }, {
        "name": "matvec", "route": "cuda",
        "source": "mused_tpu_torch/csrc/cand_matvec.cu",
        "replaces": "mused_tpu/ops/pallas/cand_matvec.py:219",
        "launches": huge_launches["K5"],
        "max_abs_err": max(r["probe_max_abs_err"] for r in k5_main),
        **products(k5_main, "one block's fold call (r = 66), with the block's lists built"),
        "padded_cols_ms": {r["r"]: r["ms"] for r in kernels_e["K5"] if not r["on_main_path"]},
    }, {
        "name": "cand_lists", "route": "cuda",
        "source": "mused_tpu_torch/csrc/cand_matvec.cu",
        "replaces": "mused_tpu/ops/pallas/cand_matvec.py:99 (_mask_tile, the tile rebuild "
                    "K4 and K5 share)",
        "launches": huge_launches["lists"],
        "max_abs_err": kernels_e["lists"]["max_abs_err"],
        "mismatched_entries": kernels_e["lists"]["mismatched_entries"],
        **timed([kernels_e["lists"]], "one block's list build (shared by its three "
                                      "fold products)"),
        "with_products": timed([kernels_e["lists"]] + k4_main + k5_main,
                               "one block's list build and its three fold products: the "
                               "slabs read once, by the list build"),
    }, {
        "name": "union_rowblock", "route": "cuda",
        "source": "mused_tpu_torch/csrc/blocked_select.cu",
        "replaces": "no TPU kernel: the plain union of fused_rowblock "
                    "(mused_tpu/ops/blocked_affinity.py)",
        "launches": sum(r["union_launches"] for r in huge_runs),
        "bit_equal": kernels_e["union"]["bit_equal"] and kernels_i["union"]["bit_equal"],
        **timed([kernels_e["union"]], "one 2048-row block's f32 rows from its candidates"),
        "at_batch_subset": timed([kernels_i["union"]], f"the same at n = {BATCH_PADDED_ROWS}, "
                                                       f"nbins = {BATCH_NBINS} (phase i4)"),
    }]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on their main path: {missing}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
