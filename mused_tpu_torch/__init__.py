"""mused_tpu_torch — the PyTorch + CUDA port of mused_tpu for NVIDIA Hopper.

The JAX package ``mused_tpu`` stays beside this one as the reference; every
module here mirrors its counterpart's name so a reader finds it there.  The
port imports ``torch`` and never ``jax``.  It reuses the framework-free host
tier of ``mused_tpu`` (``utils/config``, ``data/features``, ``native/``,
``ops/matching``, ``utils/metrics``) instead of copying it.

Layer map (slice 1, dense windows; slice 3, huge windows on one device):
  api.py       reference-compatible facade (process_streaming_data)
  engine/      streaming engine: featurize -> fuse -> reduce -> cluster -> match;
               huge windows rebuild row blocks inside the reduction
  ops/         affinity graphs, FD / SWFD sketch, randomized SVD, k-means,
               blocked_affinity (column panels, rebuilt blocks, blocked
               FD fold and SVD)
  ops/kernels/ hand-written Hopper kernels (CUDA C++ in csrc/: K1 kNN
               adjacency, K2 / K3 binned candidates, K4 / K5 candidate
               products), their plain versions and their build
  data/        numpy synthetic stream, threaded host->device prefetch
  utils/       span timer, JAX-state conversion

Every function takes its ``device`` explicitly or from its input tensors;
nothing here guesses a device or falls back from CUDA to the CPU.
"""

__version__ = "0.1.0"
