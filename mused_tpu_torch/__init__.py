"""mused_tpu_torch — the PyTorch + CUDA port of mused_tpu for NVIDIA Hopper.

The JAX package ``mused_tpu`` stays beside this one as the reference; every
module here mirrors its counterpart's name so a reader finds it there.  The
port imports ``torch`` and never ``jax``.  It reuses the framework-free host
tier of ``mused_tpu`` (``utils/config``, ``data/features``, ``native/``,
``ops/matching``, ``utils/metrics``) instead of copying it.

Layer map (slice 1, the dense-window streaming path):
  api.py       reference-compatible facade (process_streaming_data)
  engine/      streaming engine: featurize -> fuse -> reduce -> cluster -> match
  ops/         affinity graphs, FD / SWFD sketch, randomized SVD, k-means
  ops/kernels/ hand-written Hopper kernels (CUDA C++ in csrc/) and their build
  data/        numpy synthetic stream, threaded host->device prefetch
  utils/       span timer, JAX-state conversion

Every function takes its ``device`` explicitly or from its input tensors;
nothing here guesses a device or falls back from CUDA to the CPU.
"""

__version__ = "0.1.0"
