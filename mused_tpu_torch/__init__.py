"""mused_tpu_torch — the PyTorch + CUDA port of mused_tpu for NVIDIA Hopper.

The JAX package ``mused_tpu`` stays beside this one as the reference; every
module here mirrors its counterpart's name so a reader finds it there.  The
port imports ``torch`` and nothing of ``jax`` or ``mused_tpu``: it keeps its
own copies of the host tier it needs (``utils/config``, ``data/features``,
``native/`` (the C++ hasher, built at first use), ``ops/matching``,
``utils/metrics``), each naming its original.

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
  data/        host featurization, numpy synthetic stream, threaded
               host->device prefetch
  native/      the C++ token / tag hasher (ctypes; Python fallbacks in data/)
  utils/       config, metrics, span timer, JAX-state conversion

Entry points (``process_streaming_data``, ``StreamingEngine``) run on the
card unless the caller passes ``device="cpu"``; other functions take their
device from their input tensors.  Nothing falls back from CUDA to the CPU.
"""

__version__ = "0.1.0"
