"""mused_tpu_torch — the PyTorch + CUDA port of mused_tpu for NVIDIA Hopper.

The JAX package ``mused_tpu`` stays beside this one as the reference; every
module here mirrors its counterpart's name so a reader finds it there.  The
port imports ``torch`` and nothing of ``jax`` or ``mused_tpu``: it keeps its
own copies of the host tier it needs (``utils/config``, ``data/features``,
``native/`` (the C++ hasher and incremental-DBSCAN core, built at first
use), ``ops/matching``, ``utils/metrics``), each naming its original.

Layer map (slice 1 and 2, dense windows and the batch engine; slice 3, huge
windows on one device):
  api.py       reference-compatible facade (process_streaming_data,
               process_batch_data, the DBSCAN functions, StreamDetector)
  serving.py   StreamDetector: pushed records -> per-window events, without
               labels; save / load
  engine/      streaming engine: featurize -> fuse -> reduce -> cluster ->
               match, as dispatch + finalize; host snapshot / restore;
               huge windows rebuild row blocks inside the reduction; the
               batch engine (one pass over a whole subset, dense or blocked)
  ops/         affinity graphs, FD / SWFD sketch, randomized SVD, k-means and
               the background bucket, spectral clustering, the DBSCAN family,
               blocked_affinity (column panels, rebuilt blocks, blocked FD
               fold and SVD), blocked spectral, blocked DBSCAN and the
               Borůvka HDBSCAN
  ops/kernels/ hand-written Hopper kernels (CUDA C++ in csrc/: K1 kNN
               adjacency, K2 / K3 binned candidates, K4 / K5 candidate
               products), their plain versions and their build
  data/        host featurization, numpy synthetic streams (SED-like,
               crisis embeddings), threaded host->device prefetch
  native/      the C++ token / tag hasher (Python fallbacks in data/) and
               the incremental-DBSCAN union-find (device fallback in ops/)
  utils/       config, metrics, span timer, checkpoints (npz, no JAX),
               JAX-state conversion

Entry points (``process_streaming_data``, ``process_batch_data``, ``StreamingEngine``,
``StreamDetector``, ``dbscan`` / ``hdbscan`` / ``IncrementalDBSCAN``) run on
the card unless the caller passes ``device="cpu"``; other functions take
their device from their input tensors.  Nothing falls back from CUDA to the
CPU.
"""

__version__ = "0.1.0"
