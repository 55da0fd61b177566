"""mused_tpu_torch — the PyTorch + CUDA port of mused_tpu for NVIDIA Hopper.

The JAX package ``mused_tpu`` stays beside this one as the reference; every
module here mirrors its counterpart's name so a reader finds it there.  The
port imports ``torch`` and nothing of ``jax`` or ``mused_tpu``: it keeps its
own copies of the host tier it needs (``utils/config``, ``data/features``,
``native/`` (the C++ hasher, incremental-DBSCAN core and SED2012 scanner,
built at first use), ``ops/matching``, ``utils/metrics``, ``utils/output``,
``utils/tee``), each naming its original.

Layer map (slices 1-4 and the scanned multi-window dispatch: everything
the JAX package does):
  main.py      the CLI sweep driver (``python -m mused_tpu_torch.main``)
  api.py       reference-compatible facade: every name of ``mused_tpu/api.py``
               (the engines, the loaders, SeqBasedSWFD, the reference's
               matrix operations) and StreamDetector
  serving.py   StreamDetector: pushed records -> per-window events, without
               labels; save / load
  engine/      streaming engine: featurize -> fuse -> reduce -> cluster ->
               match, as dispatch + finalize; host snapshot / restore;
               huge windows rebuild row blocks inside the reduction; the
               batch engine (one pass over a whole subset, dense or blocked)
  ops/         affinity graphs, FD (eigh, Newton-Schulz, Rayleigh-Ritz
               shrinks) / SWFD sketch (row-granular and per window),
               randomized SVD, k-means and the background bucket, spectral
               clustering, the DBSCAN family, cross-window matching (overlap
               and centroid registry),
               blocked_affinity (column panels, rebuilt blocks, blocked FD
               fold and SVD), blocked spectral, blocked DBSCAN and the
               Borůvka HDBSCAN
  ops/kernels/ hand-written Hopper kernels (CUDA C++ in csrc/: K1 kNN
               adjacency, K2 / K3 binned candidates, K4 / K5 candidate
               products), their plain versions and their build
  parallel/    named-axis mesh over torch.distributed, the row-sharded
               layouts (dense window step, huge-window row blocks, FD sketch
               merges, row-sharded k-means), the column-sharded huge-window
               layouts, the parallel sweep
  data/        host featurization, the SED2012 loader (no pandas), numpy
               synthetic streams (SED-like, sketch benchmark, crisis
               embeddings), threaded host->device prefetch
  native/      the C++ token / tag hasher (Python fallbacks in data/), the
               incremental-DBSCAN union-find (device fallback in ops/) and the
               SED2012 scanner (iterparse fallback in data/)
  utils/       config, metrics, span timer, output (logs, tables, plots),
               tee, checkpoints (npz, no JAX), JAX-state conversion

Entry points (``process_streaming_data``, ``process_batch_data``, ``StreamingEngine``,
``StreamDetector``, ``SeqBasedSWFD``, ``dbscan`` / ``hdbscan`` /
``IncrementalDBSCAN``, the API's matrix operations, the CLI) run on the card
unless the caller passes ``device="cpu"``; other functions take
their device from their input tensors.  Nothing falls back from CUDA to the
CPU.
"""

__version__ = "0.1.0"
