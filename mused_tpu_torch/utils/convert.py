"""Carry state across from the JAX package.

Each function takes a ``mused_tpu`` structure whose leaves were pulled to
numpy (``jax.tree_util.tree_map(np.asarray, x)``) and builds the port's
counterpart on ``device``.  They read fields by name and never import JAX:

  stream_state_from_jax  ``StreamState``: a stream continues here
  engine_state_from_jax  a ``StreamingEngine``'s state and host snapshot
  columns_from_jax       huge-window ``blocked_affinity.Columns``
  cand_block_from_jax    a candidate-form block, ``cand_matvec.CandBlock``

JAX bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they cross as their uint16 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from mused_tpu_torch.engine.streaming import StreamState
from mused_tpu_torch.ops import blocked_affinity as ba, fd, kmeans, swfd
from mused_tpu_torch.ops.kernels import cand_matvec as cm


def _t(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: cross as the raw bits
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def columns_from_jax(cols, device) -> ba.Columns:
    """JAX ``blocked_affinity.Columns`` (numpy leaves) -> the port's."""
    def leaf(x):
        return tuple(_t(y, device) for y in x) if isinstance(x, tuple) else _t(x, device)
    return ba.Columns(kinds=tuple(str(k) for k in cols.kinds),
                      tensors=tuple(leaf(x) for x in cols.tensors),
                      valids=tuple(_t(v, device) for v in cols.valids),
                      idf=None if cols.idf is None else _t(cols.idf, device))


def cand_block_from_jax(cand, device) -> cm.CandBlock:
    """JAX ``cand_matvec.CandBlock`` (numpy leaves) -> the port's."""
    return cm.CandBlock(
        slabs=_t(cand.slabs, device),
        uid_rows=None if cand.uid_rows is None else _t(cand.uid_rows, device),
        uid_cols=_t(cand.uid_cols, device), start=int(cand.start), g0=int(cand.g0))


def stream_state_from_jax(tree_of_numpy, device) -> StreamState:
    """JAX StreamState (numpy leaves) -> the port's StreamState on ``device``."""
    s, a, m = tree_of_numpy.swfd, tree_of_numpy.swfd.active, tree_of_numpy.minibatch
    active = fd.FDState(sketch=_t(a.sketch, device).float(),
                        sq_frobenius=_t(a.sq_frobenius, device).float(),
                        shrink_loss=_t(a.shrink_loss, device).float(),
                        count=_t(a.count, device).to(torch.int32))
    ring = swfd.SWFDState(blocks=_t(s.blocks, device).float(),
                          block_end=_t(s.block_end, device).to(torch.int32),
                          block_sqfro=_t(s.block_sqfro, device).float(),
                          block_loss=_t(s.block_loss, device).float(),
                          active=active, count=int(s.count),
                          seal_cursor=int(s.seal_cursor), active_rows=int(a.count))
    mb = kmeans.MiniBatchState(centroids=_t(m.centroids, device).float(),
                               counts=_t(m.counts, device).float(),
                               initialized=bool(m.initialized))
    return StreamState(swfd=ring, minibatch=mb)


def engine_state_from_jax(state_np, host_snapshot: dict, device) -> tuple:
    """A JAX ``StreamingEngine``'s ``state`` (numpy leaves) and
    ``host_snapshot()`` -> ``(StreamState, host dict)`` for the port's
    ``StreamingEngine.restore``.  The host dict's values are numpy and Python
    (the incremental clusterer's and the centroid matcher's snapshots have
    the same layout in both packages)."""
    host = dict(host_snapshot)
    if host.get("swfd_R") is not None:
        host["swfd_R"] = float(host["swfd_R"])
    return stream_state_from_jax(state_np, device), host
