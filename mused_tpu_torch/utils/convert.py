"""Carry stream state across from the JAX package.

``stream_state_from_jax`` takes a ``mused_tpu`` ``StreamState`` whose leaves
were pulled to numpy (``jax.tree_util.tree_map(np.asarray, state)``) and
builds the port's ``StreamState`` on ``device``, so a stream started in the
JAX package continues here.  It reads fields by name and never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from mused_tpu_torch.engine.streaming import StreamState
from mused_tpu_torch.ops import fd, kmeans, swfd


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


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
                          seal_cursor=int(s.seal_cursor))
    mb = kmeans.MiniBatchState(centroids=_t(m.centroids, device).float(),
                               counts=_t(m.counts, device).float(),
                               initialized=bool(m.initialized))
    return StreamState(swfd=ring, minibatch=mb)
