"""FD sketch merging across ranks — port of ``mused_tpu/parallel/sketch_merge.py``.

Frequent Directions sketches are mergeable: FD(concat(A1, A2)) is
approximated by FD(stack(B1, B2)) with additive error, so per-rank sketches
combine with collectives instead of shipping raw rows.  Two topologies:

  * :func:`allgather_merge` — one all-gather of the (ell, d) sketches, then
    one local shrink of the (p·ell, d) stack; every rank computes the same
    merged sketch.
  * :func:`ring_merge`      — p - 1 hops of ``Axis.ppermute``, each followed
    by a shrink of [acc; received]; peak memory 2·ell × d.  Every rank ends
    with an FD sketch of the union of all ranks' rows, each its own.

Plus :func:`global_max_row_norm` (the max over the ranks, replacing the
host computation of R at reference main.py:61) and :func:`distributed_fd`,
the whole row-sharded sketching step.  The JAX package returns chip 0's
copy of a merge (``sketch_merge.py:96-98``); under ``ring`` the ranks' copies
differ, so :func:`rank0_copy` broadcasts position 0's wherever a replicated
result is needed.  Every function runs on each rank of the axis (SPMD).
"""
from __future__ import annotations

import torch

from mused_tpu_torch.ops import fd
from mused_tpu_torch.parallel.mesh import Axis


def merge_stacked(sketches: torch.Tensor, out_ell: int):
    """(p, ell, d) stacked sketches -> ((out_ell, d) merged sketch, shrink
    delta): ``fd.shrink``'s pair, not the bare sketch."""
    p, ell, d = sketches.shape
    return fd.shrink(sketches.reshape(p * ell, d), out_ell)


def allgather_merge(local_sketch: torch.Tensor, out_ell: int, axis: Axis) -> torch.Tensor:
    """Gather every rank's (ell, d) sketch and shrink the stack locally: the
    same merged sketch on every rank."""
    merged, _ = merge_stacked(axis.all_gather(local_sketch), out_ell)
    return merged


def ring_merge(local_sketch: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Rotate sketches p - 1 hops around the ring, shrinking after each
    receive: each rank ends with an FD sketch of every rank's rows."""
    ell = local_sketch.shape[0]
    acc = inflight = local_sketch
    for _ in range(axis.size - 1):
        inflight = axis.ppermute(inflight)
        acc, _ = fd.shrink(torch.cat([acc, inflight], dim=0), ell)
    return acc


def merge(local_sketch: torch.Tensor, out_ell: int, axis: Axis,
          topology: str = "allgather") -> torch.Tensor:
    """The merged sketch by ``topology`` ("allgather" or "ring"), position
    0's copy on every rank."""
    if topology == "ring":
        return rank0_copy(ring_merge(local_sketch, axis), axis)
    if topology != "allgather":
        raise ValueError(f"merge_topology={topology!r}: expected 'allgather' or 'ring'")
    return allgather_merge(local_sketch, out_ell, axis)


def rank0_copy(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Position 0's ``x`` on every rank of the axis (a copy: exact)."""
    return axis.broadcast(x.contiguous().clone(), 0)


def global_max_row_norm(rows: torch.Tensor, axis: Axis) -> torch.Tensor:
    """R = the largest squared row norm over every rank's rows (reference
    main.py:61, a max over the axis instead of a host reduction)."""
    return axis.pmax(torch.max(torch.sum(rows * rows, dim=1)))


def distributed_fd(rows: torch.Tensor, *, ell: int, mesh,
                   topology: str = "allgather") -> torch.Tensor:
    """Row-sharded FD sketch of (n, d) ``rows`` over the mesh's "data" axis;
    every rank passes the rows whole and folds its contiguous share (the
    eigh shrink in blocks of ell, ``fd.update_stream``'s default), then the
    sketches merge.  Returns position 0's (ell, d) merged sketch on every
    rank."""
    axis = Axis(mesh, "data")
    shard = rows[axis.share(rows.shape[0])]
    st = fd.update_stream(fd.init(ell, rows.shape[1], rows.device), shard)
    return merge(st.sketch, ell, axis, topology)
