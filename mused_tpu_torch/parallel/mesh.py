"""Device mesh and named-axis collectives — counterpart of
``mused_tpu/parallel/mesh.py``.

Axes (the JAX package's vocabulary):
  "data"   window rows: a rank's column shard on a (p, 1) mesh, its group of
           row blocks on a (pd, pm) grid
  "model"  the grid's column shards

The port runs SPMD: one process per device, each running the same program
on its shard.  The caller sets up torch.distributed's default process group
(``torchrun --nproc-per-node p``, or ``init_process_group`` with an address,
the world size and the rank); :func:`make_mesh` lays that group out as the
(data, model) mesh and raises when there is none, or when its size is not
the mesh's.  :class:`Axis` carries the collectives the sharded code calls
where the JAX package calls ``lax.psum`` / ``pmax`` / ``pmin`` /
``all_gather`` / ``ppermute`` / ``axis_index`` inside ``shard_map``.

Shared files (checkpoints, logs, plots) have one writer: :func:`is_writer`
is rank 0 of the default process group (or the only process).  A file that
ranks read back is written through :func:`write_once`: the writer writes,
and every rank leaves only once the write is done, or raises with it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

AXES = ("data", "model")
_WIDEN = (torch.bool, torch.int8, torch.uint8, torch.int16)   # moved as int32 (gloo)


def make_mesh(n_data: int | None = None, n_model: int = 1, device_type: str | None = None):
    """A (n_data, n_model) ``DeviceMesh`` named ("data", "model") over the
    default process group; rank r sits at (r // n_model, r % n_model), as
    the JAX package reshapes its device list.  ``device_type`` defaults to
    "cuda" under NCCL, else "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs torch.distributed's default process group, one rank "
            "per device: start the ranks with torchrun, or call "
            "torch.distributed.init_process_group with an address, the world size and "
            "the rank first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; "
                         f"the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


def _group_size() -> int:
    """World size of the default process group; 0 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def is_writer() -> bool:
    """Whether this process writes files every rank would write alike: rank 0
    of the default process group, or a process without one."""
    return _group_size() == 0 or dist.get_rank() == 0


def write_once(write, spmd: bool = True) -> None:
    """Call ``write()`` (a file every rank would write alike) on the writer
    only, then let every rank of the default process group go on together.
    If the write raises, it raises on every rank (the writer's own error
    there, a RuntimeError naming it elsewhere), so no rank waits for a
    write that failed.  ``spmd=False`` (a process that runs alone, whatever
    group it is in) just writes."""
    if not spmd or _group_size() <= 1:
        write()
        return
    err = None
    if is_writer():
        try:
            write()
        except Exception as e:      # noqa: BLE001 (re-raised below, on every rank)
            err = e
    verdict = [None if err is None else f"{type(err).__name__}: {err}"]
    dist.broadcast_object_list(verdict, src=0)
    if err is not None:
        raise err
    if verdict[0] is not None:
        raise RuntimeError(f"rank 0 failed to write a shared file: {verdict[0]}")


def mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh) -> torch.device:
    """This rank's device of the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Axis(NamedTuple):
    """One named axis of a mesh, from this rank's point of view."""

    mesh: object
    name: str

    @property
    def group(self):
        return self.mesh.get_group(self.name)

    @property
    def size(self) -> int:
        return mesh_shape(self.mesh)[self.name]

    @property
    def index(self) -> int:
        """This rank's position along the axis (JAX's ``axis_index``)."""
        return self.mesh.get_local_rank(self.name)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = (x.to(torch.int32) if x.dtype in _WIDEN else x).clone(
            memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.dtype)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's ``x`` along the axis, in axis order."""
        y = (x.to(torch.int32) if x.dtype in _WIDEN else x).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.group)
        return torch.stack(parts).to(x.dtype)

    def share(self, n: int) -> slice:
        """This rank's contiguous share of ``range(n)`` split evenly along the
        axis (position i owns [i·n/size, (i+1)·n/size))."""
        if n % self.size:
            raise ValueError(f"{n} does not split evenly over the {self.size} ranks of "
                             f"axis {self.name!r}")
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """The ``x`` of the rank ``shift`` positions back along the axis: each
        position i sends to i + shift and receives from i - shift (mod size),
        JAX's ``lax.ppermute`` with perm i -> i + shift.  The sends and
        receives post together (``batch_isend_irecv``), so no rank blocks in a
        send that nobody receives yet."""
        size = self.size
        if shift % size == 0:
            return x.clone()
        y = (x.to(torch.int32) if x.dtype in _WIDEN else x).contiguous()
        out = torch.empty_like(y)
        to = dist.get_global_rank(self.group, (self.index + shift) % size)
        frm = dist.get_global_rank(self.group, (self.index - shift) % size)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, y, to, self.group),
                                       dist.P2POp(dist.irecv, out, frm, self.group)])
        for req in reqs:
            req.wait()
        return out.to(x.dtype)

    def broadcast(self, buf: torch.Tensor, owner: int) -> torch.Tensor:
        """Overwrite the contiguous ``buf`` on every rank of the axis with
        the one at position ``owner``, in place (a copy: exact for every
        type); returns ``buf``."""
        view = buf.view(torch.uint8) if buf.dtype == torch.bool else buf
        dist.broadcast(view, src=dist.get_global_rank(self.group, owner), group=self.group)
        return buf
