"""Window-boundary checkpoint / resume — port of ``mused_tpu/utils/checkpoint.py``
in a format that needs no JAX.

The reference has no checkpointing (SURVEY.md §5.4).  Everything the engine
carries across windows is a fixed set of named tensors, so a checkpoint is
one npz file:

  * device state: every leaf of the ``StreamState`` named tuples, keyed by
    its field path (``swfd.blocks``, ``swfd.active.sketch``,
    ``minibatch.initialized``, ...); the Python-int and bool fields
    (``swfd.count``, ``swfd.seal_cursor``, ``minibatch.initialized``) as 0-d
    arrays;
  * host state: one pickled dict (stream cursor, previous clusters,
    accumulated labels, the incremental clusterer's points, ...).

The write is atomic (tmp + rename), so a crash mid-checkpoint leaves the
previous checkpoint intact.  The JAX package's files pickle a JAX treedef
and are not read here.

TRUST MODEL: the host dict is a pickle, so ``load_checkpoint`` runs code
embedded in the file — load only checkpoints this process (or an equally
trusted one) wrote.  ``process_streaming_data(checkpoint_dir=...)`` resumes
from the newest file in that directory: point it only at directories with
the job's own write trust.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

_HOST = "__host__"


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_state(state, prefix: str = "") -> dict[str, np.ndarray]:
    """{field path: numpy leaf} of a tree of named tuples."""
    out = {}
    for name, value in zip(state._fields, state):
        key = f"{prefix}{name}"
        if _is_record(value):
            out.update(flatten_state(value, key + "."))
        elif isinstance(value, torch.Tensor):
            out[key] = value.detach().cpu().numpy()
        else:                           # Python int / bool ring counters
            out[key] = np.asarray(value)
    return out


def unflatten_like(template, leaves: dict, prefix: str = ""):
    """Rebuild ``template``'s named-tuple tree from ``leaves``: tensors land on
    the device of the template's tensor at the same path, with its dtype;
    Python ints and bools come back as such."""
    fields = {}
    for name, value in zip(template._fields, template):
        key = f"{prefix}{name}"
        if _is_record(value):
            fields[name] = unflatten_like(value, leaves, key + ".")
            continue
        if key not in leaves:
            raise ValueError(f"checkpoint has no leaf {key!r}: its state schema "
                             "differs from this engine's")
        leaf = leaves[key]
        if isinstance(value, torch.Tensor):
            if tuple(leaf.shape) != tuple(value.shape):
                raise ValueError(f"checkpoint leaf {key!r} has shape {leaf.shape}, "
                                 f"this engine's {tuple(value.shape)}")
            fields[name] = torch.from_numpy(np.array(leaf)).to(
                device=value.device, dtype=value.dtype)
        elif isinstance(value, bool):
            fields[name] = bool(leaf)
        else:
            fields[name] = int(leaf)
    return type(template)(**fields)


def save_checkpoint(path: str, device_state, host_state: dict) -> str:
    """Serialize (named-tuple device state, picklable host dict) atomically."""
    payload = flatten_state(device_state)
    payload[_HOST] = np.frombuffer(pickle.dumps(host_state), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **payload)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, like=None):
    """Returns (device state, host dict).  With ``like`` (a state of the
    same schema, e.g. the engine's own) the leaves are rebuilt into it on
    its device; without, the device state is the flat {field path: array}
    dict, for :func:`unflatten_like` once the engine exists."""
    with np.load(path, allow_pickle=False) as z:
        host = pickle.loads(z[_HOST].tobytes())
        leaves = {k: z[k] for k in z.files if k != _HOST}
    return (leaves if like is None else unflatten_like(like, leaves)), host


def latest_checkpoint(ckpt_dir: str, prefix: str = "stream") -> str | None:
    """Newest ``<prefix>_<window>.npz`` in ``ckpt_dir``; other names (a
    serving ``save()`` may write any path) are ignored."""
    if not os.path.isdir(ckpt_dir):
        return None

    def widx(f):
        tail = f.rsplit("_", 1)[-1][:-4]
        return int(tail) if tail.isdigit() else None

    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith(prefix) and f.endswith(".npz") and widx(f) is not None]
    if not cands:
        return None
    cands.sort(key=widx)
    return os.path.join(ckpt_dir, cands[-1])


def checkpoint_name(ckpt_dir: str, window_index: int, prefix: str = "stream") -> str:
    return os.path.join(ckpt_dir, f"{prefix}_{window_index:08d}.npz")
