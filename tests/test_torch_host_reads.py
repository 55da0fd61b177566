"""The port's host waits that the JAX package does not have, repaired:

  * the default ``SpanTimer`` never calls ``torch.cuda.synchronize``, even
    on a CUDA device and while its spans are recorded
    (``utils/profiling``); ``sync_all=True`` synchronizes at every span end;
  * Lloyd's loop (``ops/kmeans.kmeans``) reads the device, through
    ``Tensor.__bool__``, at most ceil(steps / m) times for m =
    ``CHECK_EVERY`` in {4, 8, 16}, where steps is the number of steps the
    JAX ``while_loop`` runs, and its labels and centroids are bit-equal to
    ``mused_tpu.ops.kmeans.kmeans`` (its k-means++ centres injected) and to
    the loop as it was (``torch_parity.reference_lloyd``).  The fixtures
    hold small integers, so every sum is exact in any order: a converging
    case, one whose k-means++ seeding leaves a live cluster empty (the
    relocation), and one that stops at ``max_iters``.
``parallel/kmeans_sharded`` is held to the same rules on 4 ranks in
``test_torch_sharded.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.ops import kmeans as jkm
from mused_tpu_torch.engine import streaming as ts
from mused_tpu_torch.ops import kmeans as tkm
from mused_tpu_torch.utils.config import PipelineConfig
from mused_tpu_torch.utils import profiling
from mused_tpu_torch.utils.profiling import SpanTimer
from torch_parity import integer_kmeans_case, reference_lloyd


def test_default_span_timer_never_synchronizes(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    timer = SpanTimer("cuda")
    for name in ("fuse", "device_step", "device_sync"):
        with timer.span(name):
            pass
    profiling.clear()
    with profiling.recording():
        for name in ("fuse", "reduce"):
            with timer.span(name):
                pass
    assert [r.name for r in profiling.recorded()] == ["fuse", "reduce"]
    profiling.clear()
    assert calls == []
    assert {k: v["count"] for k, v in timer.summary().items()} == {
        "fuse": 2, "device_step": 1, "device_sync": 1, "reduce": 1}
    assert not ts.StreamingEngine(PipelineConfig(window_size=64), "cpu").timer.sync_all
    opted_in = SpanTimer("cuda", sync_all=True)
    with opted_in.span("fuse"):
        pass
    assert len(calls) == 1


@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("name", ["converges", "empty_cluster", "max_iters"])
def test_lloyd_reads_the_host_once_per_m_steps(name, m, monkeypatch):
    x, k, k_max, key, max_iters, tol = integer_kmeans_case(name)
    init = np.array(jkm._kmeanspp_init(jnp.asarray(x), k_max, jnp.int32(k), key))
    want_labels, want_cents = jkm.kmeans(jnp.asarray(x), jnp.int32(k), key, k_max=k_max,
                                         max_iters=max_iters, tol=tol)
    ref_labels, ref_cents, steps = reference_lloyd(x, k, init, k_max=k_max,
                                                   max_iters=max_iters, tol=tol)
    if name == "empty_cluster":
        assert len(np.unique(np.argmin(((x[:, None] - init[None, :k]) ** 2).sum(-1), 1))) < k
    if name == "max_iters":
        assert steps == max_iters
    reads = []
    orig_bool = torch.Tensor.__bool__
    monkeypatch.setattr(tkm, "CHECK_EVERY", m)
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append(1) or orig_bool(t))
    labels, cents = tkm.kmeans(torch.from_numpy(x), k, None, k_max=k_max, max_iters=max_iters,
                               tol=tol, init=torch.from_numpy(init))
    monkeypatch.undo()
    assert len(reads) <= math.ceil(steps / m), (len(reads), steps)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    np.testing.assert_array_equal(cents.numpy(), np.asarray(want_cents))
    np.testing.assert_array_equal(labels.numpy(), ref_labels.numpy())
    np.testing.assert_array_equal(cents.numpy(), ref_cents.numpy())


def test_lloyd_is_bit_equal_to_the_loop_as_it_was_on_float_blobs():
    """Gaussian blobs (inexact sums) and a far centre no point takes: the
    repaired loop computes the same floats as the loop with host reads."""
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(3, 5)) * 6
    x = np.concatenate([c + rng.normal(size=(40, 5)) for c in centers]).astype(np.float32)
    for init in (x[[0, 50, 100, 7]], np.concatenate([x[[0, 50, 100]], [[1e3] * 5]])):
        init = np.asarray(init, np.float32)
        want = reference_lloyd(x, 4, init, k_max=4)
        got = tkm.kmeans(torch.from_numpy(x), 4, None, k_max=4, init=torch.from_numpy(init))
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
