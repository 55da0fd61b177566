"""The hand-written kernel against its plain version on a CUDA device.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bit-equal for l1 and jaccard (exact integer or unfused sums);
the same edges up to float summation order for dot, euclidean and chord3
(>= 99.9% of edges, identical row degrees).
"""
import numpy as np
import pytest
import torch

from mused_tpu_torch.ops.kernels import affinity_kernel as ak

METRICS = ["dot", "euclidean", "jaccard", "l1", "chord3"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(metric, rows=300, seed=0):
    rng = np.random.default_rng(seed)
    if metric == "l1":
        x = rng.uniform(1e6, 2e6, size=(rows, 2))
    elif metric == "jaccard":
        x = (rng.random((rows, 64)) < 0.08).astype(np.float64)
        x[5] = 0.0
    elif metric == "chord3":
        ll = torch.from_numpy(rng.uniform([-80, -170], [80, 170], size=(rows, 2)))
        x = ak.location_to_unit_xyz(ll.float()).numpy()
    else:
        x = rng.normal(size=(rows, 24))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    valid = np.ones(rows, bool)
    valid[[3, 11, 40]] = False
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)), torch.from_numpy(valid)


def _assert_agrees(got, want, metric):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if metric in ("l1", "jaccard"):
        np.testing.assert_array_equal(got, want)
    else:
        assert (got != want).sum() <= 0.001 * want.sum()
        np.testing.assert_array_equal(got.sum(1), want.sum(1))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_matches_plain_on_cuda(metric, cuda):
    x, valid = _inputs(metric)
    x, valid = x.to(cuda), valid.to(cuda)
    before = ak.launches
    got = ak.knn_adjacency(x, valid, 7, metric)
    want = ak.knn_adjacency_reference(x, valid, 7, metric)
    torch.cuda.synchronize()
    assert ak.launches == before + 1
    _assert_agrees(got, want, metric)


@pytest.mark.cuda
def test_kernel_duplicates_emit_exactly_k_on_cuda(cuda):
    x, _ = _inputs("dot", rows=200)
    x[10:50] = x[10]                        # 40 exact duplicates
    valid = torch.ones(200, dtype=torch.bool)
    got = ak.knn_adjacency(x.to(cuda), valid.to(cuda), 5, "dot").cpu()
    want = ak.knn_adjacency_reference(x, valid, 5, "dot")
    assert (got.sum(1) == 5).all()
    _assert_agrees(got, want, "dot")


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError):
        ak.knn_adjacency(x, torch.ones(8, dtype=torch.bool), 2, "dot")   # valid on cpu
    with pytest.raises(ValueError):
        ak.knn_adjacency(x.T, torch.ones(3, dtype=torch.bool, device=cuda), 2, "dot")
