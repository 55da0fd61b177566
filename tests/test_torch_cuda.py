"""The hand-written kernels against their plain version on a CUDA device.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bit-equal for l1 and jaccard (exact integer or unfused sums);
the same edges up to float summation order for dot, euclidean and chord3
(>= 99.9% of edges, identical row degrees).  The tensor-core route's row
chunks are bit-equal to one chunk: a mirrored tile adds the same products
in the same order as its transpose.  At the dense batch's shapes (8,193 to
32,768 rows) every metric is held bit-equal, on inputs whose products and
sums are exact in float32 for dot and euclidean (small integers), so the
select alone decides the edges.
"""
import numpy as np
import pytest
import torch

from mused_tpu_torch.ops.kernels import affinity_kernel as ak

METRICS = ["dot", "euclidean", "jaccard", "l1", "chord3"]
TENSOR_CORE = ["dot", "euclidean", "jaccard"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(metric, rows=300, seed=0, d=None):
    rng = np.random.default_rng(seed)
    if metric == "l1":
        x = rng.uniform(1e6, 2e6, size=(rows, 2))
    elif metric == "jaccard":
        x = (rng.random((rows, d or 64)) < 0.08).astype(np.float64)
        x[5] = 0.0
    elif metric == "chord3":
        ll = torch.from_numpy(rng.uniform([-80, -170], [80, 170], size=(rows, 2)))
        x = ak.location_to_unit_xyz(ll.float()).numpy()
    else:
        x = rng.normal(size=(rows, d or 24))
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [24, 4100])
@pytest.mark.parametrize("rows", [300, 2001])
@pytest.mark.parametrize("metric", TENSOR_CORE)
def test_tensor_core_route_ragged_shapes_on_cuda(metric, rows, d, cuda):
    """Rows and features that are not multiples of the 64-row tile or the
    32-deep feature chunk."""
    x, valid = _inputs(metric, rows=rows, d=d)
    got = ak.knn_adjacency(x.to(cuda), valid.to(cuda), 9, metric)
    want = ak.knn_adjacency_reference(x.to(cuda), valid.to(cuda), 9, metric)
    _assert_agrees(got, want, metric)
    assert (got.sum(1).cpu()[valid] == 9).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case, k, degree", [("duplicates", 5, 5), ("one_valid_row", 5, 0),
                                             ("fewer_valid_than_k", 7, 5),
                                             ("k_above_n", 500, 199)])
@pytest.mark.parametrize("metric", TENSOR_CORE)
def test_tensor_core_route_degrees_on_cuda(metric, case, k, degree, cuda):
    """40 duplicate rows emit exactly k; a valid row whose every neighbour is
    invalid emits nothing; k >= #valid keeps every valid neighbour."""
    x, valid = _inputs(metric, rows=200)
    valid[:] = True
    if case == "duplicates":
        x[10:50] = x[10]
    elif case == "one_valid_row":
        valid[:] = False
        valid[7] = True
    elif case == "fewer_valid_than_k":
        valid[:] = False
        valid[:6] = True
    got = ak.knn_adjacency(x.to(cuda), valid.to(cuda), k, metric).cpu()
    want = ak.knn_adjacency_reference(x, valid, k, metric)
    _assert_agrees(got, want, metric)
    assert (got.sum(1)[valid] == degree).all() and (got.sum(1)[~valid] == 0).all()
    assert (got[:, ~valid] == 0).all() and (got.diagonal() == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128, 1000])
@pytest.mark.parametrize("metric", TENSOR_CORE)
def test_row_chunks_equal_one_chunk_on_cuda(metric, chunk, cuda):
    """Row chunks (forced by ``chunk_rows``; 1000 rounds down to 960) compute
    every tile; one chunk of all rows computes the upper triangle and mirrors
    it.  The adjacency is the same, and each call is one launch."""
    x, valid = _inputs(metric, rows=1100, d=200)
    x, valid = x.to(cuda), valid.to(cuda)
    before = ak.launches
    whole = ak.knn_adjacency(x, valid, 9, metric)
    chunked = ak.knn_adjacency(x, valid, 9, metric, chunk_rows=chunk)
    torch.cuda.synchronize()
    assert ak.launches == before + 2
    assert torch.equal(chunked, whole)
    _assert_agrees(chunked, ak.knn_adjacency_reference(x, valid, 9, metric), metric)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_bf16_operands_match_plain_on_cuda(metric, cuda):
    x, valid = _inputs(metric, rows=500)
    x, valid = x.to(cuda), valid.to(cuda)
    got = ak.knn_adjacency(x, valid, 7, metric, input_dtype="bfloat16")
    want = ak.knn_adjacency_reference(x, valid, 7, metric, input_dtype="bfloat16")
    _assert_agrees(got, want, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [True, False])
def test_native_hasher_matches_python_on_the_card_machine(sparse, cuda, monkeypatch):
    """The port's C++ hasher, built on the machine with the card, against its
    Python fallbacks on a window of the synthetic stream: bit-equal."""
    from mused_tpu_torch import native
    from mused_tpu_torch.data import features
    from mused_tpu_torch.data.synthetic import make_stream
    from mused_tpu_torch.utils.config import FeatureConfig
    assert native.available(), native.load_error
    mods, _, _ = make_stream(2000, noise_rate=0.95, seed=0)
    cfg = FeatureConfig(sparse=sparse)
    before = native.calls
    fast = features.featurize_window(*mods, cfg)
    assert native.calls == before + 2
    monkeypatch.setattr(native, "_load", lambda: None)
    plain = features.featurize_window(*mods, cfg)
    for g, w in zip(fast, plain):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


LONG_ROWS = [8193, 16384, 32768]     # rows of 32 KB to 128 KB of keys (the dense batch: 32,768)


def _exact_inputs(metric, rows, seed=0):
    """Inputs on which the kernel's and the plain version's similarities are
    equal bit for bit, with many keys tied at the k-th: dot and euclidean on
    small integers (every product and sum exact; 5% all-zero rows give +0.0
    under dot, 60 duplicates of row 1 give -0.0 under euclidean), jaccard
    with 5% all-zero tag rows (+0.0 against every row), l1 on timestamps and
    chord3 on unit xyz with 60 duplicates of row 1 (-0.0 ties)."""
    rng = np.random.default_rng(seed)
    if metric in ("dot", "euclidean"):
        x = rng.integers(-3, 4, size=(rows, 8)).astype(np.float32)
        x[rng.random(rows) < 0.05] = 0.0
    elif metric == "jaccard":
        x = (rng.random((rows, 64)) < 0.08).astype(np.float32)
        x[rng.random(rows) < 0.05] = 0.0
    elif metric == "l1":
        x = rng.uniform(1e6, 2e6, size=(rows, 2)).astype(np.float32)
    else:
        ll = torch.from_numpy(rng.uniform([-80, -170], [80, 170], size=(rows, 2)))
        x = ak.location_to_unit_xyz(ll.float()).numpy()
    x[2:62] = x[1]
    valid = rng.random(rows) > 0.01
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)), torch.from_numpy(valid)


def _k(metric):
    return 150 if metric == "l1" else 50     # time takes 3 * k_basis


@pytest.mark.cuda
@pytest.mark.parametrize("n", LONG_ROWS)
@pytest.mark.parametrize("metric", METRICS)
def test_long_rows_bit_equal_on_cuda(metric, n, cuda):
    """Every metric at the dense batch's shapes: bit-equal, one launch."""
    x, valid = _exact_inputs(metric, n)
    x, valid = x.to(cuda), valid.to(cuda)
    before = ak.launches
    got = ak.knn_adjacency(x, valid, _k(metric), metric)
    torch.cuda.synchronize()
    assert ak.launches == before + 1
    want = ak.knn_adjacency_reference(x, valid, _k(metric), metric)
    assert torch.equal(got, want)
    degree = got.sum(1)
    assert (degree[valid] == _k(metric)).all() and (degree[~valid] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["duplicates_dot", "zero_tags_jaccard", "minus_zero_euclidean",
                                  "plus_zero_dot", "minus_zero_l1"])
def test_long_rows_ties_at_the_kth_on_cuda(case, cuda):
    """Far more keys tied at the k-th value than the row keeps: 600 identical
    rows (dot), all-zero tag rows (+0.0 against all, jaccard), 600 copies of
    a point (-0.0, euclidean and l1), half the rows zero so +0.0 ranks above
    negative dot products."""
    n, k = 8193, 50
    rng = np.random.default_rng(1)
    metric = case.split("_")[-1]
    if case == "duplicates_dot":
        x = rng.integers(-3, 4, size=(n, 8)).astype(np.float32)
        x[100:700] = x[100]
    elif case == "zero_tags_jaccard":
        x = (rng.random((n, 64)) < 0.03).astype(np.float32)
        x[rng.random(n) < 0.4] = 0.0
    elif case == "minus_zero_euclidean":
        x = rng.integers(-3, 4, size=(n, 8)).astype(np.float32)
        x[100:700] = x[100]
    elif case == "plus_zero_dot":
        x = -rng.integers(0, 3, size=(n, 8)).astype(np.float32)
        x[::2] = 0.0
        x[1::4] *= -1.0
    else:
        x = rng.integers(0, 50, size=(n, 2)).astype(np.float32)
        x[100:700] = x[100]
    valid = torch.ones(n, dtype=torch.bool)
    x = torch.from_numpy(x)
    got = ak.knn_adjacency(x.to(cuda), valid.to(cuda), k, metric).cpu()
    want = ak.knn_adjacency_reference(x, valid, k, metric)
    assert torch.equal(got, want)
    assert (got.sum(1) == k).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_invalid", "fewer_valid_than_k"])
@pytest.mark.parametrize("metric", METRICS)
def test_long_rows_invalid_and_short_rows_on_cuda(metric, case, cuda):
    """All rows invalid: the zero matrix.  40 valid rows and k = 50 or 150:
    each valid row keeps its 39 valid neighbours, the rest nothing."""
    n = 8193
    x, valid = _exact_inputs(metric, n, seed=2)
    valid[:] = False
    if case == "fewer_valid_than_k":
        valid[torch.from_numpy(np.random.default_rng(3).choice(n, 40, replace=False))] = True
    got = ak.knn_adjacency(x.to(cuda), valid.to(cuda), _k(metric), metric).cpu()
    want = ak.knn_adjacency_reference(x, valid, _k(metric), metric)
    assert torch.equal(got, want)
    degree = got.sum(1)
    assert (degree[valid] == int(valid.sum()) - 1).all() and (degree[~valid] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1000, 4096])
@pytest.mark.parametrize("metric", METRICS)
def test_long_rows_chunks_equal_one_chunk_on_cuda(metric, chunk, cuda):
    """Row chunks (1000 rounds down to 960) against one chunk of all 16,384
    rows (the tensor-core route mirrors it): bit-equal, one launch each."""
    x, valid = _exact_inputs(metric, 16384, seed=4)
    x, valid = x.to(cuda), valid.to(cuda)
    before = ak.launches
    whole = ak.knn_adjacency(x, valid, _k(metric), metric)
    chunked = ak.knn_adjacency(x, valid, _k(metric), metric, chunk_rows=chunk)
    torch.cuda.synchronize()
    assert ak.launches == before + 2
    assert torch.equal(chunked, whole)
    assert torch.equal(whole, ak.knn_adjacency_reference(x, valid, _k(metric), metric))
