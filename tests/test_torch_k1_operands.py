"""Which operands K1's tensor-core route may feed its contraction: the probe.

The kernel (``mused_tpu_torch/csrc/knn_adjacency.cu``) splits each f32
operand into TF32 halves, hi = tf32(x) and lo = tf32(x - hi), both rounded
to nearest with ties away from zero (``cvt.rna.tf32.f32``), and sums
hi.hi + (hi.lo + lo.hi) in f32.  Here that split is emulated in plain
PyTorch (the rounding as integer ops on the bits) on the first 2000-row
window of the seeded synthetic stream at full width (k 50, text TF-IDF at
d = 4096, tags multi-hot at d = 2048), and the adjacency is held against the
f32 one:

* text: >= 99.9% of edges agree (the kernel's dot bar) with identical row
  degrees;
* tags: bit-equal (0/1 operands have lo == 0, so the intersection is an
  exact integer);
* single-pass bf16 operands fall below the bar on text, which is why the
  kernel does not use them for f32 inputs.
"""
import numpy as np
import pytest
import torch

from mused_tpu.utils.config import PipelineConfig
from mused_tpu_torch.data.ingest import to_device
from mused_tpu_torch.data.synthetic import make_stream
from mused_tpu_torch.engine import streaming
from mused_tpu_torch.ops import affinity

WINDOW, K_BASIS, EDGE_AGREEMENT = 2000, 50, 0.999


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def gram_3xtf32(x: torch.Tensor) -> torch.Tensor:
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    cross = hi @ lo.T
    return hi @ hi.T + (cross + cross.T)


def gram_bf16(x: torch.Tensor) -> torch.Tensor:
    xb = x.to(torch.bfloat16).float()
    return xb @ xb.T


def edge_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.bool(), b.bool()
    return int((a & b).sum()) / int((a | b).sum())


@pytest.fixture(scope="module")
def window():
    mods, _, _ = make_stream(8000, noise_rate=0.95, seed=0)
    engine = streaming.StreamingEngine(
        PipelineConfig(window_size=WINDOW, k_basis=K_BASIS, reduced_dim=50), "cpu")
    host = engine.featurize([m[:WINDOW] for m in mods], streaming.STANDARD_TYPES)
    _, _, _, tags_ids, text_ids, text_cnt, tags_valid = to_device(host, torch.device("cpu"))
    fc = engine.cfg.features
    tags = affinity.counts_from_tokens(tags_ids, None, fc.tags_hash_dim)
    text, text_valid = affinity.tfidf_rows(
        affinity.counts_from_tokens(text_ids, text_cnt, fc.text_hash_dim))
    assert tags.shape == (WINDOW, 2048) and text.shape == (WINDOW, 4096)
    return {"tags": (tags, tags_valid.bool()), "text": (text, text_valid)}


def test_tf32_rna_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                       # TF32 spacing at 1.0
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 3.0 + 2.0 ** -20, 0.0])
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0, 0.0])
    assert torch.equal(tf32_rna(x), want)
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    hi = tf32_rna(v)
    assert torch.equal(tf32_rna(hi), hi)                   # idempotent
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert float((v - hi).abs().max() / v.abs().max()) <= 2.0 ** -11


def test_3xtf32_text_agrees_with_f32(window):
    x, valid = window["text"]
    want = affinity.knn_adjacency(x @ x.T, valid, K_BASIS)
    got = affinity.knn_adjacency(gram_3xtf32(x), valid, K_BASIS)
    assert edge_agreement(got, want) >= EDGE_AGREEMENT
    assert torch.equal(got.sum(1), want.sum(1))


def test_tf32_tags_bit_equal(window):
    x, valid = window["tags"]
    assert torch.equal(tf32_rna(x), x)                     # 0/1: lo == 0
    inter = gram_3xtf32(x)
    assert torch.equal(inter, x @ x.T)                     # exact integers
    sizes = x.sum(1)
    union = sizes[:, None] + sizes[None, :] - inter
    sim = torch.where(union > 0, inter / torch.clamp(union, min=1e-9), 0.0)
    got = affinity.knn_adjacency(sim, valid, K_BASIS)
    want = affinity.knn_adjacency(affinity.jaccard_matrix(x), valid, K_BASIS)
    assert torch.equal(got, want)


def test_bf16_single_pass_fails_the_text_bar(window):
    x, valid = window["text"]
    want = affinity.knn_adjacency(x @ x.T, valid, K_BASIS)
    got = affinity.knn_adjacency(gram_bf16(x), valid, K_BASIS)
    assert edge_agreement(got, want) < EDGE_AGREEMENT
