"""Seeded CrisisMMD-style records: two L2-normalized embeddings per record
(text and image, each in a CLIP-like joint space), planted events and
isotropic noise, in arrival order.

A frozen, vectorised restatement of the port's
``mused_tpu_torch/data/synthetic.crisis_embedding_stream`` (at commit
9f32c18): each event is a pair of unit centroids, an event record is its
event's centroid plus Gaussian noise of scale ``noise_scale`` in each
modality, a noise record is a standard Gaussian, and every row is
normalized; label 0 is noise, events are 1..n_events.  It draws in bulk,
chunk by chunk, so it does not make the same draws as that generator for
a seed (nor the same rows); the same seed always gives the same records
here.
"""
from __future__ import annotations

import numpy as np

CHUNK = 32_768          # rows drawn at a time (fixed: it orders the draws)


def _centers(rng, n_events: int, d: int) -> np.ndarray:
    c = rng.standard_normal((n_events, d), dtype=np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


def _modality(rng, n: int, d: int, centers: np.ndarray, event: np.ndarray,
              labels: np.ndarray, noise_scale: float) -> np.ndarray:
    out = np.empty((n, d), np.float32)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        z = rng.standard_normal((hi - lo, d), dtype=np.float32)
        e = event[lo:hi]
        z[e] = centers[labels[lo:hi][e] - 1] + np.float32(noise_scale) * z[e]
        z /= np.maximum(np.linalg.norm(z, axis=1, keepdims=True), np.float32(1e-9))
        out[lo:hi] = z
    return out


def make_stream(n: int, *, n_events: int, noise_rate: float, d_text: int, d_image: int,
                noise_scale: float, seed: int):
    """``n`` records: ([text (n, d_text), image (n, d_image)] float32 unit
    rows, labels (n,) int64)."""
    rng = np.random.default_rng(seed % 2**63)
    txt_c = _centers(rng, n_events, d_text)
    img_c = _centers(rng, n_events, d_image)
    event = rng.random(n) >= noise_rate
    labels = np.where(event, rng.integers(0, n_events, n) + 1, 0).astype(np.int64)
    text = _modality(rng, n, d_text, txt_c, event, labels, noise_scale)
    image = _modality(rng, n, d_image, img_c, event, labels, noise_scale)
    return [text, image], labels
