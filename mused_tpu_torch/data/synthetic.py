"""SED2012-shaped synthetic stream without pandas.

A numpy-only twin of ``mused_tpu.data.synthetic._synthetic_events_fast``
followed by ``mused_tpu.data.sed2012.prepare_modalities``: planted events
that cluster in time, space, usernames, tags and text; noise rows drawn
uniformly; 10% of rows without geotag and 5% without a taken-time.  It
returns the same ``(modalities, modality_types, labels)`` layout and dtypes
as ``prepare_modalities``:

  location (n, 2) float64 [lat, lon]     time (n, 2) float64 [taken, upload]
  username (n, 1) object str             tags (n, 1) object list[str]
  text     (n, 2) object [title, desc]   labels (n,) int64

Per-event homes, time windows and vocabularies are the same deterministic
values as the JAX package's generator (they derive from per-event
``default_rng(1000 + ev)`` streams); the per-row draws, the shuffle and the
subsample consume the seed's generator in another order, so rows differ
from the JAX package's for the same seed.

``synthetic_stream`` / ``load_synthetic_dataset`` (the reference's sketch
benchmark input) and ``crisis_embedding_stream`` (BASELINE.md config #2's
two embedding modalities) are the JAX package's generators copied, row for
row.
"""
from __future__ import annotations

import numpy as np

from mused_tpu_torch.data import sed2012

_WORDS = ("festival concert goal match stadium protest plaza camp strike rally "
          "music crowd street fireworks banner speech square kickoff referee "
          "anthem drums tent march police flags").split()
MODALITY_TYPES = sed2012.MODALITY_TYPES


def synthetic_stream(n: int = 500_000, m: int = 10, d: int = 300, zeta: int = 10,
                     seed: int = 0) -> np.ndarray:
    """(n, d) float32 stream with m dominant directions, the spec of the
    reference's sketch benchmark fixture ``synthetic_n=500000,m=10,d=300,
    zeta=10.mat`` (reference data_loader.py:190-195): signal S D U plus
    noise / zeta.  The JAX package's draws, so the same rows for a seed."""
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.normal(size=(d, m)))
    scales = np.linspace(1.0, 0.1, m)
    coefs = rng.normal(size=(n, m)) * scales[None, :]
    noise = rng.normal(size=(n, d)) / zeta
    return (coefs @ basis.T + noise).astype(np.float32)


def load_synthetic_dataset(subset_size: int | None = None, d: int = 300, seed: int = 0):
    """The reference's load_synthetic_dataset contract (data_loader.py:190-195):
    a one-element list holding an (n, d) float64 array, generated (n =
    ``subset_size`` or 500,000)."""
    n = subset_size if subset_size else 500_000
    return [synthetic_stream(n=n, d=d, seed=seed).astype(np.float64)]


def _join_words(words: np.ndarray) -> list[str]:
    out = words[:, 0].astype(object)
    for j in range(1, words.shape[1]):
        out = out + " " + words[:, j]
    return out.tolist()


def synthetic_events(n_rows: int, n_events: int, noise_rate: float, seed: int) -> dict:
    """Columns of a shuffled SED2012-like table as numpy arrays."""
    rng = np.random.default_rng(seed)
    n_noise = int(n_rows * noise_rate)
    ne = n_rows - n_noise
    base_time = 1.3e9
    words_arr = np.array(_WORDS, object)

    ev = np.arange(ne) % n_events + 1
    homes = np.stack([np.random.default_rng(1000 + e).uniform([-40, -120], [40, 120])
                      for e in range(1, n_events + 1)])
    latlon_e = homes[ev - 1] + rng.normal(size=(ne, 2)) * 0.05
    taken_e = base_time + ev * 5e5 + rng.uniform(0, 3600, ne)
    upload_e = taken_e + rng.uniform(0, 1800, ne)
    user_e = [f"user_{e}_{k}" for e, k in zip(ev, rng.integers(0, 4, ne))]
    tag_vocab = np.array([[f"tag{e}_{k}" for k in range(6)] + ["shared"]
                          for e in range(1, n_events + 1)], object)
    tag_rows = np.take_along_axis(tag_vocab[ev - 1],
                                  np.argsort(rng.random((ne, 7)), axis=1), axis=1)
    tags_e = [list(r[:s]) for r, s in zip(tag_rows, rng.integers(2, 5, ne))]
    vocab_e = np.concatenate(
        [words_arr[rng.integers(0, len(words_arr), (ne, 4))],
         np.array([f"event{e}" for e in ev], object)[:, None]], axis=1)
    title_e = _join_words(np.take_along_axis(vocab_e, rng.integers(0, 5, (ne, 3)), axis=1))
    desc_e = _join_words(np.take_along_axis(vocab_e, rng.integers(0, 5, (ne, 5)), axis=1))

    nn = n_noise
    latlon_n = rng.uniform([-60, -170], [60, 170], size=(nn, 2))
    taken_n = base_time + rng.uniform(0, n_events * 1e6, nn)
    upload_n = taken_n + rng.uniform(0, 86400, nn)
    user_n = [f"noise_user_{u}" for u in rng.integers(0, n_noise // 2 + 1, nn)]
    ntag_vocab = np.array([f"ntag{k}" for k in range(50)], object)
    nperm = np.argsort(rng.random((nn, 50)), axis=1)[:, :3]
    tags_n = [list(ntag_vocab[p[:s]]) for p, s in zip(nperm, rng.integers(0, 3, nn))]
    title_n = _join_words(words_arr[rng.integers(0, len(words_arr), (nn, 2))])
    desc_n = _join_words(words_arr[rng.integers(0, len(words_arr), (nn, 3))])

    lat = np.concatenate([latlon_e[:, 0], latlon_n[:, 0]])
    lon = np.concatenate([latlon_e[:, 1], latlon_n[:, 1]])
    taken = np.concatenate([taken_e, taken_n])
    upload = np.concatenate([upload_e, upload_n])
    geo_bad = rng.random(n_rows) < 0.1
    lat[geo_bad] = np.nan
    lon[geo_bad] = np.nan
    taken[rng.random(n_rows) < 0.05] = 0.0

    perm = rng.permutation(n_rows)
    event_id = np.concatenate([ev, np.zeros(nn, np.int64)]).astype(np.int64)[perm]
    obj = lambda xs: np.array(xs, object)[perm]  # noqa: E731
    tags_all = tags_e + tags_n
    return {
        "datetaken": taken[perm], "dateupload": upload[perm],
        "latitude": lat[perm], "longitude": lon[perm],
        "title": obj(title_e + title_n), "description": obj(desc_e + desc_n),
        "tags": [tags_all[p] for p in perm],
        "username": obj(user_e + user_n),
        "event_id": event_id,
        "is_event": (event_id > 0).astype(np.int64),
        "event_type": np.where(event_id == 0, 0, (event_id - 1) % 3 + 1).astype(np.int64),
    }


def prepare_modalities(table: dict, subset_size: int, *, sort_by_uploaded: bool = True,
                       event_types: bool = False, binary: bool = False,
                       noise_rate: float = 0.95, seed: int = 0):
    """Label selection + seeded subsampling + modality split of a column
    table: ``data/sed2012.prepare_modalities``, which orders tied upload
    times as the JAX package does."""
    return sed2012.prepare_modalities(table, subset_size, sort_by_uploaded=sort_by_uploaded,
                                      event_types=event_types, binary=binary,
                                      noise_rate=noise_rate, seed=seed)


def make_stream(n_records: int, *, n_events: int = 24, noise_rate: float = 0.95,
                binary: bool = True, sort_by_uploaded: bool = True, seed: int = 0):
    """``n_records`` prepared records at ``noise_rate``: the table holds 5%
    more rows than needed so both the noise and the event pools suffice."""
    table = synthetic_events(int(n_records * 1.05) + 64, n_events, noise_rate, seed)
    return prepare_modalities(table, n_records, sort_by_uploaded=sort_by_uploaded,
                              binary=binary, noise_rate=noise_rate, seed=seed)


def crisis_embedding_stream(n_rows: int = 2048, n_events: int = 8,
                            noise_rate: float = 0.4, d_text: int = 512,
                            d_image: int = 512, seed: int = 0):
    """Two-modality text + image embedding stream (CrisisMMD-style;
    BASELINE.md config #2), copied from ``mused_tpu.data.synthetic`` (same
    draws, same rows for the same seed): each event is a pair of (text,
    image) centroids; noise rows are isotropic.  Returns (modalities,
    modality_types, labels) in the engine's generic-numeric format; label 0
    is noise, events are 1..n_events."""
    rng = np.random.default_rng(seed)
    txt_centers = rng.normal(size=(n_events, d_text)).astype(np.float32)
    img_centers = rng.normal(size=(n_events, d_image)).astype(np.float32)
    txt_centers /= np.linalg.norm(txt_centers, axis=1, keepdims=True)
    img_centers /= np.linalg.norm(img_centers, axis=1, keepdims=True)

    labels = np.zeros(n_rows, np.int64)
    text = np.empty((n_rows, d_text), np.float32)
    image = np.empty((n_rows, d_image), np.float32)
    for i in range(n_rows):
        if rng.random() >= noise_rate:
            ev = int(rng.integers(n_events))
            labels[i] = ev + 1
            text[i] = txt_centers[ev] + rng.normal(size=d_text) * 0.15
            image[i] = img_centers[ev] + rng.normal(size=d_image) * 0.15
        else:
            text[i] = rng.normal(size=d_text)
            image[i] = rng.normal(size=d_image)
    text /= np.maximum(np.linalg.norm(text, axis=1, keepdims=True), 1e-9)
    image /= np.maximum(np.linalg.norm(image, axis=1, keepdims=True), 1e-9)
    return [text, image], ["embedding", "embedding"], labels
