"""SED2012-shaped synthetic records, frozen for the benchmark.

A copy of ``mused_tpu_torch/data/synthetic.py`` (``synthetic_events``,
``make_stream``) and of ``mused_tpu_torch/data/sed2012.py``
(``upload_order``, ``prepare_modalities``) as they stand at commit 8a4150f,
so that the inputs of every cell stay the same whatever later changes the
program's own generator.  Planted events cluster in time, space, usernames,
tags and text; noise rows are drawn uniformly; 10% of rows lack a geotag
and 5% a taken-time.  Records come out in the layout of the reference's
``prepare_modalities`` (reference data_loader.py:86-113):

  location (n, 2) float64 [lat, lon]     time (n, 2) float64 [taken, upload]
  username (n, 1) object str             tags (n, 1) object list[str]
  text     (n, 2) object [title, desc]   labels (n,) int64
"""
from __future__ import annotations

import numpy as np

MODALITY_TYPES = ["location", "time", "username", "tags", "text"]

_WORDS = ("festival concert goal match stadium protest plaza camp strike rally "
          "music crowd street fireworks banner speech square kickoff referee "
          "anthem drums tent march police flags").split()
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


def upload_order(dateupload: np.ndarray) -> np.ndarray:
    """The row order of pandas' ``sort_values`` on a float column: numpy's
    quicksort argsort of the non-NaN values, then the NaN rows in their
    original order."""
    values = np.asarray(dateupload)
    nan = np.isnan(values)
    idx = np.arange(len(values))
    return np.concatenate([idx[~nan][values[~nan].argsort(kind="quicksort")], idx[nan]])


def _object_column(cells: list) -> np.ndarray:
    """(n, 1) object array holding one Python object (e.g. a list) per row."""
    col = np.empty((len(cells), 1), object)
    for i, c in enumerate(cells):
        col[i, 0] = c
    return col


def prepare_modalities(df: dict, subset_size: int = 10000, sort_by_uploaded: bool = True,
                       event_types: bool = False, binary: bool = False,
                       noise_rate: float = 0.95, seed: int = 0):
    """Label-mode selection + seeded noise / event subsampling + modality
    split of a column table (reference data_loader.py:52-113, the JAX
    package's sampling arithmetic and RNG stream) -> (modalities,
    modality_types, labels), the layout of the JAX package's DataFrame
    version:

      location (n, 2) float64 [lat, lon]     time (n, 2) float64 [taken, upload]
      username (n, 1) object str             tags (n, 1) object list[str]
      text     (n, 2) object [title, desc]   labels (n,) int64
    """
    labels = df["is_event" if binary else "event_type" if event_types else "event_id"]
    subset_size = min(subset_size, len(labels))
    rng = np.random.default_rng(seed=seed)
    rows = np.arange(len(labels))
    if 0 <= noise_rate < 1.0:
        noise_idx = np.where(labels == 0)[0]
        event_idx = np.where(labels > 0)[0]
        num_events = min(int((1 - noise_rate) * subset_size), len(event_idx))
        sampled_noise = rng.choice(noise_idx, subset_size - num_events, replace=False)
        sampled_events = rng.choice(event_idx, num_events, replace=False)
        rows = np.sort(np.concatenate([sampled_noise, sampled_events]))
    if sort_by_uploaded:
        rows = rows[upload_order(df["dateupload"][rows])]

    def pair(a, b):
        return np.stack([df[a][rows], df[b][rows]], axis=1)

    modalities = [pair("latitude", "longitude"), pair("datetaken", "dateupload"),
                  np.asarray(df["username"])[rows][:, None],
                  _object_column([df["tags"][r] for r in rows]),
                  pair("title", "description")]
    return modalities, list(MODALITY_TYPES), labels[rows]


def make_stream(n_records: int, *, n_events: int = 24, noise_rate: float = 0.95,
                binary: bool = True, sort_by_uploaded: bool = True, seed: int = 0):
    """``n_records`` prepared records at ``noise_rate``: the table holds 5%
    more rows than needed so both the noise and the event pools suffice."""
    table = synthetic_events(int(n_records * 1.05) + 64, n_events, noise_rate, seed)
    return prepare_modalities(table, n_records, sort_by_uploaded=sort_by_uploaded,
                              binary=binary, noise_rate=noise_rate, seed=seed)
