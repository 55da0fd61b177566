"""Plain featurization of raw SED2012-shaped records for the reference.

Written from the configuration's stated feature layout, not from the
program's code: usernames compare as strings, tags and text words hash with
CRC32 into ``tags_hash_dim`` / ``text_hash_dim`` buckets (a row keeps its
first ``*_token_cap`` distinct buckets), text is the title and description
joined by a space and split into lowercase ``[a-z0-9]`` words of two or more
characters, locations and timestamps are stored as float32 (timestamps
shifted per window so that the smallest valid value is 1.0, which keeps
their differences exact), and a row whose taken or upload time is 0 or not
finite has no time.  A row whose tag cell is the empty string has no tags;
an empty tag list still takes part, with no tag (the reference's quirk,
reference matrix_operations.py:79).
"""
from __future__ import annotations

import re
import zlib
from typing import NamedTuple

import numpy as np

_WORD = re.compile(r"[a-z0-9]+")


class Records(NamedTuple):
    """One window's records, featurized; rows beyond the real ones are padding."""

    latlon: np.ndarray      # (n, 2) float32 degrees, NaN where missing
    loc_valid: np.ndarray   # (n,) bool
    times: np.ndarray       # (n, 2) float32, window-shifted; 0 where invalid
    time_valid: np.ndarray  # (n,) bool
    users: np.ndarray       # (n,) int64 id per distinct non-empty name, -1 none
    tags: list              # per row, the sorted distinct tag buckets
    tags_valid: np.ndarray  # (n,) bool
    words: list             # per row, {bucket: count}
    n_real: int


def _bucket(token: str, dim: int) -> int:
    return zlib.crc32(token.encode("utf-8", "ignore")) % dim


def featurize(modalities, *, tags_hash_dim: int, text_hash_dim: int, tags_token_cap: int,
              text_token_cap: int, pad_to: int | None = None) -> Records:
    location, times, usernames, tag_cells, texts = modalities
    n = len(location)
    latlon = np.asarray(location, np.float32)
    loc_valid = np.isfinite(latlon).all(axis=1)

    t64 = np.asarray(times, np.float64)
    with np.errstate(invalid="ignore"):
        time_valid = (np.isfinite(t64).all(axis=1) & (np.nan_to_num(t64[:, 0]) != 0.0)
                      & (np.nan_to_num(t64[:, 1]) != 0.0))
    tim = np.zeros((n, 2), np.float32)
    if time_valid.any():
        shift = t64[time_valid].min(axis=0) - 1.0
        tim[time_valid] = (t64[time_valid] - shift[None, :]).astype(np.float32)

    ids: dict[str, int] = {}
    users = np.full(n, -1, np.int64)
    for i, cell in enumerate(usernames[:, 0]):
        if isinstance(cell, str) and cell:
            users[i] = ids.setdefault(cell, len(ids))

    tags, tags_valid = [], np.ones(n, bool)
    for i, cell in enumerate(tag_cells[:, 0]):
        if cell is None or isinstance(cell, float):
            cell = ""
        if isinstance(cell, str):
            tags_valid[i] = cell != ""
            cell = [cell] if cell else []
        seen: list[int] = []
        for t in cell:
            if t:
                b = _bucket(str(t), tags_hash_dim)
                if b not in seen and len(seen) < tags_token_cap:
                    seen.append(b)
        tags.append(sorted(seen))

    words = []
    for title, desc in texts:
        joined = ((title if isinstance(title, str) else "") + " "
                  + (desc if isinstance(desc, str) else "")).strip()
        counts: dict[int, int] = {}
        for w in _WORD.findall(joined.lower()):
            if len(w) < 2:
                continue
            b = _bucket(w, text_hash_dim)
            if b in counts:
                counts[b] += 1
            elif len(counts) < text_token_cap:
                counts[b] = 1
        words.append(counts)

    pad = 0 if pad_to is None else pad_to - n
    if pad > 0:
        latlon = np.concatenate([latlon, np.full((pad, 2), np.nan, np.float32)])
        loc_valid = np.concatenate([loc_valid, np.zeros(pad, bool)])
        tim = np.concatenate([tim, np.zeros((pad, 2), np.float32)])
        time_valid = np.concatenate([time_valid, np.zeros(pad, bool)])
        users = np.concatenate([users, np.full(pad, -1, np.int64)])
        tags = tags + [[] for _ in range(pad)]
        tags_valid = np.concatenate([tags_valid, np.zeros(pad, bool)])
        words = words + [{} for _ in range(pad)]
    return Records(latlon, loc_valid, tim, time_valid, users, tags, tags_valid, words, n)


def token_arrays(rows: list, with_counts: bool):
    """(row index, bucket, count) arrays of a per-row token list or dict."""
    r, b, c = [], [], []
    for i, toks in enumerate(rows):
        items = toks.items() if with_counts else ((t, 1) for t in toks)
        for t, k in items:
            r.append(i)
            b.append(t)
            c.append(k)
    return (np.asarray(r, np.int64), np.asarray(b, np.int64), np.asarray(c, np.float64))
