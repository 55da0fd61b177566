"""The frozen generator, the reference featurization and the roofline
counts on tiny inputs."""
from __future__ import annotations

import zlib

import numpy as np
import pytest

from portbench.gen import sed2012_synth
from portbench.reference import features
from portbench.roofline import counts

CFG = dict(tags_hash_dim=2048, text_hash_dim=4096, tags_token_cap=24, text_token_cap=96)


def _same(a, b) -> bool:
    for x, y in zip(a[0], b[0]):
        if x.dtype == object:
            if x.ravel().tolist() != y.ravel().tolist():
                return False
        elif not np.array_equal(x, y, equal_nan=True):
            return False
    return np.array_equal(a[2], b[2])


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 9_123_456_789])
def test_the_generator_gives_the_same_records_for_a_seed(seed):
    a = sed2012_synth.make_stream(600, seed=seed)
    b = sed2012_synth.make_stream(600, seed=seed)
    assert _same(a, b)
    assert not _same(a, sed2012_synth.make_stream(600, seed=seed + 1))


def _tiny():
    loc = np.array([[10.0, 20.0], [np.nan, np.nan], [10.0, 20.5]])
    tim = np.array([[1.3e9, 1.3e9 + 5], [0.0, 1.3e9], [1.3e9 + 60, 1.3e9 + 70]])
    users = np.array([["a"], [""], ["a"]], object)
    tags = np.empty((3, 1), object)
    tags[0, 0], tags[1, 0], tags[2, 0] = ["x", "y", "x"], "", []
    text = np.array([["Goal goal", "a match"], [None, ""], ["match", "stadium"]], object)
    return [loc, tim, users, tags, text]


def test_featurize_hashes_dedups_and_marks_validity():
    rec = features.featurize(_tiny(), **CFG, pad_to=4)
    h = lambda s, d: zlib.crc32(s.encode()) % d   # noqa: E731
    assert rec.loc_valid.tolist() == [True, False, True, False]
    assert rec.time_valid.tolist() == [True, False, True, False]
    assert rec.times[0].tolist() == [1.0, 1.0] and rec.times[2].tolist() == [61.0, 66.0]
    assert rec.users.tolist() == [0, -1, 0, -1]
    assert rec.tags[0] == sorted({h("x", 2048), h("y", 2048)}) and rec.tags[2] == []
    assert rec.tags_valid.tolist() == [True, False, True, False]
    assert rec.words[0] == {h("goal", 4096): 2, h("match", 4096): 1}
    assert rec.words[1] == {} and rec.n_real == 3


def test_k1_bound_counts_nonzeros_and_pairs_by_hand():
    rec = features.featurize(_tiny(), **CFG)
    n, k = 3, 2
    # tags: features x, y each in one row -> entries met 1 + 1; text: goal
    # (df 1), match (df 2), stadium (df 1) -> 1 + 4 + 1
    tags = counts.TokenStats(rec.tags, False, n).block(0, n)
    text = counts.TokenStats(rec.words, True, n).block(0, n)
    assert tags == {"entries_met": 2.0, "row_terms": 2.0, "features_met": 2.0,
                    "postings_of_features_met": 2.0}
    assert text == {"entries_met": 6.0, "row_terms": 4.0, "features_met": 3.0,
                    "postings_of_features_met": 4.0}
    out = n * k * 4.0
    steps = 2
    want = (counts.bound_s(11 * 9, "fp32_instr", (n + n) * 3 * 4 + n + out)
            + counts.bound_s(6 * 9, "fp32_instr", (n + n) * 2 * 4 + n + n * 2 * 4.0)
            + counts.bound_s(4.0, "fp32", 2 * 8 + 2 * 8 + 2 * steps * 4 + n + out + 6 * 4)
            + counts.bound_s(12.0, "fp32", 4 * 8 + 4 * 8 + 3 * steps * 4 + n + out))
    assert counts.k1_window_s(rec, k) == pytest.approx(want, rel=1e-12)


def test_k23_bound_counts_each_block_once_by_hand():
    """One block of 4 rows, 2 bins: text and tags by their nonzeros, the
    coordinate pair by its pairs; no sweep count enters."""
    rec = features.featurize(_tiny(), **CFG, pad_to=4)
    out, steps = 4 * 2 * 5.0, 2
    want = (counts.bound_s(12.0, "fp32", 4 * 6 + 4 * 6 + 3 * steps * 4 + 4 + out)
            + counts.bound_s(4.0, "fp32", 2 * 5 + 2 * 5 + 2 * steps * 4 + 4 + out + 8 * 4)
            + counts.bound_s(17 * 16, "fp32_instr", (8 * 3 * 4 + 4) + (8 * 2 * 4 + 4) + 2 * out))
    assert counts.k23_window_s(rec, block=4, nbins=2) == pytest.approx(want, rel=1e-12)
