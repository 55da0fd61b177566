"""Runs of the harness on the CPU at a small size, with the timed path
broken underneath: the check has to come out false.  The last cases run
the control on the card and see it fail the limits (they skip without one)."""
from __future__ import annotations

import time

import pytest
import torch

from portbench import harness

# small sizes of each cell: the program's plain versions run on the CPU
SMALL = {
    "w2000-serve": {"config": {"window_size": 256, "k_basis": 8, "reduced_dim": 24},
                    "traffic": {"push_records": 64, "pool_records": 2048,
                                "rate_records_per_s": 20000, "warmup_windows": 1,
                                "check_windows": 2}},
    "w100k-svd": {"config": {"window_size": 4096, "k_basis": 8, "reduced_dim": 8,
                             "nbins": 512},
                  "traffic": {"pool_windows": 2, "windows_per_call": 1, "min_calls": 2}},
    "b150k-batch": {"config": {"subset_size": 3000, "k_basis": 8, "reduced_dim": 8,
                               "nbins": 512},
                    "traffic": {"pool_subsets": 2, "min_calls": 2}},
}
FAULTS = [("w2000-serve", "state_unchanged"), ("w2000-serve", "half_rows"),
          ("w2000-serve", "fold_half_rows"), ("w2000-serve", "labels_altered"),
          ("w100k-svd", "half_rows"), ("w100k-svd", "svd_half_rows"),
          ("w100k-svd", "labels_altered"), ("b150k-batch", "half_rows"),
          ("b150k-batch", "svd_half_rows"), ("b150k-batch", "labels_altered")]


def _run(cell: str, faults: tuple) -> dict:
    return harness.run_cell(harness.resolve(cell), 2**31 + 11, 0.2, False,
                            t_start=time.perf_counter(), device="cpu", faults=faults,
                            overrides=SMALL[cell])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out = _run(cell, (fault,))
    assert out["correct"] is False, out["compared"]
    assert list(out)[-1] == "compared"


def test_a_sound_small_run_compares_every_number():
    out = _run("w2000-serve", ())
    assert set(out["compared"]) == set(harness.resolve("w2000-serve").traffic["limits"])
    for name in ("knn_mismatch.location", "knn_mismatch.time", "knn_mismatch.tags",
                 "knn_mismatch.text", "knn_mismatch.username"):
        assert out["compared"][name]["value"] == 0.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control computes in TF32 on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["w2000-serve", "w100k-svd", "b150k-batch"])
def test_the_control_fails_the_check(card, cell):
    """The reference in the program's place with TF32 products, at the
    cell's own size, is not correct."""
    from portbench import control
    c = harness.resolve(cell)
    nums = (control.control_dense(c, 5, 8.0, card) if cell == "w2000-serve"
            else control.control_blocked(c, 5, card))
    ok, _ = harness.judge(nums, {k: v for k, v in c.traffic["limits"].items() if k in nums})
    assert not ok, nums
