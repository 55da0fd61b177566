"""K1's one choice in Python, pinned on the CPU with stubbed device-memory
figures: the rows of keys one chunk holds.

On the card the wrapper sizes its key scratch from the free memory; here
``torch.cuda``'s memory queries are replaced by fixed figures, so the rule
is checked without a card.  The CPU path never asks for memory.
"""
import numpy as np
import pytest
import torch

from mused_tpu_torch.ops.kernels import affinity_kernel as ak

GB = 1 << 30


def _no_query():
    raise AssertionError("the rule asked for device memory")


@pytest.mark.parametrize("n, free, want", [
    (2000, None, 2000),                 # 16 MB of keys: no memory query
    (8000, None, 8000),                 # 256 MB: still under KEY_SCRATCH_BYTES
    (8193, 80 * GB, 8193),              # above it: all rows when half the free memory holds them
    (32768, 70 * GB, 32768),            # the dense batch on an 80 GB card: one chunk, mirrored
    (32768, 4 * GB, 16384),             # 2 GB for keys: 16,384 rows of 128 KB
    (32768, 3 * GB, 12288),             # rounded down to the 64-row tile
    (32768, 1 << 20, 64),               # at least one tile
])
def test_chunk_rows_from_free_memory(n, free, want):
    assert ak.chunk_rows_for(n, _no_query if free is None else lambda: free) == want


@pytest.mark.parametrize("n, chunk_rows, want", [(1100, 64, 64), (1100, 1000, 960),
                                                (1100, 1100, 1100), (1100, 5000, 1100),
                                                (32768, 2048, 2048), (16384, 100, 64)])
def test_chunk_rows_given_by_the_caller(n, chunk_rows, want):
    """``chunk_rows`` wins over the memory rule (which is then not asked)."""
    assert ak.chunk_rows_for(n, _no_query, chunk_rows) == want


def test_key_rows_are_padded_to_16_bytes():
    assert [ak.key_stride(n) for n in (1, 4, 2000, 8193, 32768)] == [4, 4, 2000, 8196, 32768]


def test_free_bytes_counts_the_allocators_unused_cache(monkeypatch):
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (10 * GB, 80 * GB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 6 * GB)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 2 * GB)
    free = ak.free_bytes(torch.device("cuda"))
    assert free == 14 * GB
    assert ak.chunk_rows_for(32768, lambda: free) == 32768
    assert ak.chunk_rows_for(32768, lambda: 2 * GB) == 8192


def test_cpu_call_asks_no_memory_and_runs_the_plain_version(monkeypatch):
    def no_query(device):
        raise AssertionError("the CPU path asked for device memory")
    monkeypatch.setattr(ak, "free_bytes", no_query)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-3, 4, size=(300, 8)).astype(np.float32))
    valid = torch.ones(300, dtype=torch.bool)
    before = ak.launches
    got = ak.knn_adjacency(x, valid, 7, "dot", chunk_rows=64)
    assert ak.launches == before
    assert torch.equal(got, ak.knn_adjacency_reference(x, valid, 7, "dot"))
    assert (got.sum(1) == 7).all()
