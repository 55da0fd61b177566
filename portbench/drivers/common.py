"""What the drivers share: the record of a window, the draw of what the
check compares, the configuration's records, the reference's featurization
of one window, and the check of a blocked window."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import tap as tap_mod
from portbench import trace as trace_mod
from portbench.gen import sed2012_synth
from portbench.reference import features, graphs, judge


@dataclasses.dataclass
class WindowRecord:
    """One measured window, as the metric readers see it."""

    window_s: float
    attempted: int
    failed: int
    end_to_end: dict
    windows: int = 0                 # stream windows completed in the window
    trace: object = None             # trace.TraceSummary of a traced run
    syncs: int | None = None         # host waits on the device (traced run)
    spans: dict = dataclasses.field(default_factory=dict)   # name -> [seconds]
    latencies_ms: list = dataclasses.field(default_factory=list)
    k1_bound_s: float | None = None
    k23_bound_s: float | None = None


def closed_loop(call, seconds: float, min_calls: int, trace: bool):
    """Calls ``call(i)`` one after another, at least ``min_calls`` times and
    until one ends past ``seconds``: (calls, tracer, sync counter or None)."""
    syncs = tap_mod.SyncCounter() if trace else None
    calls = 0
    with trace_mod.Tracer(trace) as tracer:
        if syncs:
            syncs.__enter__()
        t0 = time.perf_counter()
        while calls < min_calls or time.perf_counter() - t0 < seconds:
            call(calls)
            calls += 1
        if syncs:
            syncs.__exit__(None, None, None)
    return calls, tracer, syncs


def merged(cell, overrides: dict) -> tuple[dict, dict]:
    """The cell's configuration and traffic with test overrides applied."""
    return ({**cell.config, **overrides.get("config", {})},
            {**cell.traffic, **overrides.get("traffic", {})})


def draw(seed: int, population: int, k: int, salt: int) -> list:
    """``k`` distinct indices of ``population``, drawn from the seed."""
    rng = np.random.default_rng([seed % 2**63, salt])
    return sorted(rng.choice(population, size=min(k, population), replace=False).tolist())


def make_records(cfg: dict, n: int, seed: int):
    """``n`` seeded SED2012-shaped records: (modalities, labels)."""
    mods, _, labels = sed2012_synth.make_stream(
        n, n_events=cfg["n_events"], noise_rate=cfg["noise_rate"],
        binary=cfg["label_mode"] == "binary", sort_by_uploaded=cfg["sort_by_uploaded"],
        seed=seed)
    return mods, labels


def featurize(cfg: dict, mods, pad_to: int | None = None) -> features.Records:
    return features.featurize(mods, tags_hash_dim=cfg["tags_hash_dim"],
                              text_hash_dim=cfg["text_hash_dim"],
                              tags_token_cap=cfg["tags_token_cap"],
                              text_token_cap=cfg["text_token_cap"], pad_to=pad_to)


def panels(cfg: dict, rec, device, dtype=torch.float64, text_bf16=False) -> graphs.Panels:
    return graphs.Panels(rec, tags_hash_dim=cfg["tags_hash_dim"],
                         text_hash_dim=cfg["text_hash_dim"], device=device, dtype=dtype,
                         text_bf16=text_bf16)


def slice_rows(mods, lo: int, hi: int) -> list:
    return [m[lo:hi] for m in mods]


class Sparse:
    """A 0/1 (n, n) matrix assembled from row blocks, for float64 products
    with its transpose (and, built ``both``, with itself)."""

    def __init__(self, n: int, device):
        self.n, self.device = n, device
        self.rows, self.cols = [], []

    def add(self, lo: int, block: torch.Tensor) -> None:
        r, c = torch.nonzero(block, as_tuple=True)
        self.rows.append(r + lo)
        self.cols.append(c)

    def done(self, both: bool = False) -> "Sparse":
        r, c = torch.cat(self.rows), torch.cat(self.cols)
        del self.rows, self.cols
        ones = torch.ones(len(r), dtype=torch.float64, device=self.device)

        def csr(i, j):
            return torch.sparse_coo_tensor(torch.stack([i, j]), ones, (self.n, self.n),
                                           check_invariants=False).coalesce().to_sparse_csr()

        self.at = csr(c, r)
        self.a = csr(r, c) if both else None
        return self

    def tmul(self, v: torch.Tensor) -> torch.Tensor:
        return self.at @ v

    def mul(self, v: torch.Tensor) -> torch.Tensor:
        return self.a @ v


def blocked_check(cfg: dict, rec, packed_blocks: dict, reduced: torch.Tensor,
                  labels: np.ndarray, *, block: int, nbins: int, device) -> dict:
    """The numbers of a huge window or a blocked batch: the program's row
    blocks against the reference's, the program's SVD against the program's
    graph and against the reference graph's top singular values, its labels
    against the embedding it clustered."""
    n = len(rec.latlon)
    p = panels(cfg, rec, device, text_bf16=True)
    prog, ref = Sparse(n, device), Sparse(n, device)
    diff = edges = 0
    for lo in range(0, n, block):
        mine = graphs.binned_block(p, lo, lo + block, cfg["k_basis"], nbins)
        ref.add(lo, mine)
        edges += int(mine.sum())
        theirs = packed_blocks.get(lo)
        if theirs is None:
            diff += int(mine.sum())
        else:
            diff += graphs.popcount(graphs.packbits(mine) ^ theirs)
            prog.add(lo, graphs.unpackbits(theirs))
        del mine
    del p
    u = torch.zeros((n, reduced.shape[1]), dtype=torch.float64, device=device)
    u[:rec.n_real] = reduced[:rec.n_real].double()
    identity = judge.svd_identity(u, prog.done().tmul)
    del prog
    ref.done(both=True)
    energy = judge.top_energy(ref.mul, ref.tmul, n, cfg["reduced_dim"], device=device)
    del ref
    return {"graph_mismatch": judge.graph_mismatch(diff, edges),
            "svd_identity": identity,
            "svd_energy_gap": judge.svd_energy_gap(u, energy),
            "label_cost_excess": judge.label_cost_excess(labels, u[:rec.n_real])}
