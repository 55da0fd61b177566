"""The port's batch engine vs ``mused_tpu.api.process_batch_data``, on the
CPU.

Both packages run the same subset: mused_tpu's own seeded SED-like stream
(256 rows, the five standard modalities) and a crisis embedding stream
(192 rows, two numeric modalities).  The port draws the JAX package's
random numbers (``torch_parity.inject_jax_draws``: from ``key(seed)`` the
SVD test matrix, blocked spectral's probe and the k-means++ init), and then
every metric equals the JAX package's, for the four batch approaches and an
unknown name (which runs the SVD and k-means, as in the reference), on:
  * the dense path (the fused (n, n) graph);
  * the blocked path, forced (``force_blocked_batch``) with ``BLOCK_ROWS``
    lowered to 96 in both packages so that the 256 rows pad to 288 with
    invalid rows, and reached by size on the crisis stream with
    ``MAX_DENSE_ROWS`` lowered to 100 in both, as the JAX package's tests
    do (its 192 rows make 2 blocks of 96).
No draw is left uninjected, so no comparison here needs a tolerance.
"""
import contextlib
import io

import pytest
import torch

from mused_tpu import api as japi
from mused_tpu.data.synthetic import crisis_embedding_stream
from mused_tpu.engine import batch as jb
from mused_tpu.utils.config import PipelineConfig as JConfig
from mused_tpu_torch import api as tapi
from mused_tpu_torch.engine import batch as tb
from mused_tpu_torch.utils.config import PipelineConfig as TConfig
from torch_parity import inject_jax_draws, synthetic_window_stream

APPROACHES = ["SVDMC_batch", "DBSCAN_batch", "HDBSCAN_batch", "Spectral_batch",
              "no_such_approach"]
SED = dict(reduced_dim=8, k_basis=3, n_clusters=2, seed=0, noise_rate=0.5,
           label_mode="binary", sorting=True, eps=1.5, min_samples=2, min_cluster_size=3,
           window_size=64)
CRISIS = dict(reduced_dim=8, k_basis=4, n_clusters=4, seed=0, noise_rate=0.2,
              label_mode="all", sorting=False, eps=0.5, min_samples=3, min_cluster_size=3,
              window_size=64)


@pytest.fixture(scope="module")
def sed():
    return synthetic_window_stream(seed=0)


@pytest.fixture(scope="module")
def crisis():
    return crisis_embedding_stream(n_rows=192, n_events=3, noise_rate=0.2, d_text=32,
                                   d_image=32, seed=6)


def _both(stream, approach, kw, **cfg_kw):
    """(port results, JAX results) of one batch run, the JAX draws injected."""
    mods, mtypes, labels = stream
    runs = []
    for api, config, extra in ((tapi, TConfig, {"device": "cpu"}), (japi, JConfig, {})):
        cfg = config(approach=approach, reduced_dim=kw["reduced_dim"],
                     k_basis=kw["k_basis"], eps=kw["eps"], min_samples=kw["min_samples"],
                     min_cluster_size=kw["min_cluster_size"], label_mode=kw["label_mode"],
                     **cfg_kw)
        with contextlib.redirect_stdout(io.StringIO()):
            runs.append(api.process_batch_data(
                results=api.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, approach=approach, complete_true_labels=labels,
                cfg=cfg, **kw, **extra))
    return runs


def _assert_same_metrics(got, want):
    keys = [k for k in want if "time" not in k]
    assert keys and set(keys) <= set(got)
    for k in keys:
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("approach", APPROACHES)
def test_dense_path_matches_jax(approach, sed, monkeypatch):
    inject_jax_draws(monkeypatch)
    got, want = _both(sed, approach, SED)
    _assert_same_metrics(got, want)


@pytest.mark.parametrize("approach", APPROACHES)
def test_forced_blocked_path_with_padding_matches_jax(approach, sed, monkeypatch):
    monkeypatch.setattr(tb, "BLOCK_ROWS", 96)
    monkeypatch.setattr(jb, "BLOCK_ROWS", 96)
    inject_jax_draws(monkeypatch)
    got, want = _both(sed, approach, SED, force_blocked_batch=True)
    _assert_same_metrics(got, want)


@pytest.mark.parametrize("approach", APPROACHES)
def test_blocked_path_by_size_matches_jax(approach, crisis, monkeypatch):
    for mod in (tb, jb):
        monkeypatch.setattr(mod, "MAX_DENSE_ROWS", 100)
        monkeypatch.setattr(mod, "BLOCK_ROWS", 96)
    inject_jax_draws(monkeypatch)
    got, want = _both(crisis, approach, CRISIS)
    _assert_same_metrics(got, want)


def test_paths_and_cfg_as_the_single_source_of_truth(sed, monkeypatch):
    """The dense path fuses through the streaming engine and the blocked path
    sweeps blocks, each taking reduced_dim / k_basis / eps / min_samples from
    ``cfg`` over the positional arguments (JAX batch.py:106-112); without a
    ``cfg`` the arguments build one."""
    mods, mtypes, labels = sed
    seen = {}
    orig_dense, orig_blocked = tb.StreamingEngine.fused_adjacency, tb._blocked_reduce

    def dense_spy(self, window_modalities, modality_types):
        seen["dense"] = (self.cfg.window_size, self.cfg.k_basis)
        return orig_dense(self, window_modalities, modality_types)

    def blocked_spy(data_modalities, modality_types, cfg, generator, device):
        seen["blocked"] = (cfg.reduced_dim, cfg.k_basis)
        return orig_blocked(data_modalities, modality_types, cfg, generator, device)

    monkeypatch.setattr(tb.StreamingEngine, "fused_adjacency", dense_spy)
    monkeypatch.setattr(tb, "_blocked_reduce", blocked_spy)
    kw = dict(SED, reduced_dim=99, k_basis=99)
    with contextlib.redirect_stdout(io.StringIO()):
        for forced in (False, True):
            cfg = TConfig(reduced_dim=6, k_basis=3, force_blocked_batch=forced)
            res = tapi.process_batch_data(tapi.get_initial_results()[0], mods, mtypes,
                                          approach="SVDMC_batch", complete_true_labels=labels,
                                          cfg=cfg, device="cpu", **kw)
            assert res["reduced_dim"] == [6] and res["k_basis"] == [3]
        res = tapi.process_batch_data(tapi.get_initial_results()[0], mods, mtypes,
                                      approach="SVDMC_batch", complete_true_labels=labels,
                                      device="cpu", **SED)
    assert seen == {"dense": (256, 3), "blocked": (6, 3)}
    assert res["reduced_dim"] == [8] and 0.0 <= res["nmi_score"][0] <= 1.0
    if not torch.cuda.is_available():        # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.process_batch_data(None, mods, mtypes, approach="SVDMC_batch",
                                    complete_true_labels=labels, **SED)
