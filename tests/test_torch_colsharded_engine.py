"""The engine's column-sharded huge-window layouts: ``process_streaming_data(...,
data_shards=4, huge_window_layout="columns" | "grid")`` on 4 gloo ranks of
the CPU against the JAX engine with the same configuration on its 8 virtual
CPU devices (mesh (4, 1), and the (2, 2) grid with huge_window_col_shards 2),
on mused_tpu's own seeded stream at window 64 forced onto the blocked path
(k_basis 3, reduced_dim 8, 4 windows).

The JAX side's draws go to the ranks (``torch_dist.install_draws``): the FD
probe, per window the blocked SVD's test matrix and blocked spectral's
probe, and the k-means++ centres as the row indices the JAX engine drew
(recorded here, so k-means starts from the same points of the port's own
reduction).  Tolerance: NMI and F1 within 0.02 of the JAX engine's, as the
single-device huge-window parity tests (the reductions sum in another
order across the shards).  Every rank reports the same metrics.
"""
import contextlib
import io
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mused_tpu import api as japi
from mused_tpu.engine import streaming as js
from mused_tpu.ops import kmeans as jkmeans
from mused_tpu.utils.config import PipelineConfig as JConfig
from mused_tpu_torch import api as tapi
from mused_tpu_torch.engine import streaming as ts
from mused_tpu_torch.utils.config import PipelineConfig
import torch_dist
from torch_parity import jax_probe, synthetic_window_stream

APPROACHES = ("SWFDMC", "sSVDMC", "sSpectral", "DBSCAN_centr")
LAYOUTS = {"columns": 0, "grid": 2}
WINDOW, SHARDS, RANK, KB = 64, 4, 8, 3


def _cfg_kw(approach, layout):
    return dict(window_size=WINDOW, reduced_dim=RANK, k_basis=KB, approach=approach,
                label_mode="binary", n_clusters_override=2, data_shards=SHARDS,
                force_blocked_window=True, huge_window_layout=layout,
                huge_window_col_shards=LAYOUTS[layout], eps=1.5, min_samples=2, seed=0)


def _jax_run(stream, approach, layout):
    """The JAX engine's metrics, and the row indices of the k-means++
    centres it drew, per k-means call."""
    mods, mtypes, labels = stream
    calls = []
    orig = jkmeans.kmeans

    def spy(x, k, key, *, k_max, **kw):
        xs = np.asarray(x, np.float32)
        init = np.asarray(jkmeans._kmeanspp_init(jnp.asarray(xs), k_max, jnp.int32(k), key))
        calls.append([int(np.flatnonzero((xs == c).all(1))[0]) for c in init[:int(k)]])
        return orig(x, k, key, k_max=k_max, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkmeans, "kmeans", spy)
        with contextlib.redirect_stdout(io.StringIO()):
            res = japi.process_streaming_data(
                results=japi.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, window_size=WINDOW, reduced_dim=RANK, k_basis=KB,
                n_clusters_total=2, seed=0, approach=approach, complete_true_labels=labels,
                step_window_ratio=1, noise_rate=0.5, label_mode="binary", sorting=True,
                eps=1.5, min_samples=2, cfg=JConfig(**_cfg_kw(approach, layout)))
    return {k: res[k][0] for k in ("nmi_score", "nmi_e_score", "f1_score", "f1_aligned")}, calls


def _draws(calls, n_windows):
    """The JAX engine's draws for the ranks: FD probes (each block's absorb
    and the grid's merge), per window ``fold_in(key(0), w)``'s SVD test
    matrix and Ritz probe, the k-means++ rows."""
    block = WINDOW // SHARDS
    n_pad = WINDOW        # 64 rows already tile 4 shards of 16-row blocks
    probes = {(m2, min(RANK + 16, m2)): jax_probe(m2, min(RANK + 16, m2))
              for m2 in (RANK + block, 2 * RANK)}
    keys = [jax.random.fold_in(jax.random.key(0), w) for w in range(n_windows)]
    omega = {w: np.asarray(jax.random.normal(k, (n_pad, 2 * RANK), jnp.float32))
             for w, k in enumerate(keys)}
    ritz = {w: np.asarray(jax.random.normal(k, (n_pad, 10), jnp.float32))
            for w, k in enumerate(keys)}
    return {"probes": probes, "omega": omega, "ritz": ritz, "kmeans": calls}


@pytest.fixture(scope="module")
def runs():
    """The ranks start first and run each configuration as soon as the JAX
    engine has run it here (its draws posted to their inbox)."""
    stream = synthetic_window_stream(seed=0)
    n_windows = len(ts.window_triggers(len(stream[2]), WINDOW, 1))
    names = [(a, lay) for a in APPROACHES for lay in LAYOUTS]
    with tempfile.TemporaryDirectory(prefix="mused_inbox_") as inbox:
        ranks = torch_dist.start("engine_runs", {"stream": stream, "inbox": inbox,
                                                 "count": len(names)}, world=SHARDS)
        jax_metrics = {}
        try:
            for i, (approach, layout) in enumerate(names):
                name = f"{approach}-{layout}"
                jax_metrics[name], calls = _jax_run(stream, approach, layout)
                torch_dist.post(inbox, i, (name, _cfg_kw(approach, layout),
                                           _draws(calls, n_windows)))
        except BaseException:
            ranks.terminate()
            raise
        return {"jax": jax_metrics, "ranks": ranks.join()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("approach", APPROACHES)
def test_engine_matches_jax(runs, approach, layout):
    name = f"{approach}-{layout}"
    got, want = runs["ranks"][0][name], runs["jax"][name]
    for key in ("nmi_score", "f1_score"):
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= 0.02, (key, got, want)


def test_every_rank_reports_the_same_metrics(runs):
    for other in runs["ranks"][1:]:
        assert other == runs["ranks"][0]


# the JAX package's own validation cases (tests/test_colsharded.py)
VALIDATION = {
    "huge_window_layout": dict(window_size=64, huge_window_layout="diagonal"),
    "contradictory": dict(window_size=64, huge_window_layout="columns",
                          huge_window_fused_select=False),
    "col_shards": dict(window_size=64, data_shards=4, force_blocked_window=True,
                       approach="SWFDMC", huge_window_layout="grid",
                       huge_window_col_shards=3),
    "dense windows (grid)": dict(window_size=64, data_shards=4, huge_window_layout="grid",
                                 huge_window_col_shards=2),
    "dense windows (columns)": dict(window_size=64, data_shards=4,
                                    huge_window_layout="columns"),
    "data_shards > 1": dict(window_size=64, force_blocked_window=True, approach="SWFDMC",
                            huge_window_layout="columns"),
    "factorization": dict(window_size=70, data_shards=7, force_blocked_window=True,
                          approach="SWFDMC", huge_window_layout="grid"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_engine_columns_layout_validation(case):
    """Each of the JAX engine's refusals, with its message."""
    kw = VALIDATION[case]
    with pytest.raises(ValueError, match=case.split(" (")[0]) as jerr:
        js.StreamingEngine(JConfig(**kw))
    with pytest.raises(ValueError) as terr:
        ts.StreamingEngine(PipelineConfig(**kw), "cpu")
    assert str(terr.value) == str(jerr.value)


def test_rows_layout_over_shards_is_slice_4b():
    """Slice 4b runs the rows layout over shards (tests/test_torch_sharded_engine.py);
    like the column layouts, it needs a process group of data_shards ranks."""
    for kw in (dict(window_size=64, data_shards=4),
               dict(window_size=64, data_shards=4, force_blocked_window=True)):
        with pytest.raises(ValueError, match="process group of 4 ranks"):
            ts.StreamingEngine(PipelineConfig(**kw), "cpu")
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        tapi.process_streaming_data(None, [np.zeros((64, 2))] * 5, ts.STANDARD_TYPES,
                                    64, 8, 3, 2, 0, "SWFDMC", np.zeros(64), 1, 0.5,
                                    "binary", True, 1.5, 2, data_shards=4,
                                    merge_topology="ring", device="cpu")


def test_column_layout_needs_a_process_group_of_data_shards_ranks():
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        ts.StreamingEngine(PipelineConfig(**_cfg_kw("SWFDMC", "columns")), "cpu")


def test_auto_col_shards_matches_jax():
    for p in range(1, 65):
        assert ts._auto_col_shards(p) == js._auto_col_shards(p)
