"""The engine's row-sharded layout: ``process_streaming_data(..., data_shards=4,
huge_window_layout="rows")`` on 4 gloo ranks of the CPU against the JAX
engine with the same configuration on its virtual CPU devices (mesh (4, 1)),
on mused_tpu's own seeded stream at window 64 (k_basis 3, reduced_dim 8, 4
windows): dense windows (the sharded window step) and forced onto the
blocked path (the ``rows`` sweep).

The JAX side's draws go to the ranks (``torch_dist.install_draws``): per
window the dense distributed SVD's test matrix, the blocked SVD's and
blocked spectral's, and the k-means++ centres as the row indices the JAX
engine drew (recorded here from its replicated reduction, or for dense
sSpectral from its embedding of the same fused matrix), so k-means starts
from the same points of the port's own reduction.  Tolerance: NMI and F1
within 0.02 of the JAX engine's.  SWFDMC runs under both merge topologies,
and sSVDMC_mini, the DBSCAN pair and the eigengap count with the background
bucket run to finite metrics, as the JAX package's tests hold them; every
rank reports the same metrics.  The scanned group dispatch
(``windows_per_batch`` 2 and 4) of SWFDMC, sSVDMC and sSVDMC_mini equals
per-window sharded dispatch exactly, and sSVDMC's equals the single-device
group run within 1e-6 (tests/test_parallel.py's scanned cases).

The same ranks then run the rank-0 write rule: a stream checkpointed on the
``columns`` and on the ``rows`` layout calls ``save_checkpoint`` on rank 0
only, and a run stopped after 2 windows and resumed equals the
uninterrupted run on every rank; a 4-rank sSVDMC stream checkpointed after
2 windows resumes on 2 ranks, processing only the remaining windows, equal
to the uninterrupted 4-rank run within 1e-6; a shared write that fails on
rank 0 raises on every rank.
"""
import contextlib
import functools
import io
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from mused_tpu import api as japi
from mused_tpu.engine import streaming as js
from mused_tpu.ops import kmeans as jkmeans
from mused_tpu.ops import spectral as jspectral
from mused_tpu.parallel import sharded as jsh
from mused_tpu.utils.config import PipelineConfig as JConfig
from mused_tpu_torch import api as tapi
from mused_tpu_torch.engine import streaming as ts
from mused_tpu_torch.utils.config import PipelineConfig
import torch_dist
from torch_parity import synthetic_window_stream

APPROACHES = ("sSVDMC", "sSVDMC_pot", "sSpectral")
PATHS = ("dense", "blocked")
# the other approaches the JAX engine runs on the rows layout (its
# tests/test_parallel.py holds them to finite metrics only)
OTHERS = (("sSVDMC_mini", "dense"), ("sSVDMC_mini", "blocked"), ("DBSCAN_incr", "dense"),
          ("DBSCAN_centr", "dense"), ("DBSCAN_centr", "blocked"))
# the scanned dispatch's runs: approach -> its per-window run's name
SCANNED = {"SWFDMC": "SWFDMC-dense-allgather", "sSVDMC": "sSVDMC-dense-plain",
           "sSVDMC_mini": "sSVDMC_mini-dense"}
WINDOW, SHARDS, RANK, KB = 64, 4, 8, 3
JOIN_TIMEOUT = 180


def _cfg_kw(approach, path, shards=SHARDS, **kw):
    return dict(window_size=WINDOW, reduced_dim=RANK, k_basis=KB, approach=approach,
                label_mode="binary", n_clusters_override=2, data_shards=shards,
                force_blocked_window=path == "blocked", eps=1.5, min_samples=2, seed=0, **kw)


def _rows_of(x, init, k):
    xs = np.asarray(x, np.float32)
    return [int(np.flatnonzero((xs == c).all(1))[0]) for c in np.asarray(init)[:int(k)]]


@functools.lru_cache(maxsize=None)
def _fuser(types, ndims, k_basis, tags_dim, text_dim, mesh):
    body = functools.partial(jsh._features_to_fused_shard, types=types, k_basis=k_basis,
                             tags_dim=tags_dim, text_dim=text_dim)
    specs = tuple(P(*(("data",) + (None,) * (d - 1))) for d in ndims)
    return jax.jit(jax.shard_map(lambda *s: body(s), mesh=mesh, in_specs=specs,
                                 out_specs=P("data", None), check_vma=False))


def _jax_run(stream, approach, path):
    """The JAX engine's metrics, and the row indices of the k-means++ centres
    it drew, per k-means call."""
    mods, mtypes, labels = stream
    calls = []
    orig_step, orig_kmeans = jsh.sharded_engine_step, jkmeans.kmeans

    def step(swfd_state, mb, feats, n_clusters, key, **kw):
        out = orig_step(swfd_state, mb, feats, n_clusters, key, **kw)
        k_max = kw["k_max"]
        if kw["approach"] == "sSpectral":
            fused = _fuser(kw["types"], tuple(f.ndim for f in feats), kw["k_basis"],
                           kw["tags_dim"], kw["text_dim"], kw["mesh"])(*feats)
            _, vecs = jspectral._normalized_spectrum(fused)
            x = jspectral._njw_embedding(vecs, n_clusters, k_max)
        else:
            x = out[2].astype(jnp.float32)
        init = jkmeans._kmeanspp_init(x, k_max, n_clusters, key)
        calls.append(_rows_of(x, init, n_clusters))
        return out

    def kmeans(x, k, key, *, k_max, **kw):       # the blocked path's k-means
        xs = jnp.asarray(np.asarray(x, np.float32))
        calls.append(_rows_of(xs, jkmeans._kmeanspp_init(xs, k_max, jnp.int32(k), key), k))
        return orig_kmeans(x, k, key, k_max=k_max, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsh, "sharded_engine_step", step)
        if path == "blocked":
            mp.setattr(jkmeans, "kmeans", kmeans)
        with contextlib.redirect_stdout(io.StringIO()):
            res = japi.process_streaming_data(
                results=japi.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, window_size=WINDOW, reduced_dim=RANK, k_basis=KB,
                n_clusters_total=2, seed=0, approach=approach, complete_true_labels=labels,
                step_window_ratio=1, noise_rate=0.5, label_mode="binary", sorting=True,
                eps=1.5, min_samples=2, cfg=JConfig(**_cfg_kw(approach, path)))
    return {k: res[k][0] for k in ("nmi_score", "nmi_e_score", "f1_score", "f1_aligned")}, calls


def _draws(calls, n_windows, path):
    """The JAX engine's draws for the ranks, per window ``fold_in(key(0), w)``."""
    keys = [jax.random.fold_in(jax.random.key(0), w) for w in range(n_windows)]

    def normal(width):
        return {w: np.asarray(jax.random.normal(k, (WINDOW, width), jnp.float32))
                for w, k in enumerate(keys)}

    if path == "dense":
        return {"dense_omega": normal(min(RANK + 10, WINDOW)), "kmeans": calls}
    return {"omega": normal(2 * RANK), "ritz": normal(10), "kmeans": calls}


@pytest.fixture(scope="module")
def runs():
    """The ranks start first and run each configuration as soon as the JAX
    engine has run it here (its draws posted to their inbox), then the
    checkpoint runs; a 2-rank group then resumes the elastic stream."""
    stream = synthetic_window_stream(seed=0)
    n_windows = len(ts.window_triggers(len(stream[2]), WINDOW, 1))
    names = [(a, p) for a in APPROACHES for p in PATHS]
    swfd = [(f"SWFDMC-{p}-{topo}", _cfg_kw("SWFDMC", p, merge_topology=topo))
            for p in PATHS for topo in ("allgather", "ring")]
    swfd += [(f"{a}-{p}", _cfg_kw(a, p)) for a, p in OTHERS]
    swfd.append(("sSVDMC-dense-eigengap-background",
                 _cfg_kw("sSVDMC", "dense", k_estimate="eigengap", background_bucket=True)))
    swfd.append(("sSVDMC-dense-plain", _cfg_kw("sSVDMC", "dense")))
    for w in (2, 4):
        swfd += [(f"{a}-dense-W{w}", _cfg_kw(a, "dense", windows_per_batch=w))
                 for a in SCANNED]
        swfd.append((f"sSVDMC-single-W{w}",
                     _cfg_kw("sSVDMC", "dense", shards=1, windows_per_batch=w)))
    with tempfile.TemporaryDirectory(prefix="mused_inbox_") as inbox, \
            tempfile.TemporaryDirectory(prefix="mused_ckpt_") as root:
        payload = {
            "stream": stream, "inbox": inbox, "count": len(names) + len(swfd),
            "ckpt_root": root,
            "checkpoint_cases": [
                ("columns", _cfg_kw("SWFDMC", "blocked", huge_window_layout="columns")),
                ("rows", _cfg_kw("SWFDMC", "dense")),
                ("rows-blocked", _cfg_kw("sSVDMC", "blocked"))],
            "elastic": ("elastic", _cfg_kw("sSVDMC", "dense"))}
        ranks = torch_dist.start("engine_and_checkpoint_runs", payload, world=SHARDS)
        jax_metrics = {}
        try:
            for i, (name, kw) in enumerate(swfd):
                torch_dist.post(inbox, i, (name, kw, {}))
            for i, (approach, path) in enumerate(names, start=len(swfd)):
                name = f"{approach}-{path}"
                jax_metrics[name], calls = _jax_run(stream, approach, path)
                torch_dist.post(inbox, i, (name, _cfg_kw(approach, path),
                                           _draws(calls, n_windows, path)))
        except BaseException:
            ranks.terminate()
            raise
        four = ranks.join(JOIN_TIMEOUT)
        two = torch_dist.start("elastic_resume", payload, world=2).join(JOIN_TIMEOUT)
    return {"jax": jax_metrics, "ranks": four, "elastic": two}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("approach", APPROACHES)
def test_engine_matches_jax(runs, approach, path):
    name = f"{approach}-{path}"
    got, want = runs["ranks"][0][name], runs["jax"][name]
    for key in ("nmi_score", "f1_score"):
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= 0.02, (key, got, want)


@pytest.mark.parametrize("topology", ["allgather", "ring"])
@pytest.mark.parametrize("path", PATHS)
def test_swfdmc_runs_under_both_merge_topologies(runs, path, topology):
    got = runs["ranks"][0][f"SWFDMC-{path}-{topology}"]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in got.values()), got


@pytest.mark.parametrize("name", [f"{a}-{p}" for a, p in OTHERS]
                         + ["sSVDMC-dense-eigengap-background"])
def test_every_other_approach_runs_on_the_rows_layout(runs, name):
    got = runs["ranks"][0][name]
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in got.values()), got


def test_every_rank_reports_the_same_metrics(runs):
    def metrics(res):
        out = {k: v for k, v in res.items() if k not in ("checkpoint", "write_once")}
        for name, r in res["checkpoint"].items():
            out[name] = (r.get("resumed"), r["straight"])
        return out

    for other in runs["ranks"][1:]:
        assert metrics(other) == metrics(runs["ranks"][0])


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("approach", list(SCANNED))
def test_sharded_groups_equal_per_window_sharded_dispatch(runs, approach, w):
    got = runs["ranks"][0][f"{approach}-dense-W{w}"]
    assert got == runs["ranks"][0][SCANNED[approach]]
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_groups_equal_the_single_device_groups(runs, w):
    got, want = (runs["ranks"][0][f"sSVDMC-{where}-W{w}"] for where in ("dense", "single"))
    for key in ("nmi_score", "f1_score"):
        assert got[key] == pytest.approx(want[key], abs=1e-6)


@pytest.mark.parametrize("layout", ["columns", "rows", "rows-blocked"])
def test_only_rank0_writes_checkpoints_and_resume_equals_the_run(runs, layout):
    for rank, res in enumerate(runs["ranks"]):
        r = res["checkpoint"][layout]
        assert r["stopped"] is None
        assert r["saves_before_stop"] == (2 if rank == 0 else 0), (rank, r)
        assert r["saves"] == (4 if rank == 0 else 0), (rank, r)
        assert r["processed"] == 2, r
        for key in ("nmi_score", "f1_score"):
            assert r["resumed"][key] == pytest.approx(r["straight"][key], abs=1e-6)


def test_write_once_writes_on_rank0_and_a_failed_write_raises_everywhere(runs):
    """Every rank reads the file as soon as ``write_once`` returns, rank 0
    alone wrote it; a write that fails on rank 0 raises on every rank, so
    none waits for it."""
    for rank, res in enumerate(runs["ranks"]):
        r = res["write_once"]
        assert r["writes"] == (1 if rank == 0 else 0), (rank, r)
        assert r["read_back"] == "written by rank 0"
        kind, msg = r["raised"]
        assert kind == ("OSError" if rank == 0 else "RuntimeError"), (rank, r)
        assert "no space left on device" in msg


def test_elastic_resume_on_fewer_ranks(runs):
    """Checkpointed on 4 ranks after 2 windows, resumed on 2: only the
    remaining windows run, and the metrics equal the 4-rank run's."""
    straight = runs["ranks"][0]["checkpoint"]["elastic"]["straight"]
    for metrics, processed in runs["elastic"]:
        assert processed == 2
        for key in ("nmi_score", "f1_score"):
            assert metrics[key] == pytest.approx(straight[key], abs=1e-6)


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

def test_uneven_rows_raise_the_jax_message():
    kw = dict(window_size=65, data_shards=8)
    with pytest.raises(ValueError, match="divisible") as jerr:
        js.StreamingEngine(JConfig(**kw))
    with pytest.raises(ValueError) as terr:
        ts.StreamingEngine(PipelineConfig(**kw), "cpu")
    assert str(terr.value) == str(jerr.value)


def test_ring_topology_runs_on_one_device():
    """``merge_topology`` passes through: on one device there is nothing to
    merge, and the run equals the allgather run."""
    mods, mtypes, labels = synthetic_window_stream(seed=0)
    out = []
    for topology in ("allgather", "ring"):
        with contextlib.redirect_stdout(io.StringIO()):
            res = tapi.process_streaming_data(
                tapi.get_initial_results()[0], mods, mtypes, 64, 8, 3, 2, 0, "SWFDMC",
                labels, 1, 0.5, "binary", True, 1.5, 2, merge_topology=topology,
                device="cpu")
        out.append((res["nmi_score"][0], res["f1_score"][0]))
    assert out[0] == out[1]
