"""Run the port's SPMD layouts on a gloo process group of CPU ranks — the
helpers of tests/test_torch_colsharded*.py and tests/test_torch_sharded*.py.

The JAX package holds its mesh layouts on 8 virtual CPU devices in one
process; the port runs one process per device, so its tests start ranks:
:func:`start` spawns ``world`` processes (spawn, never fork: the parent
holds JAX's threads) joined in one gloo group, and each runs one of the
rank functions below on a payload of numpy arrays and returns numpy
results.  Ranks import only torch, numpy and the port.  Random draws the
JAX side makes (FD probe, SVD test matrix, Ritz probe, k-means++ centres)
arrive in the payload: ``torch_parity.inject_jax_draws`` patches only the
process it runs in.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile


def _to_numpy(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def _entry(rank: int, world: int, init: str, fn_name: str, payload, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        result = globals()[fn_name](rank, payload)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(_to_numpy(result), f)


class Ranks:
    """A started group of ranks; :meth:`join` waits and returns each rank's
    result, in rank order, or stops them all and raises when they take
    longer than its timeout (a collective one rank never reaches hangs the
    others)."""

    def __init__(self, fn_name: str, payload, world: int):
        import torch.multiprocessing as mp
        self._dir = tempfile.mkdtemp(prefix="mused_ranks_")
        self.world = world
        init = f"file://{os.path.join(self._dir, 'store')}"
        self._ctx = mp.start_processes(_entry, args=(world, init, fn_name, payload, self._dir),
                                       nprocs=world, join=False, start_method="spawn")

    def join(self, timeout: float = 600.0) -> list:
        import time
        deadline = time.monotonic() + timeout
        try:
            while not self._ctx.join(max(1.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    for p in self._ctx.processes:
                        if p.is_alive():
                            p.terminate()
                    raise TimeoutError(f"the {self.world} ranks did not finish in "
                                       f"{timeout:.0f} s")
            out = []
            for r in range(self.world):
                with open(os.path.join(self._dir, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)

    def terminate(self) -> None:
        """Stop every rank (a parent that failed before feeding them)."""
        for p in self._ctx.processes:
            if p.is_alive():
                p.terminate()
        shutil.rmtree(self._dir, ignore_errors=True)


def start(fn_name: str, payload, world: int = 4) -> Ranks:
    """Start ``world`` ranks running ``fn_name(rank, payload)`` (a function of
    this module); call ``.join()`` for the results."""
    return Ranks(fn_name, payload, world)


# ---------------------------------------------------------------------------
# draws injected into a rank
# ---------------------------------------------------------------------------

def install_draws(draws: dict) -> None:
    """Patch the port's draw points in this rank: ``probes`` {(m2, r): array}
    for ``fd.default_probe``; per window w, ``omega`` {w: (n, r)} for the
    blocked SVD, ``dense_omega`` {w: (n, k)} for the row-sharded dense SVD
    and ``ritz`` {w: (n, m)} for blocked spectral; ``kmeans`` [row indices
    per call] for the k-means++ centres of k-means and row-sharded k-means,
    in call order (k-means starts from those rows of its own points)."""
    import torch
    from mused_tpu_torch.engine import streaming as ts
    from mused_tpu_torch.ops import blocked_affinity as ba
    from mused_tpu_torch.ops import blocked_spectral as bspec
    from mused_tpu_torch.ops import fd
    from mused_tpu_torch.ops import kmeans as km
    from mused_tpu_torch.parallel import kmeans_sharded as ks
    from mused_tpu_torch.parallel import sharded

    if "probes" in draws:
        probes = draws["probes"]
        fd.default_probe = lambda m2, r, device: torch.from_numpy(probes[(m2, r)]).to(device)
    current = {"w": None, "kmeans": 0}
    orig_gen, orig_svd = ts.window_generator, ba.randomized_svd_from_products
    orig_ritz, orig_kmeans = bspec.ritz_from_products, km.kmeans

    def window_generator(seed, window_index, device):
        current["w"] = window_index
        return orig_gen(seed, window_index, device)

    def svd(mul_a, mul_at, generator, *, n, rank, oversample=8, n_iter=2, device=None,
            omega=None):
        omega = torch.from_numpy(draws["omega"][current["w"]]).to(device)
        return orig_svd(mul_a, mul_at, generator, n=n, rank=rank, oversample=oversample,
                        n_iter=n_iter, device=device, omega=omega)

    def ritz(sym_matmul, inv_sqrt, generator, *, n, m, n_iter=6, probe=None):
        probe = torch.from_numpy(draws["ritz"][current["w"]]).to(inv_sqrt.device)
        return orig_ritz(sym_matmul, inv_sqrt, generator, n=n, m=m, n_iter=n_iter,
                         probe=probe)

    def init_rows(x, k_max):
        idx = draws["kmeans"][current["kmeans"]]
        current["kmeans"] += 1
        init = torch.zeros((k_max, x.shape[1]), dtype=torch.float32, device=x.device)
        init[:len(idx)] = x.float()[torch.as_tensor(idx, device=x.device)]
        return init

    def kmeans(x, k, generator=None, *, k_max, **kw):
        return orig_kmeans(x, k, generator, k_max=k_max, init=init_rows(x, k_max), **kw)

    def kmeans_sharded(x, k, generator=None, *, k_max, mesh, **kw):
        return orig_kmeans_sharded(x, k, generator, k_max=k_max, mesh=mesh,
                                   init=init_rows(x, k_max), **kw)

    def dist_svd(fused_s, generator, reduced_dim, axis, **kw):
        kw["omega"] = torch.from_numpy(draws["dense_omega"][current["w"]])
        return orig_dist_svd(fused_s, generator, reduced_dim, axis, **kw)

    orig_kmeans_sharded, orig_dist_svd = ks.kmeans_sharded, sharded._dist_svd_reduce
    ts.window_generator = window_generator
    if "omega" in draws:
        ba.randomized_svd_from_products = svd
    if "ritz" in draws:
        bspec.ritz_from_products = ritz
    if "kmeans" in draws:
        km.kmeans = kmeans
        ks.kmeans_sharded = kmeans_sharded
    if "dense_omega" in draws:
        sharded._dist_svd_reduce = dist_svd


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def colsharded_cases(rank: int, payload: dict) -> dict:
    """Run ``payload["cases"]``: (name, entry point of parallel/colsharded,
    mesh shape, features key, keyword arguments) each; arrays named by
    ``payload["tensors"]`` keys in the keywords (``"omega"``, ``"probe"``)
    become tensors.  Returns {name: result}."""
    import torch
    from mused_tpu_torch.parallel import colsharded as cs
    from mused_tpu_torch.parallel import mesh

    install_draws({"probes": payload["probes"]})
    meshes = {}
    out = {}
    for name, fn_name, shape, feats_key, kw in payload["cases"]:
        if shape not in meshes:
            meshes[shape] = mesh.make_mesh(*shape, "cpu")
        kw = {k: (torch.from_numpy(payload["tensors"][v]) if k in ("omega", "probe") else v)
              for k, v in kw.items()}
        fn = getattr(cs, fn_name)
        feats, types = payload["feats"][feats_key]
        args = (feats, types) if fn_name in ("colsharded_fused_rows",
                                             "colsharded_blocked_fd_sketch") \
            else (feats, types, None)
        out[name] = fn(*args, mesh=meshes[shape], **kw)
    return out


def post(directory: str, index: int, item) -> None:
    """Hand item ``index`` to ranks waiting in :func:`receive` (written whole,
    then renamed, so a rank never reads half a file)."""
    path = os.path.join(directory, f"{index}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(item, f)
    os.replace(path + ".tmp", path)


def receive(directory: str, index: int, timeout: float = 600.0):
    """Item ``index`` of :func:`post`, once it is there."""
    import time
    path = os.path.join(directory, f"{index}.pkl")
    t_end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > t_end:
            raise TimeoutError(f"no item {index} in {directory}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def engine_runs(rank: int, payload: dict) -> dict:
    """``process_streaming_data(..., device="cpu")`` on ``payload["stream"]``
    for each of ``payload["count"]`` runs (name, PipelineConfig keywords,
    injected draws), received one by one from ``payload["inbox"]`` (the
    parent posts a run as soon as the JAX side has made its draws); returns
    {name: the metrics}."""
    import contextlib
    import io

    from mused_tpu_torch import api
    from mused_tpu_torch.engine import streaming as ts
    from mused_tpu_torch.ops import blocked_affinity as ba
    from mused_tpu_torch.ops import blocked_spectral as bspec
    from mused_tpu_torch.ops import fd
    from mused_tpu_torch.ops import kmeans as km
    from mused_tpu_torch.parallel import kmeans_sharded as ks
    from mused_tpu_torch.parallel import sharded
    from mused_tpu_torch.utils.config import PipelineConfig

    saved = (fd.default_probe, ts.window_generator, ba.randomized_svd_from_products,
             bspec.ritz_from_products, km.kmeans, ks.kmeans_sharded, sharded._dist_svd_reduce)

    def restore():
        (fd.default_probe, ts.window_generator, ba.randomized_svd_from_products,
         bspec.ritz_from_products, km.kmeans, ks.kmeans_sharded,
         sharded._dist_svd_reduce) = saved

    mods, mtypes, labels = payload["stream"]
    out = {}
    try:
        for i in range(payload["count"]):
            name, cfg_kw, draws = receive(payload["inbox"], i)
            restore()
            install_draws(draws)
            cfg = PipelineConfig(**cfg_kw)
            with contextlib.redirect_stdout(io.StringIO()):
                res = api.process_streaming_data(
                    results=api.get_initial_results()[0], data_modalities=mods,
                    modality_types=mtypes, window_size=cfg.window_size,
                    reduced_dim=cfg.reduced_dim, k_basis=cfg.k_basis, n_clusters_total=2,
                    seed=cfg.seed, approach=cfg.approach, complete_true_labels=labels,
                    step_window_ratio=1, noise_rate=0.5, label_mode="binary", sorting=True,
                    eps=cfg.eps, min_samples=cfg.min_samples, cfg=cfg, device="cpu")
            out[name] = {k: res[k][0] for k in ("nmi_score", "nmi_e_score", "f1_score",
                                                "f1_aligned")}
    finally:
        restore()
    return out


def sharded_cases(rank: int, payload: dict) -> dict:
    """The row-sharded modules' cases (tests/test_torch_sharded.py) on a (4, 1)
    mesh: sketch merges, ``ppermute``, row-sharded k-means, the dense fused
    shard, the distributed SVD, the huge-window ``rows`` entry points and
    the demonstration step.  Returns {name: result}."""
    import numpy as np
    import torch
    from mused_tpu_torch.data import features as tfeat
    from mused_tpu_torch.parallel import kmeans_sharded as ks
    from mused_tpu_torch.parallel import mesh, sharded
    from mused_tpu_torch.parallel import sketch_merge as sm
    from mused_tpu_torch.ops import blocked_affinity as ba

    def T(a):
        return torch.from_numpy(np.array(a))

    mesh4 = mesh.make_mesh(4, 1, "cpu")
    axis = mesh.Axis(mesh4, "data")
    c = payload["consts"]
    out = {}
    local = T(payload["sketches"][rank])
    out["allgather"] = sm.allgather_merge(local, c["ell"], axis)
    out["ring"] = sm.ring_merge(local, axis)
    out["ring_rank0"] = sm.merge(local, c["ell"], axis, "ring")
    out["ppermute"] = (axis.ppermute(T([rank, 10 * rank]).to(torch.int8)),
                       axis.ppermute(T([float(rank)]), shift=3))
    rows = T(payload["rows"])
    out["max_row_norm"] = sm.global_max_row_norm(rows[axis.share(rows.shape[0])], axis)
    for topo in ("allgather", "ring"):
        out[f"distributed_fd_{topo}"] = sm.distributed_fd(rows, ell=c["ell"], mesh=mesh4,
                                                           topology=topo)
    for name, (x, k, k_max, init) in payload["kmeans"].items():
        out[name] = ks.kmeans_sharded(T(x), k, None, k_max=k_max, mesh=mesh4, init=T(init))
    orig_bool = torch.Tensor.__bool__
    for name, (x, k, k_max, init, max_iters, tol) in payload["kmeans_reads"].items():
        reads = []
        torch.Tensor.__bool__ = lambda t: reads.append(1) or orig_bool(t)
        try:
            labels, cents = ks.kmeans_sharded(T(x), k, None, k_max=k_max, mesh=mesh4,
                                              max_iters=max_iters, tol=tol, init=T(init))
        finally:
            torch.Tensor.__bool__ = orig_bool
        out[f"reads_{name}"] = (labels, cents, len(reads))
    for name, (feats, types) in payload["fused"].items():
        out[name] = sharded.fused_shard(tuple(T(f) for f in feats), types, k_basis=c["kb"],
                                        mesh=mesh4, tags_dim=c["tags_dim"],
                                        text_dim=c["text_dim"])
    fused = T(payload["svd_fused"])
    out["dist_svd"] = sharded._dist_svd_reduce(fused[axis.share(fused.shape[0])], None,
                                               c["rank"], axis, omega=T(payload["svd_omega"]))
    cols = ba.standard_columns(tfeat.WindowFeatures(*(T(a) for a in payload["huge"])))
    huge = dict(block=c["block"], k_basis=c["kb"], mesh=mesh4)
    for name, kw in payload["huge_fd"].items():
        out[name] = sharded.sharded_blocked_fd_sketch(cols, ell=c["ell"], **huge, **kw)
    out["huge_svd"] = sharded.sharded_blocked_svd_reduce(
        cols, None, rank=c["rank"], select="binned", nbins=c["nbins"],
        omega=T(payload["huge_omega"]), **huge)
    out["huge_spectral"] = sharded.sharded_spectral_embedding(
        cols, None, k_max=c["k_max"], select="binned", nbins=c["nbins"],
        probe=T(payload["huge_probe"]), **huge)
    std = tuple(T(a) for a in payload["fused"]["standard"][0][:5])
    gen = torch.Generator().manual_seed(0)
    out["window_step"] = sharded.sharded_window_step(*std, 2, gen, k_basis=c["kb"],
                                                     reduced_dim=c["rank"], k_max=3, mesh=mesh4)
    return out


class _Stop(Exception):
    """A simulated crash at a window boundary."""


def _stream_run(payload: dict, cfg_kw: dict, checkpoint_dir=None, stop_after=None):
    """``process_streaming_data(..., device="cpu")`` on ``payload["stream"]``
    -> (metrics, or None when stopped before window ``stop_after``; the
    windows this call dispatched)."""
    import contextlib
    import io

    from mused_tpu_torch import api
    from mused_tpu_torch.engine import streaming as ts
    from mused_tpu_torch.utils.config import PipelineConfig

    mods, mtypes, labels = payload["stream"]
    cfg = PipelineConfig(**cfg_kw)
    orig = ts.StreamingEngine.dispatch_window
    calls = {"n": 0}

    def dispatch(self, *a, **k):
        if stop_after is not None and calls["n"] >= stop_after:
            raise _Stop()
        calls["n"] += 1
        return orig(self, *a, **k)

    ts.StreamingEngine.dispatch_window = dispatch
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = api.process_streaming_data(
                results=api.get_initial_results()[0], data_modalities=mods,
                modality_types=mtypes, window_size=cfg.window_size,
                reduced_dim=cfg.reduced_dim, k_basis=cfg.k_basis, n_clusters_total=2,
                seed=cfg.seed, approach=cfg.approach, complete_true_labels=labels,
                step_window_ratio=1, noise_rate=0.5, label_mode="binary", sorting=True,
                eps=cfg.eps, min_samples=cfg.min_samples, cfg=cfg,
                checkpoint_dir=checkpoint_dir, device="cpu")
        return {k: res[k][0] for k in ("nmi_score", "f1_score")}, calls["n"]
    except _Stop:
        return None, calls["n"]
    finally:
        ts.StreamingEngine.dispatch_window = orig


def checkpoint_runs(rank: int, payload: dict) -> dict:
    """For each of ``payload["checkpoint_cases"]`` (name, PipelineConfig
    keywords): the uninterrupted run; a run checkpointing under
    ``payload["ckpt_root"]/name`` stopped after 2 windows; its resumed run.
    Counts this rank's ``save_checkpoint`` calls.  Then
    ``payload["elastic"]``'s first two steps, leaving its checkpoints for a
    group of another size."""
    import os

    from mused_tpu_torch.utils import checkpoint as ckpt

    saves = {"n": 0}
    orig_save = ckpt.save_checkpoint

    def counting_save(*a, **k):
        saves["n"] += 1
        return orig_save(*a, **k)

    ckpt.save_checkpoint = counting_save
    out = {}
    try:
        for name, cfg_kw in payload["checkpoint_cases"]:
            ckdir = os.path.join(payload["ckpt_root"], name)
            straight, _ = _stream_run(payload, cfg_kw)
            saves["n"] = 0
            stopped, _ = _stream_run(payload, cfg_kw, ckdir, stop_after=2)
            saved = saves["n"]
            resumed, processed = _stream_run(payload, cfg_kw, ckdir)
            out[name] = {"straight": straight, "stopped": stopped, "saves_before_stop": saved,
                         "saves": saves["n"], "resumed": resumed, "processed": processed}
        name, cfg_kw = payload["elastic"]
        out[name] = {"straight": _stream_run(payload, cfg_kw)[0]}
        _stream_run(payload, cfg_kw, os.path.join(payload["ckpt_root"], name), stop_after=2)
    finally:
        ckpt.save_checkpoint = orig_save
    return out


def elastic_resume(rank: int, payload: dict) -> dict:
    """``payload["elastic"]`` resumed from its checkpoints on this group
    (``data_shards`` set to the group's size): (metrics, windows processed)."""
    import os

    import torch.distributed as dist
    name, cfg_kw = payload["elastic"]
    cfg_kw = dict(cfg_kw, data_shards=dist.get_world_size())
    return _stream_run(payload, cfg_kw, os.path.join(payload["ckpt_root"], name))


def write_once_runs(rank: int, payload: dict) -> dict:
    """``mesh.write_once`` on every rank: a write that succeeds, read back by
    every rank as soon as it returns (and how many ranks ran it), then a
    write that fails on the writer (what each rank raised)."""
    import os

    from mused_tpu_torch.parallel import mesh

    path = os.path.join(payload["ckpt_root"], "write_once.txt")
    writes = {"n": 0}

    def write():
        writes["n"] += 1
        with open(path, "w") as f:
            f.write("written by rank 0")

    def fail():
        raise OSError("no space left on device")

    mesh.write_once(write)
    with open(path) as f:
        read_back = f.read()
    try:
        mesh.write_once(fail)
        raised = None
    except Exception as e:      # noqa: BLE001 (what each rank raised is the result)
        raised = (type(e).__name__, str(e))
    return {"writes": writes["n"], "read_back": read_back, "raised": raised}


def engine_and_checkpoint_runs(rank: int, payload: dict) -> dict:
    """:func:`engine_runs`, then :func:`checkpoint_runs` under "checkpoint"
    and :func:`write_once_runs` under "write_once"."""
    out = engine_runs(rank, payload)
    out["checkpoint"] = checkpoint_runs(rank, payload)
    out["write_once"] = write_once_runs(rank, payload)
    return out


def cli_demo(rank: int, payload: dict) -> dict:
    """``main.cli`` on the demo sweep with ``payload["args"]`` from
    ``payload["cwd"]`` (shared by every rank): its exit code and the
    metrics it logged."""
    import contextlib
    import io
    import os

    from mused_tpu_torch import main as tmain

    logged = []
    log_metrics = tmain.output.log_metrics

    def spy(**kw):
        logged.append(kw["metrics"])
        return log_metrics(**kw)

    tmain.output.log_metrics = spy
    os.chdir(payload["cwd"])
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = tmain.cli(["--dataset", "demo", "--device", "cpu", *payload["args"]])
    finally:
        tmain.output.log_metrics = log_metrics
    return {"rc": rc, "metrics": logged}
