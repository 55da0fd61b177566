"""Run the port's SPMD layouts on a gloo process group of CPU ranks — the
helpers of tests/test_torch_colsharded*.py.

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
    result, in rank order."""

    def __init__(self, fn_name: str, payload, world: int):
        import torch.multiprocessing as mp
        self._dir = tempfile.mkdtemp(prefix="mused_ranks_")
        self.world = world
        init = f"file://{os.path.join(self._dir, 'store')}"
        self._ctx = mp.start_processes(_entry, args=(world, init, fn_name, payload, self._dir),
                                       nprocs=world, join=False, start_method="spawn")

    def join(self, timeout: float = 600.0) -> list:
        try:
            while not self._ctx.join(timeout):
                pass
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
    blocked SVD and ``ritz`` {w: (n, m)} for blocked spectral; ``kmeans``
    [row indices per call] for the k-means++ centres (k-means starts from
    those rows of its own points)."""
    import torch
    from mused_tpu_torch.engine import streaming as ts
    from mused_tpu_torch.ops import blocked_affinity as ba
    from mused_tpu_torch.ops import blocked_spectral as bspec
    from mused_tpu_torch.ops import fd
    from mused_tpu_torch.ops import kmeans as km

    probes = draws.get("probes", {})
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

    def kmeans(x, k, generator=None, *, k_max, **kw):
        idx = draws["kmeans"][current["kmeans"]]
        current["kmeans"] += 1
        init = torch.zeros((k_max, x.shape[1]), dtype=torch.float32, device=x.device)
        init[:len(idx)] = x.float()[torch.as_tensor(idx, device=x.device)]
        return orig_kmeans(x, k, generator, k_max=k_max, init=init, **kw)

    ts.window_generator = window_generator
    if "omega" in draws:
        ba.randomized_svd_from_products = svd
    if "ritz" in draws:
        bspec.ritz_from_products = ritz
    if "kmeans" in draws:
        km.kmeans = kmeans


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
    from mused_tpu_torch.utils.config import PipelineConfig

    saved = (fd.default_probe, ts.window_generator, ba.randomized_svd_from_products,
             bspec.ritz_from_products, km.kmeans)
    mods, mtypes, labels = payload["stream"]
    out = {}
    for i in range(payload["count"]):
        name, cfg_kw, draws = receive(payload["inbox"], i)
        (fd.default_probe, ts.window_generator, ba.randomized_svd_from_products,
         bspec.ritz_from_products, km.kmeans) = saved
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
    return out
