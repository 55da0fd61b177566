"""Helpers shared by the JAX-vs-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
(on the CPU; Pallas kernels in interpret mode) and the PyTorch port.  Where
the two frameworks draw different random numbers from the same seed, the
port is fed the JAX side's draws (:func:`inject_jax_draws`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

# six xdist workers share the machine: one intra-op thread per worker
torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    """numpy -> CPU tensor (contiguous copy)."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """JAX array or tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_features_of(wf, module):
    """A (Sparse)WindowFeatures as ``module``'s class of the same name: the
    port keeps its own copy of the JAX package's feature tuples, and each
    package's engine dispatches on its own classes."""
    return getattr(module, type(wf).__name__)(*wf)


def jax_probe(m2: int, r: int) -> np.ndarray:
    """The JAX package's fixed FD probe: normal(key(7), (m2, r))."""
    return np.asarray(jax.random.normal(jax.random.key(7), (m2, r), jnp.float32))


def inject_jax_draws(monkeypatch, svd_signs: bool = False) -> None:
    """Make the port's streaming and batch engines draw the JAX engines'
    random numbers: the FD probe (key 7), and from the JAX key (per window w
    of a stream ``fold_in(key(seed), w)``, for a batch run ``key(seed)``)
    the randomized-SVD test matrix (dense or blocked), blocked spectral's
    Gaussian probe and the k-means++ init (the k-means inside
    ``ops/spectral`` and ``ops/blocked_spectral`` included: they call the
    same module attribute).

    ``svd_signs``: also flip each column of the dense randomized SVD's output
    to the sign the JAX package's LAPACK gives it.  A singular vector's sign
    is implementation-defined, like a draw; within a window no distance
    depends on it, but an approach that compares rows of different windows
    (DBSCAN_incr) does."""
    from mused_tpu.ops import kmeans as jkmeans
    from mused_tpu_torch.engine import batch as tb
    from mused_tpu_torch.engine import streaming as ts
    from mused_tpu_torch.ops import blocked_affinity as tba
    from mused_tpu_torch.ops import blocked_spectral as tbspec
    from mused_tpu_torch.ops import fd as tfd

    current = {}
    orig_gen, orig_svd, orig_kmeans = ts.window_generator, ts.reduction.svd_reduce, \
        ts.kmeans.kmeans
    orig_blocked_svd = tba.randomized_svd_from_products
    orig_ritz, orig_batch_gen = tbspec.ritz_from_products, tb.batch_generator

    def window_generator(seed, window_index, device):
        current["key"] = jax.random.fold_in(jax.random.key(seed), window_index)
        return orig_gen(seed, window_index, device)

    def svd_reduce(matrix, reduced_dim, generator=None, *, omega=None):
        rows, d = matrix.shape
        k = min(min(reduced_dim, d - 1) + 10, min(rows, d))
        omega = jax.random.normal(current["key"], (d, k), jnp.float32)
        out = orig_svd(matrix, reduced_dim, generator, omega=t(omega))
        if svd_signs:
            from mused_tpu.ops import reduction as jreduction
            want = jreduction.svd_reduce(jnp.asarray(n(matrix)), reduced_dim,
                                         current["key"])
            flip = torch.sum(out * t(np.asarray(want)), dim=0) < 0
            out = torch.where(flip[None, :], -out, out)
        return out

    def blocked_svd(mul_a, mul_at, generator, *, n, rank, oversample=8, n_iter=2,
                    device=None, omega=None):
        omega = jax.random.normal(current["key"], (n, min(rank + oversample, n)),
                                  jnp.float32)
        return orig_blocked_svd(mul_a, mul_at, generator, n=n, rank=rank,
                                oversample=oversample, n_iter=n_iter, device=device,
                                omega=t(omega).to(device))

    def kmeans(x, k, generator=None, *, k_max, **kw):
        init = jkmeans._kmeanspp_init(jnp.asarray(n(x), jnp.float32), k_max,
                                      jnp.int32(int(k)), current["key"])
        return orig_kmeans(x, k, generator, k_max=k_max, init=t(init), **kw)

    def ritz(sym_matmul, inv_sqrt, generator, *, n, m, n_iter=6, probe=None):
        probe = jax.random.normal(current["key"], (n, m), jnp.float32)
        return orig_ritz(sym_matmul, inv_sqrt, generator, n=n, m=m, n_iter=n_iter,
                         probe=t(probe).to(inv_sqrt.device))

    def batch_generator(seed, device):
        current["key"] = jax.random.key(seed)
        return orig_batch_gen(seed, device)

    monkeypatch.setattr(tfd, "default_probe",
                        lambda m2, r, device: t(jax_probe(m2, r)).to(device))
    monkeypatch.setattr(ts, "window_generator", window_generator)
    monkeypatch.setattr(tb, "batch_generator", batch_generator)
    monkeypatch.setattr(ts.reduction, "svd_reduce", svd_reduce)
    monkeypatch.setattr(tba, "randomized_svd_from_products", blocked_svd)
    monkeypatch.setattr(tbspec, "ritz_from_products", ritz)
    monkeypatch.setattr(ts.kmeans, "kmeans", kmeans)


def synthetic_window_stream(n_rows=420, n_events=4, noise_rate=0.5, subset=256,
                            seed=1):
    """mused_tpu's own seeded SED-like stream, prepared like the reference."""
    from mused_tpu.data.sed2012 import prepare_modalities
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    df = synthetic_events_dataframe(n_rows=n_rows, n_events=n_events,
                                    noise_rate=noise_rate, seed=seed)
    return prepare_modalities(df, subset_size=subset, sort_by_uploaded=True,
                              binary=True, noise_rate=noise_rate, seed=seed)


def table_from_dataframe(df) -> dict:
    """A JAX-package DataFrame (``data/sed2012`` or ``data/synthetic``) as the
    port's column table: one numpy array per column, tags a list of lists."""
    return {c: [list(x) for x in df[c]] if c == "tags" else df[c].to_numpy()
            for c in df.columns}


def assert_table_equals_frame(table: dict, df) -> None:
    """Column by column, bit for bit: floats (NaN in the same places) and
    ints with the frame's dtype, strings and tag lists equal."""
    assert list(table) == list(df.columns)
    for c in df.columns:
        want, got = df[c].to_numpy(), table[c]
        if c == "tags":
            assert got == [list(x) for x in want], c
        elif want.dtype.kind in "fiu":
            assert got.dtype == want.dtype, (c, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=c)
        else:
            assert list(got) == list(want), c


def crisis_serving_reference(rows=20_000, window=2000, chunk=500):
    """The JAX detector's NMI on ``chip_smoke.py`` phase h2's stream and
    configuration (sSpectral, eigengap count up to 150 events, positional
    matching, one window per dispatch), background bucket off and on: one
    dict per setting, a quality reference for the card's numbers.

        JAX_PLATFORMS=cpu python tests/torch_parity.py
    """
    from mused_tpu.data.synthetic import crisis_embedding_stream
    from mused_tpu.serving import StreamDetector
    from mused_tpu.utils.config import PipelineConfig
    from mused_tpu.utils.metrics import nmi
    mods, mtypes, labels = crisis_embedding_stream(n_rows=rows, n_events=8,
                                                   noise_rate=0.3, seed=0)
    out = []
    for background in (False, True):
        cfg = PipelineConfig(window_size=window, reduced_dim=50, k_basis=50,
                             approach="sSpectral", label_mode="all",
                             n_clusters_override=150, k_estimate="eigengap",
                             background_bucket=background, windows_per_batch=1)
        det = StreamDetector(mtypes, window, cfg=cfg)
        res = []
        for lo in range(0, rows, chunk):
            res.extend(det.push([m[lo:lo + chunk] for m in mods]))
        res.extend(det.flush())
        clus = np.concatenate([r.clusters for r in res])
        out.append({"background": background, "windows": len(res),
                    "nmi": nmi(labels[:len(clus)], clus),
                    "background_rows": int((clus == -1).sum())})
    return out


if __name__ == "__main__":
    for line in crisis_serving_reference():
        print(line)


def reference_lloyd(x, k: int, init, *, k_max: int, max_iters: int = 100, tol: float = 1e-4):
    """The port's Lloyd loop as it was before it stopped reading the host
    every iteration (two reads per step: any empty cluster, shift > tol):
    (labels, centroids, steps run), the yardstick of the repaired loop."""
    x = torch.as_tensor(x).float()
    n = x.shape[0]
    alive = torch.arange(k_max) < k
    c = torch.as_tensor(init).float()
    arange_k = torch.arange(k_max)

    def sq_dists(cent):
        xn = torch.sum(x * x, dim=1)
        cn = torch.sum(cent * cent, dim=1)
        return torch.clamp(xn[:, None] + cn[None, :] - 2.0 * (x @ cent.T), min=0.0)

    def assign(cent):
        return torch.argmin(torch.where(alive[None, :], sq_dists(cent), torch.inf), dim=1)

    steps = 0
    for _ in range(max_iters):
        steps += 1
        labels = assign(c)
        onehot = (labels[:, None] == arange_k[None, :]).float()
        counts = torch.sum(onehot, dim=0)
        new_c = torch.where((counts > 0)[:, None],
                            (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None], c)
        empty = alive & (counts == 0)
        if bool(torch.any(empty)):
            dist_own = torch.gather(sq_dists(new_c), 1, labels[:, None])[:, 0]
            k_eff = min(k_max, n)
            far = torch.sort(dist_own, descending=True, stable=True)[1][:k_eff]
            slot = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0, k_eff - 1)
            new_c = torch.where(empty[:, None], x[far[slot]], new_c)
        shift = torch.sum((new_c - c) ** 2)
        c = new_c
        if not bool(shift > tol):
            break
    return assign(c), c, steps


def integer_kmeans_case(name: str):
    """(x, k, k_max, JAX key, max_iters, tol) of a k-means fixture of small
    integers, whose sums are exact in any order: "converges",
    "empty_cluster" (the k-means++ seeding leaves a live cluster empty) or
    "max_iters" (never converges)."""
    rng = np.random.default_rng(11)
    if name == "converges":
        x = rng.integers(0, 16, size=(64, 2))
        return x.astype(np.float32), 4, 6, jax.random.key(0), 100, 1e-4
    if name == "empty_cluster":
        # three distinct points, four centres: the seeding's last draw
        # (uniform, every distance 0) repeats one, and its cluster is empty
        x = np.repeat(np.array([[0, 0], [8, 0], [0, 8]]), [20, 24, 20], axis=0)
        return x.astype(np.float32), 4, 4, jax.random.key(1), 100, 1e-4
    x = np.concatenate([rng.integers(0, 6, size=(32, 3)), rng.integers(20, 26, size=(32, 3))])
    return x.astype(np.float32), 3, 5, jax.random.key(2), 20, -1.0     # never converges
