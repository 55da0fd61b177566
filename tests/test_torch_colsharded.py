"""The column-sharded huge-window sweep (``mused_tpu_torch/parallel/colsharded``)
on 4 gloo ranks of the CPU against the JAX package's on its 8 virtual CPU
devices (mesh (4, 1) and the (2, 2) grid), at the JAX tests' sizes: a
512-row standard window, block 64, nbins 128, k_basis 3, ell 16.

One spawn of 4 ranks runs every case of this module (``torch_dist``) while
this process computes the JAX side.  Tolerances:
  * fused rows, candidate values and groups, sq_frobenius: bit-equal (max
    and min merges, integer sums);
  * the FD sketch (the FD probe injected): sq_frobenius bit-equal, the FD
    error bound holds, the covariance error within 5% of the JAX sketch's,
    and BᵀB within the JAX test's 5e-2 · scale of the JAX package's (eigh)
    or of the port's single-device fold (Rayleigh-Ritz; see the test);
  * the blocked SVD: the reduced Gram within 1e-3 · scale with the JAX test
    matrix injected; the Ritz values within 1e-4 with the JAX probe
    injected;
  * every rank returns the same bits.
"""
import functools
import types as pytypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mused_tpu.data import features as jfeat
from mused_tpu.ops import blocked_affinity as jba
from mused_tpu.parallel import colsharded as jcs
from mused_tpu.parallel.mesh import make_mesh as jmake_mesh
from mused_tpu_torch.ops import blocked_affinity as tba
from mused_tpu_torch.ops import fd as tfd
from mused_tpu_torch.ops.kernels import blocked_select as tbs
from mused_tpu_torch.parallel import colsharded as tcs
from mused_tpu_torch.parallel import mesh as tmesh
import torch_dist
from torch_parity import jax_probe, n as tonp, t

N, BLOCK, NBINS, KB, ELL = 512, 64, 128, 3, 16
STARTS = (0, 192, 448)
LAYOUTS = {"columns": (4, 1), "grid": (2, 2)}
FD_CASES = [("eigh", None), ("subspace", None), ("subspace", True)]


def _standard_window(rng, n=N, h_tags=256, h_text=512):
    """The JAX colsharded tests' standard window (tests/test_colsharded.py)."""
    loc = rng.uniform(low=(-60.0, -170.0), high=(60.0, 170.0), size=(n, 2)).astype(np.float32)
    loc[rng.random(n) < 0.1] = np.nan
    tim = rng.uniform(1.0, 1e5, size=(n, 2)).astype(np.float32)
    tim[rng.random(n) < 0.1] = 0.0
    uid = rng.integers(0, 40, size=n).astype(np.int32)
    uid[rng.random(n) < 0.1] = -1
    tags = (rng.random((n, h_tags)) < 0.02).astype(np.uint8)
    text = rng.poisson(0.05, size=(n, h_text)).astype(np.uint8)
    tags_valid = rng.random(n) < 0.9
    return (loc, tim, uid, tags, text, tags_valid)


def _generic_window(rng, n=N):
    """Embedding, default (euclidean chord), location and time modalities,
    some rows invalid in each."""
    emb = rng.normal(size=(n, 32)).astype(np.float32)
    dft = rng.normal(size=(n, 8)).astype(np.float32)
    loc = rng.uniform(low=(-60.0, -170.0), high=(60.0, 170.0), size=(n, 2)).astype(np.float32)
    tim = rng.uniform(1.0, 1e5, size=(n, 2)).astype(np.float32)
    emb[::13] = np.nan
    dft[::17, 2] = np.inf
    loc[::19] = np.nan
    tim[::23, 0] = 0.0
    return (emb, dft, loc, tim)


GENERIC_TYPES = ("embedding", "default", "location", "time")
GENERIC_NBINS = tcs.default_nbins_colsharded(N, 4, k_max=3 * KB)


def _cases():
    cases = []
    for layout, shape in LAYOUTS.items():
        for s in STARTS:
            cases.append((f"rows_standard_{layout}_{s}", "colsharded_fused_rows", shape, "std",
                          dict(start=s, block=BLOCK, k_basis=KB, nbins=NBINS)))
        for mode, cand in FD_CASES:
            cases.append((f"fd_{mode}_{cand}_{layout}", "colsharded_blocked_fd_sketch", shape,
                          "std", dict(ell=ELL, block=BLOCK, k_basis=KB, mode=mode,
                                      nbins=NBINS, cand_fold=cand)))
    for s in STARTS:
        cases.append((f"rows_generic_columns_{s}", "colsharded_fused_rows", (4, 1), "gen",
                      dict(start=s, block=BLOCK, k_basis=KB, nbins=GENERIC_NBINS)))
    cases.append(("rows_skipped", "colsharded_fused_rows", (4, 1), "skip",
                  dict(start=0, block=64, k_basis=1, nbins=64)))
    cases.append(("svd", "colsharded_blocked_svd_reduce", (4, 1), "std",
                  dict(rank=16, block=BLOCK, k_basis=KB, nbins=NBINS, omega="omega")))
    cases.append(("spectral", "colsharded_spectral_embedding", (4, 1), "std",
                  dict(k_max=4, block=BLOCK, k_basis=KB, nbins=NBINS, probe="probe")))
    return cases


@pytest.fixture(scope="module")
def world():
    """Every case on 4 gloo ranks, and the JAX side computed meanwhile."""
    std = _standard_window(np.random.default_rng(0))
    gen = _generic_window(np.random.default_rng(1))
    skip = (np.random.default_rng(2).normal(size=(256, 8)).astype(np.float32),)
    m2 = ELL + BLOCK
    draws = {"omega": np.asarray(jax.random.normal(jax.random.key(3), (N, 24), jnp.float32)),
             "probe": np.asarray(jax.random.normal(jax.random.key(5), (N, 12), jnp.float32))}
    payload = {"cases": _cases(), "tensors": draws,
               "probes": {(m2, ELL + 16): jax_probe(m2, ELL + 16),
                          (2 * ELL, 2 * ELL): jax_probe(2 * ELL, 2 * ELL)},
               "feats": {"std": (std, ("standard",)), "gen": (gen, GENERIC_TYPES),
                         "skip": (skip, ("default",))}}
    ranks = torch_dist.start("colsharded_cases", payload, world=4)
    jax_out = _jax_side(std, gen, skip)
    return {"ranks": ranks.join(), "jax": jax_out, "std": std, "gen": gen}


def _jax_side(std, gen, skip) -> dict:
    meshes = {k: jmake_mesh(n_data=a, n_model=b) for k, (a, b) in LAYOUTS.items()}
    jstd = tuple(jnp.asarray(x) for x in std)
    out = {}

    def rows(feats, types, mesh, **kw):
        f = jax.jit(functools.partial(jcs.colsharded_fused_rows, types=types, mesh=mesh, **kw))
        return np.asarray(f(feats))

    for layout, mesh in meshes.items():
        for s in STARTS:
            out[f"rows_standard_{layout}_{s}"] = rows(jstd, ("standard",), mesh, start=s,
                                                      block=BLOCK, k_basis=KB, nbins=NBINS)
        for mode, cand in FD_CASES:
            sk, sq, loss = jcs.colsharded_blocked_fd_sketch(
                std, ("standard",), ell=ELL, block=BLOCK, k_basis=KB, mesh=mesh, mode=mode,
                nbins=NBINS, cand_fold=cand)
            out[f"fd_{mode}_{cand}_{layout}"] = (np.asarray(sk), float(sq), float(loss))
    for s in STARTS:
        out[f"rows_generic_columns_{s}"] = rows(tuple(jnp.asarray(x) for x in gen),
                                                GENERIC_TYPES, meshes["columns"], start=s,
                                                block=BLOCK, k_basis=KB, nbins=GENERIC_NBINS)
    out["rows_skipped"] = rows((jnp.asarray(skip[0]),), ("default",), meshes["columns"],
                               start=0, block=64, k_basis=1, nbins=64)
    out["svd"] = np.asarray(jcs.colsharded_blocked_svd_reduce(
        std, ("standard",), jax.random.key(3), rank=16, block=BLOCK, k_basis=KB,
        mesh=meshes["columns"], nbins=NBINS))
    ritz, lam = jcs.colsharded_spectral_embedding(
        std, ("standard",), jax.random.key(5), k_max=4, block=BLOCK, k_basis=KB,
        mesh=meshes["columns"], nbins=NBINS)
    out["spectral"] = (np.asarray(ritz), np.asarray(lam))
    return out


def _port_columns(std):
    """The single-device port's columns of the standard window."""
    from mused_tpu_torch.data import features as tfeat
    return tba.standard_columns(tfeat.WindowFeatures(*(t(a) for a in std)))


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

def test_default_nbins_colsharded_matches_jax():
    for n in (64, 256, 512, 4096, 12_800, 98_304, 106_496, 524_288, 1_048_576, 100):
        for p in (1, 2, 4, 8, 100, 256):
            for k_max in (0, 9, 150):
                assert tcs.default_nbins_colsharded(n, p, k_max=k_max) == \
                    jcs.default_nbins_colsharded(n, p, k_max=k_max), (n, p, k_max)


def _fake_mesh(n_data, n_model=1):
    """The two attributes the geometry reads (no process group needed)."""
    return pytypes.SimpleNamespace(mesh_dim_names=("data", "model"),
                                   shape=(n_data, n_model), device_type="cpu")


BAD_GEOMETRY = {
    "block": ("colsharded_blocked_fd_sketch", dict(ell=8, block=96, k_basis=3)),
    "eigh": ("colsharded_blocked_fd_sketch",
             dict(ell=8, block=64, k_basis=3, mode="subspace_ns")),
    "int8": ("colsharded_spectral_embedding", dict(k_max=4, block=128, k_basis=3, nbins=1)),
}


@pytest.mark.parametrize("case", sorted(BAD_GEOMETRY))
def test_bad_geometry_raises_the_jax_message(case):
    fn, kw = BAD_GEOMETRY[case]
    std = _standard_window(np.random.default_rng(0))
    extra = (jax.random.key(0),) if "spectral" in fn else ()
    with pytest.raises(ValueError, match=case) as jerr:
        getattr(jcs, fn)(std, ("standard",), *extra, mesh=jmake_mesh(n_data=4), **kw)
    extra = (None,) if "spectral" in fn else ()
    with pytest.raises(ValueError) as terr:
        getattr(tcs, fn)(std, ("standard",), *extra, mesh=_fake_mesh(4), **kw)
    assert str(terr.value) == str(jerr.value)


def test_mesh_axes_follow_the_mesh_shape():
    assert tcs._mesh_axes(_fake_mesh(4)) == jcs._mesh_axes(jmake_mesh(n_data=4))
    assert tcs._mesh_axes(_fake_mesh(2, 2)) == jcs._mesh_axes(jmake_mesh(n_data=2, n_model=2))
    assert tcs._mesh_axes(_fake_mesh(1, 4)) == jcs._mesh_axes(jmake_mesh(n_data=1, n_model=4))


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(4, 1, "cpu")


def _items(rng, start, block=128):
    """Prepared (metric, cols, colv, stats, k, vr, rows, row_stats) items of
    an odd modality count (chord3, l1, jaccard): rows from another shard,
    with their own statistics."""
    n = 512
    xyz = rng.standard_normal((n + block, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    tim = rng.uniform(1.0, 1e5, size=(n + block, 2)).astype(np.float32)
    tags = (rng.random((n + block, 256)) < 0.05).astype(np.int8)
    sums = tags.sum(1).astype(np.float32)
    v = [rng.random(n + block) > 0.1 for _ in range(3)]
    rows, cols = slice(n, n + block), slice(0, n)
    items = []
    for metric, x, valid, stats, k in (("chord3", xyz, v[0], None, 5), ("l1", tim, v[1], None, 15),
                                       ("jaccard", tags, v[2], sums, 5)):
        items.append((metric, t(x[cols]), t(valid[cols]),
                      None if stats is None else t(stats[cols]), k, t(valid[rows]),
                      t(x[rows]), None if stats is None else t(stats[rows])))
    return items


@pytest.mark.parametrize("start", [-128, 128, 400])
def test_raw_candidates_pairing_equals_the_plain_route(start):
    """The sweep pairs consecutive modalities into K3 (a leftover single
    takes K2); on CPU tensors the wrappers run their plain versions, so the
    pairing's bookkeeping must give each modality's plain candidates
    exactly, and the JAX package's emulation's."""
    items = _items(np.random.default_rng(7), start)
    paired = tcs._raw_candidates(items, start, nbins=128, block=128)
    plain = [tbs.binned_candidates_plain(c, r, cv, start, metric=m, nbins=128, block=128,
                                         row_sums=s, row_stats=rs)
             for m, c, cv, s, _, _, r, rs in items]
    jitems = [(m, jnp.asarray(tonp(c)), jnp.asarray(tonp(cv)),
               None if s is None else jnp.asarray(tonp(s)), k, jnp.asarray(tonp(vr)),
               jnp.asarray(tonp(r)), None if rs is None else jnp.asarray(tonp(rs)))
              for m, c, cv, s, k, vr, r, rs in items]
    emul = jcs._raw_candidates(jitems, jnp.int32(start), nbins=128, block=128, tn=128,
                               use_kernel=False)
    assert len(paired) == len(plain) == len(emul) == 3
    for (vp, gp), (vq, gq), (ve, ge) in zip(paired, plain, emul):
        assert torch.equal(vp, vq) and torch.equal(gp, gq)
        np.testing.assert_array_equal(tonp(gp), np.asarray(ge))
        np.testing.assert_allclose(tonp(vp), np.asarray(ve), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# on the ranks
# ---------------------------------------------------------------------------

def _rank0(world, name):
    return world["ranks"][0][name]


@pytest.mark.parametrize("name", [f"rows_standard_{lay}_{s}" for lay in LAYOUTS
                                  for s in STARTS]
                         + [f"rows_generic_columns_{s}" for s in STARTS])
def test_fused_rows_bit_equal_to_jax(world, name):
    got = _rank0(world, name)
    assert got.shape == (BLOCK, N) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, world["jax"][name])


def test_fused_rows_equal_the_single_device_binned_route(world):
    cols = _port_columns(world["std"])
    for s in STARTS:
        want = tba.fused_rowblock(cols, s, BLOCK, KB, select="binned", nbins=NBINS,
                                  out_dtype=torch.bool)
        for layout in LAYOUTS:
            np.testing.assert_array_equal(_rank0(world, f"rows_standard_{layout}_{s}"),
                                          tonp(want))


def test_fused_rows_all_modalities_skipped(world):
    """k_eff == 0 for every modality (default kind, k_basis 1): no edges."""
    got = _rank0(world, "rows_skipped")
    assert got.shape == (64, 256) and not got.any()
    np.testing.assert_array_equal(got, world["jax"]["rows_skipped"])


@pytest.fixture(scope="module")
def single_device(world):
    """The port's single-device blocked fold per FD case (the JAX probe
    injected, as on the ranks), and the window's full (n, n) fused adjacency
    (for the FD error bound)."""
    cols = _port_columns(world["std"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfd, "default_probe", lambda m2, r, device: t(jax_probe(m2, r)))
        folds = {(mode, cand): tba.blocked_fd_sketch(cols, ell=ELL, block=BLOCK, k_basis=KB,
                                                     mode=mode, select="binned",
                                                     nbins=NBINS, cand_fold=bool(cand))
                 for mode, cand in FD_CASES}
    full = torch.cat([tba.fused_rowblock(cols, s, BLOCK, KB, select="binned", nbins=NBINS)
                      for s in range(0, N, BLOCK)])
    return folds, full


def _gram(sk) -> np.ndarray:
    sk = np.asarray(sk, np.float64)
    return sk.T @ sk


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode,cand", FD_CASES, ids=["eigh", "subspace", "cand_fold"])
def test_fd_sketch_matches_jax(world, single_device, mode, cand, layout):
    """sq_frobenius bit-equal; the FD bound holds; the covariance error
    against the true adjacency within 5% of the JAX sketch's.  BᵀB: the
    eigh fold within 5e-2 · scale of the JAX package's; the Rayleigh-Ritz
    folds (subspace, cand_fold) cut their top ell on a spectrum with no gap
    at this toy size (loss / sq ~ 0.75), where torch's and XLA's QR / eigh
    pick different bases (the port's single-device fold sits 13% from the
    JAX package's, both within 1.5% of each other's covariance error), so
    there the columns layout is held to the port's own single-device fold,
    as the JAX test holds its layout to its own (psum order only)."""
    key = f"fd_{mode}_{cand}_{layout}"
    sk, sq, loss = _rank0(world, key)
    jsk, jsq, _ = world["jax"][key]
    folds, full = single_device
    assert sk.shape == (ELL, N)
    assert float(sq) == jsq == float(folds[(mode, cand)][1])    # integer edge count
    err = float(tfd.covariance_error(full, t(sk)))
    jerr = float(tfd.covariance_error(full, t(jsk)))
    assert err <= min(float(loss), float(sq) / ELL) * 1.01 + 1e-3
    assert abs(err - jerr) <= 0.05 * jerr
    ref = jsk if mode == "eigh" else (tonp(folds[(mode, cand)][0]) if layout == "columns"
                                      else None)
    if ref is not None:
        scale = max(np.abs(_gram(ref)).max(), 1.0)
        np.testing.assert_allclose(_gram(sk), _gram(ref), atol=5e-2 * scale)


def test_blocked_svd_matches_jax(world):
    ours = _rank0(world, "svd").astype(np.float64)
    ref = world["jax"]["svd"].astype(np.float64)
    assert ours.shape == (N, 16)
    scale = max(np.abs(ref @ ref.T).max(), 1.0)
    np.testing.assert_allclose(ours @ ours.T, ref @ ref.T, atol=1e-3 * scale)


def test_spectral_ritz_values_match_jax(world):
    ritz, lam = _rank0(world, "spectral")
    jritz, jlam = world["jax"]["spectral"]
    assert ritz.shape == jritz.shape == (N, 12)
    np.testing.assert_allclose(lam, jlam, atol=1e-4)
    assert np.all(np.diff(lam) <= 1e-5)                      # descending


def test_every_rank_returns_the_same_outputs(world):
    first = world["ranks"][0]
    for other in world["ranks"][1:]:
        assert other.keys() == first.keys()
        for name, value in first.items():
            values = value if isinstance(value, tuple) else (value,)
            others = other[name] if isinstance(other[name], tuple) else (other[name],)
            for a, b in zip(values, others):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
