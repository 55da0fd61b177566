"""Slices 2f + 2g on a CUDA device against the same code on the CPU.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_driver.py

Tolerances: the Newton-Schulz shrink's B'^T B' within 1e-4 of its largest
entry with the same probe on both devices, the same health verdict, delta
within 1e-5 of ||S||_F^2 (on a rank-deficient stack it is a rounding-level
eigenvalue); ``swfd.update`` / ``SeqBasedSWFD`` counters and ``block_end``
equal, B^T B within 1e-4 (cuSOLVER's and LAPACK's eigh differ in rounding,
and a sketch passes through ~40 sequential shrinks here); ``create_adjacency_matrix`` on the card (K1, exactly 4
launches for the five modalities) bit-equal to the kernel's plain version
for location (chord3), time (l1) and tags (Jaccard), >= 99.9% of text
edges (dot: fp32 sums in another order) with every row's degree equal,
username equal to the CPU's; the CLI demo runs on the card.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from mused_tpu_torch import api, main
from mused_tpu_torch.data.synthetic import make_stream
from mused_tpu_torch.ops import fd, swfd
from mused_tpu_torch.ops.kernels import affinity_kernel as ak


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: slices 2f / 2g's device paths run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gram(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu().double()
    return (x.T @ x).numpy()


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gap", "rank_deficient"])
def test_shrink_fast_on_the_card_matches_the_cpu(cuda, kind):
    rng = np.random.default_rng(0)
    ell, rows, d = 12, 160, 256
    if kind == "gap":
        basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
        scales = np.concatenate([np.linspace(6.0, 3.0, ell), np.ones(d - ell)])
        s = ((rng.normal(size=(rows, d)) * scales) @ basis.T).astype(np.float32)
    else:
        s = (rng.normal(size=(rows, 6)) @ rng.normal(size=(6, d))).astype(np.float32)
    probe = fd.default_probe(rows, ell + 16, "cpu")
    x = torch.from_numpy(s)
    healthy_cpu, _ = fd._subspace_basis(x, ell, oversample=16, sub_iters=4, probe=probe)
    healthy_gpu, _ = fd._subspace_basis(x.to(cuda), ell, oversample=16, sub_iters=4,
                                        probe=probe.to(cuda))
    assert bool(healthy_gpu) == bool(healthy_cpu) == (kind == "gap")
    b_cpu, d_cpu = fd.shrink_fast(x, ell, probe=probe)
    b_gpu, d_gpu = fd.shrink_fast(x.to(cuda), ell, probe=probe.to(cuda))
    _close(_gram(b_gpu), _gram(b_cpu), 1e-4)
    assert abs(float(d_gpu) - float(d_cpu)) <= 1e-5 * float((s.astype(np.float64) ** 2).sum())


@pytest.mark.cuda
def test_seq_based_swfd_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(1)
    stream = rng.normal(size=(300, 40)).astype(np.float32)
    cpu = swfd.SeqBasedSWFD(N=64, R=1.0, d=40, sketch_dim=8, device="cpu")
    gpu = swfd.SeqBasedSWFD(N=64, R=1.0, d=40, sketch_dim=8, device=cuda)
    fed = 0
    for sz in (1, 7, 30, 64, 3, 100, 95):
        cpu.fit(stream[fed:fed + sz])
        gpu.fit(stream[fed:fed + sz])
        fed += sz
        a, b = cpu.state, gpu.state
        assert (a.count, a.seal_cursor, a.active_rows) == (b.count, b.seal_cursor,
                                                            b.active_rows)
        np.testing.assert_array_equal(b.block_end.cpu().numpy(), a.block_end.numpy())
        qa, qb = cpu.get(), gpu.get()
        _close(_gram(qb[0]), _gram(qa[0]), 1e-4)
        np.testing.assert_allclose(float(qb[1]), float(qa[1]), rtol=1e-4)
    for blk_a, blk_b in zip(cpu.state.blocks, gpu.state.blocks):
        _close(_gram(blk_b), _gram(blk_a), 1e-4)


@pytest.mark.cuda
def test_create_adjacency_matrix_on_the_card(cuda):
    mods, types, _ = make_stream(2000, seed=0)
    before = ak.launches
    got = {t: api.create_adjacency_matrix(m, t, k_basis=50) for m, t in zip(mods, types)}
    assert ak.launches - before == 4
    loc = torch.from_numpy(mods[0].astype(np.float32)).to(cuda)
    lv = torch.isfinite(loc).all(1)
    xyz = ak.location_to_unit_xyz(torch.where(lv[:, None], loc, 0.0))   # the card's sin / cos
    np.testing.assert_array_equal(
        got["location"], ak.knn_adjacency_reference(xyz, lv, 50, "chord3").cpu().numpy())
    for t in ("time", "tags", "username"):
        np.testing.assert_array_equal(got[t], api.create_adjacency_matrix(
            mods[types.index(t)], t, k_basis=50, device="cpu"))
    text_cpu = api.create_adjacency_matrix(mods[4], "text", k_basis=50, device="cpu")
    a, b = got["text"].astype(bool), text_cpu.astype(bool)
    assert (a & b).sum() / (a | b).sum() >= 0.999
    np.testing.assert_array_equal(a.sum(1), b.sum(1))
    fused = api.fuse_matrices(list(got.values()))
    assert fused.shape == (2000, 2000)
    red = api.perform_svd_reduction(fused, 50, 0)
    assert red.shape == (2000, 50) and np.isfinite(red).all()
    assert len(np.unique(api.perform_clustering(red, 2, 0))) == 2


@pytest.mark.cuda
def test_cli_demo_on_the_card(cuda, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = ak.launches
    with contextlib.redirect_stdout(io.StringIO()):
        assert main.cli(["--dataset", "demo", "--no-tee", "--second-pass-label-mode", "none",
                         "--approaches", "SWFDMC", "sSVDMC"]) == 0
    assert ak.launches > before
    assert any(f.startswith("exp=label_mode") for f in os.listdir(tmp_path / "logs"))
