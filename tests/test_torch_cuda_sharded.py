"""Slice 4b on a CUDA device, at world size 1 (one NCCL rank, mesh (1, 1)):
the row-sharded code against the single-device path on the card, and the
dense fused shard on the card against the same function on the CPU.

Every test here needs a card and skips without one.  The file imports no
JAX, so it runs on a machine without it; there, skip the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sharded.py

Tolerances: launch counts, sq_frobenius and the adjacency are exact (integer
sums); at world size 1 every all-reduce is the identity, so the SVD, the
Ritz values and the k-means labels equal the single-device path's up to the
summation order of an all-gather (1e-5); the fused shard: time, username
and tags bit-equal, location and text on >= 99.9% of edges with every
row's degree equal.
"""
import socket

import numpy as np
import pytest
import torch

from mused_tpu_torch.ops import blocked_affinity as ba
from mused_tpu_torch.ops.kernels import blocked_select as bs
from mused_tpu_torch.ops.kernels import cand_matvec as cm

N, BLOCK, NBINS, KB, ELL = 4096, 512, 1024, 3, 16
MODALITIES = ("location", "time", "username", "tags", "text")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def mesh(cuda):
    """A process group of one NCCL rank on this card, and its (1, 1) mesh."""
    import torch.distributed as dist
    from mused_tpu_torch.parallel import mesh as mesh_mod
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    yield mesh_mod.make_mesh(1, 1, "cuda")
    dist.destroy_process_group()


class _LocalAxis:
    """World size 1 on the CPU: every collective is the identity."""

    size, index = 1, 0

    def psum(self, x):
        return x

    def all_gather(self, x):
        return x[None]


def _window(n, seed=0):
    from mused_tpu_torch.data import features as feat
    rng = np.random.default_rng(seed)
    loc = rng.uniform((-60.0, -170.0), (60.0, 170.0), size=(n, 2)).astype(np.float32)
    loc[rng.random(n) < 0.1] = np.nan
    tim = rng.uniform(1.0, 1e5, size=(n, 2)).astype(np.float32)
    tim[rng.random(n) < 0.1] = 0.0
    uid = rng.integers(0, 40, size=n).astype(np.int32)
    uid[rng.random(n) < 0.1] = -1
    tags = (rng.random((n, 256)) < 0.02).astype(np.uint8)
    text = (rng.random((n, 512)) < 0.05).astype(np.uint8)
    return feat.WindowFeatures(loc, tim, uid, tags, text, rng.random(n) < 0.9)


def _columns(wf, device):
    return ba.standard_columns(type(wf)(*(torch.from_numpy(a).to(device) for a in wf)))


@pytest.mark.cuda
def test_rows_fd_sketch_launches_and_sq_frobenius(mesh, cuda):
    """The candidate fold on this rank's blocks (all of them at size 1)."""
    from mused_tpu_torch.parallel import sharded
    cols = _columns(_window(N), cuda)
    kw = dict(ell=ELL, block=BLOCK, k_basis=KB, select="binned", nbins=NBINS)
    for topology in ("allgather", "ring"):
        bs.reset_launches()
        cm.reset_launches()
        sketch, sq, _ = sharded.sharded_blocked_fd_sketch(cols, mesh=mesh, topology=topology,
                                                          **kw)
        blocks = N // BLOCK
        assert (bs.launches, bs.pair_launches, cm.launches_t, cm.launches) == (
            2 * blocks, blocks, 2 * blocks, blocks)
        sketch1, sq1, _ = ba.blocked_fd_sketch(cols, **kw)
        assert float(sq) == float(sq1)
        torch.testing.assert_close(sketch, sketch1, rtol=0, atol=0)


@pytest.mark.cuda
def test_rows_svd_and_spectral_equal_the_single_device_sweeps(mesh, cuda):
    from mused_tpu_torch.ops import blocked_spectral as bspec
    from mused_tpu_torch.parallel import sharded
    cols = _columns(_window(N, seed=1), cuda)
    sweep = dict(block=BLOCK, k_basis=KB, select="binned", nbins=NBINS)
    g = torch.Generator(device=cuda).manual_seed(3)
    omega = torch.randn((N, 24), generator=g, device=cuda)
    got = sharded.sharded_blocked_svd_reduce(cols, None, rank=16, mesh=mesh, omega=omega,
                                             **sweep)
    want = ba.blocked_svd_reduce(cols, None, rank=16, omega=omega, **sweep)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    probe = torch.randn((N, 12), generator=g, device=cuda)
    _, lam = sharded.sharded_spectral_embedding(cols, None, k_max=4, mesh=mesh, probe=probe,
                                                **sweep)
    _, lam1 = bspec.spectral_embedding_blocked(cols, None, k_max=4, probe=probe, **sweep)
    torch.testing.assert_close(lam, lam1, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_dense_fused_shard_on_the_card_matches_the_cpu(mesh, cuda):
    from mused_tpu_torch.parallel import sharded
    wf = _window(1024, seed=2)
    for keep in MODALITIES:
        masked = {k: np.array(v) for k, v in wf._asdict().items()}
        for other in set(MODALITIES) - {keep}:
            if other == "location":
                masked["location"][:] = np.nan
            elif other == "time":
                masked["times"][:] = 0.0
            elif other == "username":
                masked["user_ids"][:] = -1
            elif other == "tags":
                masked["tags"][:] = 0
                masked["tags_valid"][:] = False
            else:
                masked["text"][:] = 0
        feats = tuple(torch.from_numpy(a) for a in type(wf)(**masked))
        got = sharded.fused_shard(tuple(f.to(cuda) for f in feats), ("standard",),
                                  k_basis=KB, mesh=mesh, tags_dim=256, text_dim=512).cpu()
        want = sharded.features_to_fused_shard(feats, ("standard",), KB, 256, 512,
                                               _LocalAxis())
        assert want.sum() > 0, keep
        if keep in ("time", "username", "tags"):
            assert torch.equal(got, want), keep
        else:
            assert float((got == want).float().mean()) >= 0.999, keep
            assert torch.equal(got.sum(1), want.sum(1)), keep


@pytest.mark.cuda
def test_sketch_merges_and_sharded_kmeans_at_world_size_one(mesh, cuda):
    from mused_tpu_torch.ops import fd, kmeans
    from mused_tpu_torch.parallel import kmeans_sharded, sketch_merge
    from mused_tpu_torch.parallel.mesh import Axis
    g = torch.Generator(device=cuda).manual_seed(0)
    rows = torch.randn((512, 64), generator=g, device=cuda)
    axis = Axis(mesh, "data")
    sketch = sketch_merge.distributed_fd(rows, ell=16, mesh=mesh, topology="ring")
    torch.testing.assert_close(sketch, fd.update_stream(fd.init(16, 64, cuda), rows).sketch)
    assert torch.equal(sketch_merge.merge(sketch, 16, axis, "allgather"), sketch)
    assert float(sketch_merge.global_max_row_norm(rows, axis)) == float(
        torch.max(torch.sum(rows * rows, dim=1)))
    centers = torch.randn((4, 8), generator=g, device=cuda) * 6
    x = (centers.repeat_interleave(64, 0)
         + 0.2 * torch.randn((256, 8), generator=g, device=cuda))
    init = torch.zeros((6, 8), device=cuda)
    init[:4] = x[torch.tensor([0, 70, 130, 200], device=cuda)]
    init[3] = 1e3                                        # an empty live cluster: relocation
    labels, cents = kmeans_sharded.kmeans_sharded(x, 4, None, k_max=6, mesh=mesh, init=init)
    labels1, cents1 = kmeans.kmeans(x, 4, None, k_max=6, init=init)
    assert torch.equal(labels.long(), labels1.long())
    torch.testing.assert_close(cents, cents1, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_rows_engine_at_world_size_one_equals_the_single_device_engine(mesh, cuda):
    """The dense sharded step (and a forced-blocked window) through
    ``process_streaming_data`` with the mesh assigned to the engine; the
    single-device dense side fuses on the plain path, the strip the sharded
    step fuses through."""
    import contextlib
    import io

    from mused_tpu_torch import api
    from mused_tpu_torch.data.synthetic import make_stream
    from mused_tpu_torch.engine import streaming
    from mused_tpu_torch.utils.config import PipelineConfig
    mods, mtypes, labels = make_stream(2048, noise_rate=0.5, binary=True,
                                       sort_by_uploaded=True, seed=0)
    for blocked in (False, True):
        cfg = PipelineConfig(window_size=512, reduced_dim=8, k_basis=KB, approach="sSVDMC",
                             n_clusters_override=2, label_mode="binary",
                             force_blocked_window=blocked, use_pallas_affinity=False)
        out = []
        for sharded in (False, True):
            engine = streaming.StreamingEngine(cfg, cuda)
            if sharded:
                engine.mesh = mesh
            with contextlib.redirect_stdout(io.StringIO()):
                res = api.process_streaming_data(
                    api.get_initial_results()[0], mods, mtypes, 512, 8, KB, 2, 0, "sSVDMC",
                    labels, 1, 0.5, "binary", True, 1.5, 2, cfg=cfg, engine=engine)
            out.append((res["nmi_score"][0], res["f1_score"][0]))
        assert out[1] == pytest.approx(out[0], abs=1e-6), (blocked, out)
