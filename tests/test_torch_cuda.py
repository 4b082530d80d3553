"""The port's CUDA kernels and its CUDA path, against their plain PyTorch
versions on the same card.

Every test marked ``cuda`` needs an NVIDIA GPU with ``nvcc`` and skips
without one; on such a machine (which need not have JAX):

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

The other tests run anywhere: how the kernel build finds its library and
fails without ``nvcc``.  (That CPU tensors never reach a kernel is in
test_torch_knn.py and test_torch_vote.py.)

Tolerances: the knn5 kernel forms |q|² + |r|² − 2 q·r with FMA
contraction, the plain version with a cuBLAS product, so distances differ
at the rounding scale of |q|² + |r|² (float32 eps times a few); picks may
differ only between references whose exact distances tie within that.
Votes compare rounded scores with 0.96, so a borderline pair may flip: at
most 1 per row and under 1 % of rows differ (tests/test_pallas_vote.py's
own tolerance).
"""

import numpy as np
import pytest
import torch

from light_loam_tpu_torch.models import pipeline as tpl
from light_loam_tpu_torch.ops import cuda_build
from light_loam_tpu_torch.ops.cuda_knn import KNN5, knn5, knn5_plain
from light_loam_tpu_torch.ops.cuda_vote import (
    VOTE,
    compat_votes,
    compat_votes_plain,
)
from light_loam_tpu_torch.ops.graphvote import simple_vote

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the "
                    "kernels")
    return torch.device("cuda", 0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda path: False)
    kernel = cuda_build.CudaKernel("knn.cu", "knn5_launch", [])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.build()
    assert kernel.launches == 0


def test_library_name_follows_the_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// one\n")
    kernel = cuda_build.CudaKernel("k.cu", "k_launch", [])
    first = kernel.library_path()
    assert first.parent == tmp_path / "build" and first.name.startswith("k-")
    (tmp_path / "k.cu").write_text("// two\n")
    assert kernel.library_path() != first


def _check_knn(query, ref, d_k, i_k, d_p, i_p):
    live = d_p < 1e30
    assert torch.equal(live, d_k < 1e30)
    assert torch.equal(i_k[~live], torch.zeros_like(i_k[~live]))
    q = query.double()[:, None, :]
    r_k, r_p = ref.double()[i_k.long()], ref.double()[i_p.long()]
    exact = {"kernel": ((r_k - q) ** 2).sum(-1),
             "plain": ((r_p - q) ** 2).sum(-1)}
    scale = (q ** 2).sum(-1) + torch.maximum((r_k ** 2).sum(-1),
                                             (r_p ** 2).sum(-1))
    tol = 1e-5 * exact["kernel"] + 1e-4 + 4 * EPS32 * scale
    assert ((d_k.double() - exact["kernel"]).abs() <= tol)[live].all()
    assert ((d_p.double() - exact["plain"]).abs() <= tol)[live].all()
    swaps = live & (i_k != i_p)
    assert ((exact["kernel"] - exact["plain"]).abs() <= tol)[swaps].all()


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N,qc,rc", [
    (100, 1000, 100, 1000),      # ragged block and tile edges
    (2048, 32768, 1280, 12288),  # corner shapes, live prefixes
    (8192, 65536, 8192, 65536),  # surf shapes, full
    (256, 4096, 0, 4096),        # no live query
    (256, 4096, 256, 3),         # fewer than 5 live references
])
def test_knn5_kernel_matches_plain(cuda, Q, N, qc, rc):
    rng = np.random.default_rng(Q + N)
    ref = torch.as_tensor(rng.uniform(-60, 60, (N, 3)).astype(np.float32))
    query = ref[torch.as_tensor(rng.integers(0, N, Q))] + torch.as_tensor(
        rng.normal(scale=0.3, size=(Q, 3)).astype(np.float32))
    mask = torch.as_tensor(rng.random(N) < 0.9) & (torch.arange(N) < rc)
    args = [a.to(cuda).contiguous() for a in (query, ref, mask)]
    counts = torch.tensor([qc, rc], dtype=torch.int32, device=cuda)
    before = KNN5.launches
    d_k, i_k = knn5(*args, counts)
    torch.cuda.synchronize()
    assert KNN5.launches == before + 1
    d_p, i_p = knn5_plain(*args, counts)
    assert d_k.dtype == torch.float32 and i_k.dtype == torch.int32
    assert torch.all(d_k[qc:] == 1e30) and torch.all(i_k[qc:] == 0)
    _check_knn(args[0], args[1], d_k, i_k, d_p, i_p)


@pytest.mark.cuda
def test_knn5_refuses_bad_inputs(cuda):
    q = torch.zeros(8, 3, device=cuda)
    r = torch.zeros(32, 3, device=cuda)
    m = torch.ones(32, dtype=torch.bool, device=cuda)
    c = torch.tensor([8, 32], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        knn5(q.double(), r, m, c)
    with pytest.raises(ValueError, match="dtype"):
        knn5(q, r, m, c.long())
    with pytest.raises(ValueError, match="shape"):
        knn5(q, r, m[:16], c)
    with pytest.raises(ValueError, match="contiguous"):
        knn5(q, torch.zeros(3, 32, device=cuda).T, m, c)
    with pytest.raises(ValueError, match="cpu"):
        knn5(q, r.cpu(), m, c)


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [(10, 163), (10, 829), (3, 300), (1, 1)])
def test_compat_votes_kernel_matches_plain(cuda, R, K):
    rng = np.random.default_rng(K)
    src = rng.uniform(-20, 20, (R, K, 3)).astype(np.float32)
    bad = rng.random((R, K)) < 0.25
    tgt = src + 0.3 + np.where(bad[..., None], rng.uniform(2, 8, (R, K, 3)),
                               0.0)
    valid = (rng.random((R, K)) < 0.9).astype(np.float32)
    s, t, v = (torch.as_tensor(a.astype(np.float32)).to(cuda)
               for a in (src * valid[..., None], tgt * valid[..., None],
                         valid))
    before = VOTE.launches
    v_k = compat_votes(s, t, v)
    torch.cuda.synchronize()
    assert VOTE.launches == before + 1
    v_p = compat_votes_plain(s, t, v)
    diff = (v_k - v_p).abs()
    assert diff.max().item() <= 1.0
    assert (diff > 0).float().mean().item() < 0.01 or R * K < 100


@pytest.mark.cuda
def test_xla_vote_backend_refused_on_cuda(cuda):
    x = torch.zeros(64, 3, device=cuda)
    with pytest.raises(ValueError, match="vote_backend"):
        simple_vote(x, x, torch.ones(64, dtype=torch.bool, device=cuda),
                    n_regions=4, chunk_capacity=20, backend="xla")


@pytest.mark.cuda
def test_cuda_pipeline_matches_cpu_and_counts_launches(cuda):
    run = dict(n_frames=3, profile="hdl64-small", n_azimuth=700, speed=0.6,
               seed=2)
    cfg = tpl.PROFILES[run["profile"]]
    KNN5.launches = VOTE.launches = 0
    pipe, res, _ = tpl.run_synthetic(**run, device="cuda")
    n_mapped = sum(r.mapped for r in res)
    # one vote per odometry outer iteration; a corner and a surf 5-NN per
    # mapping outer iteration
    assert VOTE.launches == cfg.odometry.outer_iterations * len(res)
    assert KNN5.launches == 2 * cfg.mapping.outer_iterations * n_mapped
    cpu_pipe, _, _ = tpl.run_synthetic(**run, device="cpu")
    # the CPU and the card round differently; see test_torch_pipeline.py
    np.testing.assert_allclose(pipe.mapped_positions(),
                               cpu_pipe.mapped_positions(), rtol=0, atol=0.02)
