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
own tolerance).  Against float64 truth, a row's count may differ only by
its pairs whose float64 score lies within the float32 rounding bound of
the threshold (see ``votes_f64``).
"""

import math

import numpy as np
import pytest
import torch

from light_loam_tpu_torch.models import pipeline as tpl
from light_loam_tpu_torch.ops import cuda_build
from light_loam_tpu_torch.ops.cuda_knn import (
    KNN5,
    knn5,
    knn5_plain,
    knn_geometry,
    segment_length,
)
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
    (2048, 32768, 2048, 12289),  # rc not a multiple of the segment count
    (2048, 32768, 1280, 17),     # rc below the segment count
    (256, 4096, 256, 0),         # no live reference
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


def lattice_knn_inputs(Q, N, rc, seed, segments=None):
    """Integer coordinates in [-20, 20], where every product and sum of the
    Gram form is exact in float32, so any two correct 5-NN agree bit for
    bit.  41^3 lattice points for up to 65536 references tie often; on top,
    three copies of one reference straddle every border of ``segments``
    segments (the kernel's own by default), and the queries sit on or next
    to references."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(-20, 21, (N, 3)).astype(np.float32)
    length = segment_length(rc, segments or knn_geometry(Q, N).segments)
    for b in range(length, rc, max(length, 1)):
        ref[b - 1:b + 2] = ref[b - 1]
    query = (ref[rng.integers(0, max(rc, 1), Q)]
             + rng.integers(-1, 2, (Q, 3))).astype(np.float32)
    mask = (rng.random(N) < 0.9) & (np.arange(N) < rc)
    return query, ref, mask


@pytest.mark.cuda
@pytest.mark.parametrize("Q,N,qc,rc", [
    (2048, 32768, 1280, 12288),  # corner shapes, live prefixes
    (2048, 32768, 2048, 12289),
    (8192, 65536, 5120, 24576),  # surf shapes, live prefixes
    (300, 5000, 300, 4001),
])
def test_knn5_kernel_equals_plain_exactly_on_ties(cuda, Q, N, qc, rc):
    """Exact arithmetic leaves only the tie rule: the kernel must pick the
    lower index among equal distances, across segment borders too."""
    arrays = lattice_knn_inputs(Q, N, rc, seed=rc)
    args = [torch.as_tensor(a).to(cuda) for a in arrays]
    counts = torch.tensor([qc, rc], dtype=torch.int32, device=cuda)
    d_k, i_k = knn5(*args, counts)
    d_p, i_p = knn5_plain(*args, counts)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    # ties did occur: some query has two equal distances among its picks
    assert bool((d_p[:qc, 1:] == d_p[:qc, :-1]).any())


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
@pytest.mark.parametrize("R,K", [(10, 163), (10, 829), (3, 300), (1, 1),
                                 (2, 7000)])  # 7000: j tiles stream
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


# Gram-form d² = (|xᵢ|² + |xⱼ|²) − 2 xᵢ·xⱼ in float32: the norms, the dot
# product, their sum and the difference each round at the scale of
# |xᵢ|² + |xⱼ|², about 9 unit roundoffs (4.5 eps32) in all without FMA.
VOTE_ULPS = 6.0


def votes_f64(src, tgt, valid, threshold):
    """(float64 vote counts, per row the number of pairs whose float64
    argument a = −gap² lies within the float32 rounding bound of
    ln(threshold)) for one chunk, resolution 1."""
    def dists(p):
        p = p.double()
        d = torch.cdist(p, p, compute_mode="donot_use_mm_for_euclid_dist")
        n = (p * p).sum(-1)
        e2 = VOTE_ULPS * EPS32 * (n[:, None] + n[None, :])
        # the d² error carried through the sqrt, plus the sqrt's rounding
        return d, torch.minimum(e2.sqrt(), e2 / d.clamp_min(1e-30)) + EPS32 * d

    ds, es = dists(src)
    dt, et = dists(tgt)
    gap = ds - dt
    eg = es + et + EPS32 * gap.abs()
    a = -(gap * gap)
    # gap², the sign and expf's 2 ulp (2^-22 of e^a, i.e. of a's scale)
    da = 2 * gap.abs() * eg + eg * eg + 2 * EPS32 * a.abs() + 2.0 ** -22
    c = math.log(threshold)
    K = len(valid)
    ok = ((valid[:, None] * valid[None, :]) > 0) & ~torch.eye(
        K, dtype=torch.bool, device=valid.device)
    counts = ((a < c) & ok).sum(-1)
    loose = (((a - c).abs() <= da) & ok).sum(-1)
    near = (((a - c).abs() < 0.01) & ok).sum()
    return counts, loose, near


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [(10, 163), (10, 829), (2, 7000)])
def test_compat_votes_kernel_matches_float64_truth(cuda, R, K):
    """Gaps spread around the threshold's (0.2 m): every count equals the
    float64 count up to the row's pairs within rounding of the threshold."""
    rng = np.random.default_rng(K + 1)
    src = rng.uniform(-40, 40, (R, K, 3))
    tgt = src + 0.3 + rng.normal(scale=0.1, size=(R, K, 3))
    valid = rng.random((R, K)) < 0.9
    s, t = (torch.as_tensor((a * valid[..., None]).astype(np.float32)).to(cuda)
            for a in (src, tgt))
    v = torch.as_tensor(valid.astype(np.float32)).to(cuda)
    thr = float(np.float32(0.96))
    got = compat_votes(s, t, v, thr)
    n_loose = n_near = 0
    for r in range(R):
        want, loose, near = votes_f64(s[r], t[r], v[r], thr)
        assert ((got[r].double() - want).abs() <= loose).all(), r
        n_loose += int(loose.sum())
        n_near += int(near)
    pairs = R * K * K
    # the border is crowded, and the rounding bound is narrow
    assert n_near > 0.01 * pairs and n_loose < 1e-3 * pairs, (n_near, n_loose)


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
