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
the threshold (see ``votes_f64``).  The full graph vote on the card is held
to the same call on CPU tensors, and the tiled surf search to the grid
search, by the same float64 rules (``full_vote_margins``); the pipeline's
launch counts are derived from its config (``chip_smoke.expected_launches``)
with the vote path off and with the latent vote path on.

The segment sum (csrc/segsum.cu) adds each slot's rows in row order, the
order of ``index_add`` on the CPU, so it is held to its plain version on
CPU copies of its inputs bit for bit.  So are the feature picks (csrc/features.cu:
every product and sum of the curvature rounded on its own, the picks
integer logic over it), and the feature stage with them is held to the
stage with the plain picks on the same card.  The fused frame (models/fused.py)
replays a CUDA graph of the very ops the eager body enqueues, and the
staged path runs the same stage functions; with the voxel, store and
refinement sums ordered, graph, eager body and staged run are the same
computation, and two runs with PyTorch's default settings are held to each
other bitwise.  The staged path replays one captured graph per stage
(models/stages.py); each replay is held to its body run eagerly, and the
staged Pipeline to its run under ``stages.eager()``, bitwise.  (With ``index_add_``'s atomics the order of the adds
changed from run to run, and through the float32 plane-fit gates, ROADMAP.md
Queue 3, the trajectory: millimetres after a few flagship frames.)  The
graph tests written then run under ``torch.use_deterministic_algorithms``
and are held to 1e-5; their twins with the default settings bitwise.
The batched lanes (models/batch.py) launch each kernel once for all lanes
through the kernels' vmap rules; a lane's result is bit for bit the single
launch's.  Their graph is held to the eager vmapped body under
deterministic sums, as the fused frame's is.  The spans inside a stage
(utils/timing.py) add up to the stage's own span, and a graph's span to
the profiler's first-to-last kernel of the same replay.  The test of a
failed capture comes last in the file: it leaves a broken capture behind
it.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from chip_smoke import (
    FEATURE_LANE_CASES,
    LM_FRAMES,
    LM_Q_TOL,
    LM_T_TOL_M,
    dense_grid,
    expected_launches,
    feature_grids,
    graph_launches_since,
    keyframe_launches,
    latent_vote_config,
    pad_rings,
    plain_feature_stage,
    plain_picks,
    record_lm_calls,
    replay_kernel_counts,
    replay_launches,
    ring_frames,
    stage_frames,
)
from light_loam_tpu_torch.core.frame import PointCloud, RangeImage
from light_loam_tpu_torch.models import batch, fused, stages
from light_loam_tpu_torch.models import pipeline as tpl
from light_loam_tpu_torch.models.mapping import MappingState, mapping_step
from light_loam_tpu_torch.models.odometry import OdometryState
from light_loam_tpu_torch.ops import cuda_build
from light_loam_tpu_torch.ops.cuda_features import FEATURES, pick_features
from light_loam_tpu_torch.ops.cuda_segsum import (
    SEGSUM,
    segment_sum,
    segment_sum_plain,
)
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
from light_loam_tpu_torch.ops.features import extract_features
from light_loam_tpu_torch.ops.graphvote import full_graph_vote, simple_vote
from light_loam_tpu_torch.ops.knn import (
    surf_correspondences,
    surf_correspondences_grid,
)
from light_loam_tpu_torch.ops.voxel import compact_rows
from light_loam_tpu_torch.solver import EdgeFactors, FactorSet, PlaneFactors
from light_loam_tpu_torch.solver.gauss_newton import (
    LM,
    _identity,
    _lm_loop,
    lm_solve,
    staged_bytes,
    uses_lm_kernel,
)
from light_loam_tpu_torch.utils.synthetic import World, simulate_scan
from light_loam_tpu_torch.utils.timing import StageTimers

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)
# the hand-written kernels, each with its launch count
KERNELS = (KNN5, VOTE, SEGSUM, LM, FEATURES)


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
@pytest.mark.parametrize("R,K", [(10, 163), (10, 829), (5, 158), (3, 300),
                                 (1, 1), (2, 7000)])  # 7000: j tiles stream
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
@pytest.mark.parametrize("R,K", [(10, 163), (10, 829), (5, 158), (2, 7000)])
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


# Full vote decisions taken in float32 (G > 0.95, first-order ≥ the
# adaptive threshold) may flip where float64 truth puts them within the
# float32 rounding of their threshold: G carries the Gram-form rounding of
# the distances (|gap| error ~1e-4 at 40 m coordinates, so ~1e-4 in G), and
# first-order scores average cube roots of such G.
DECISION_TOL = 2e-4


def full_vote_margins(src, tgt, n_regions, edge_threshold=0.95):
    """Per compacted entry, in float64 over the reference's contiguous
    chunks: the smallest distance of a decision that feeds its score to its
    threshold (its edges to 0.95, its own and its neighbours' first-order
    scores to the chunk's adaptive threshold)."""
    src = np.asarray(src, np.float64)
    tgt = np.asarray(tgt, np.float64)
    n = len(src)
    margin = np.full(n, np.inf)
    for c in range(n_regions):
        lo = n // n_regions * c
        hi = n if c == n_regions - 1 else n // n_regions * (c + 1)
        if hi <= lo:
            continue
        ds = np.linalg.norm(src[lo:hi, None] - src[None, lo:hi], axis=-1)
        dt = np.linalg.norm(tgt[lo:hi, None] - tgt[None, lo:hi], axis=-1)
        G = np.exp(-(ds - dt) ** 2)
        np.fill_diagonal(G, 0.0)
        A = G > edge_threshold
        deg = A.sum(1)
        G3 = np.cbrt(G)
        B = A * G3
        tri = 0.5 * (B * (B @ G3)).sum(1)
        den = deg * (deg - 1) * 0.5
        fo = np.where(deg > 1, tri / np.maximum(den, 1), 0.0)
        thr = min(tri[deg > 1].sum() / max(den[deg > 1].sum(), 1e-12),
                  fo.mean())
        d_fo = np.abs(fo - thr)
        edge = np.where(np.eye(hi - lo, dtype=bool), np.inf,
                        np.abs(G - edge_threshold))
        nb = np.where(A, d_fo[None, :], np.inf).min(1)
        margin[lo:hi] = np.minimum.reduce([edge.min(1), d_fo, nb])
    return margin


def full_vote_case(case):
    """(src, tgt, valid, n_regions, chunk_capacity): the JAX package's test
    inputs (tests/test_graphvote.py), without and with padding slots, and
    the odometry and mapping vote shapes R = 10, K = 163 and 829."""
    if case == "literal":
        rng = np.random.default_rng(3)
        n, R = 90, 3
        src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        tgt = src + np.array([1.5, -0.7, 0.2], np.float32)
        tgt += rng.normal(0, 0.02, (n, 3)).astype(np.float32)
        out = rng.choice(n, n // 4, replace=False)
        tgt[out] += rng.uniform(2.0, 8.0, (len(out), 3)).astype(np.float32)
        return src, tgt.astype(np.float32), np.ones(n, bool), R, n // R + R
    if case == "padding":
        rng = np.random.default_rng(5)
        n_valid, R = 60, 3
        src_c = rng.uniform(-15, 15, (n_valid, 3)).astype(np.float32)
        tgt_c = src_c + np.array([0.4, 0.9, -0.1], np.float32)
        tgt_c += rng.normal(0, 0.02, (n_valid, 3)).astype(np.float32)
        bad = rng.choice(n_valid, 12, replace=False)
        tgt_c[bad] += rng.uniform(2.0, 6.0, (12, 3)).astype(np.float32)
        valid = np.zeros(100, bool)
        slots = np.sort(rng.choice(100, n_valid, replace=False))
        valid[slots] = True
        src = np.zeros((100, 3), np.float32)
        tgt = np.zeros((100, 3), np.float32)
        src[slots], tgt[slots] = src_c, tgt_c
        return src, tgt, valid, R, n_valid // R + R
    # odometry plane vote (1536 flat slots, K = 163) or mapping vote (8192
    # stack slots, K = 829): ~92 % valid, a rigid motion with noise and a
    # sixth of outliers
    n, R = {"odometry": (1536, 10), "mapping": (8192, 10)}[case]
    rng = np.random.default_rng(n)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = src + np.array([0.6, 0.1, -0.05], np.float32)
    tgt += rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    bad = rng.random(n) < 1 / 6
    tgt[bad] += rng.uniform(2.0, 6.0, (bad.sum(), 3)).astype(np.float32)
    valid = rng.random(n) < 0.92
    return src, tgt.astype(np.float32), valid, R, n // R + R


@pytest.mark.cuda
def test_xla_vote_backend_refused_on_cuda(cuda):
    x = torch.zeros(64, 3, device=cuda)
    with pytest.raises(ValueError, match="vote_backend"):
        simple_vote(x, x, torch.ones(64, dtype=torch.bool, device=cuda),
                    n_regions=4, chunk_capacity=20, backend="xla")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odometry", "mapping"])
def test_full_graph_vote_cuda_matches_cpu(cuda, case):
    """The same call on CUDA and on CPU tensors: selections equal but for
    entries with a decision within DECISION_TOL of its threshold in float64,
    scores within 1e-5 (cuBLAS and the CPU sum the triangle products in
    other orders)."""
    src, tgt, valid, R, K = full_vote_case(case)
    slots = np.nonzero(valid)[0]
    margin = np.full(len(valid), np.inf)
    margin[slots] = full_vote_margins(src[slots], tgt[slots], R)
    excused = margin < DECISION_TOL
    args = [torch.as_tensor(a) for a in (src, tgt, valid)]
    cpu = full_graph_vote(*args, n_regions=R, chunk_capacity=K)
    gpu = full_graph_vote(*(a.to(cuda) for a in args), n_regions=R,
                          chunk_capacity=K)
    g_sel, g_score = gpu.selected.cpu().numpy(), gpu.score.cpu().numpy()
    c_sel, c_score = cpu.selected.numpy(), cpu.score.numpy()
    assert 0.3 * valid.sum() < c_sel.sum() < valid.sum()
    bad = [(int(i), float(margin[i])) for i in np.nonzero(g_sel != c_sel)[0]
           if not excused[i]]
    assert not bad, f"selection differs at (entry, margin) {bad}"
    both = g_sel & c_sel & ~excused
    np.testing.assert_allclose(g_score[both], c_score[both], rtol=0,
                               atol=1e-5)


def _ring_slotted(n_rings=64, per_ring=1024, seed=0):
    """A flagship-sized ring-slotted less-flat cloud (ring r owns rows
    [r * per_ring, (r + 1) * per_ring)) about 40 % full, and a query set
    moved by 0.3 m."""
    rng = np.random.default_rng(seed)
    pts = simulate_scan(World.urban(seed=seed), np.zeros(3), n_rings=n_rings,
                        n_azimuth=900, noise=0.01, seed=seed + 1)
    ring = np.arange(len(pts)) % n_rings
    xyz = np.zeros((n_rings * per_ring, 3), np.float32)
    rel = np.zeros(n_rings * per_ring, np.float32)
    mask = np.zeros(n_rings * per_ring, bool)
    for r in range(n_rings):
        sel = pts[ring == r][:per_ring]
        rows = r * per_ring + np.arange(len(sel))
        xyz[rows], rel[rows] = sel, r + 0.05
        mask[rows] = rng.random(len(sel)) < 0.9
    query = (pts[rng.permutation(len(pts))[:1536]]
             + np.float32(0.3)).astype(np.float32)
    return xyz, rel, mask, query


@pytest.mark.cuda
def test_surf_tiled_matches_grid_on_card(cuda):
    """The tiled search on the compacted cloud (live count read once) and
    the grid search on the ring-slotted cloud, both on the card: the same
    points but where float64 puts two candidates within the Gram rounding
    of each other, and valid flags equal but within that rounding of the
    25 m² gate."""
    xyz, rel, mask, query = _ring_slotted()
    dev_cloud = PointCloud(*(torch.as_tensor(a).to(cuda)
                             for a in (xyz, rel, mask)))
    km, kx, kr = compact_rows(dev_cloud.mask, dev_cloud.capacity,
                              dev_cloud.xyz, dev_cloud.rel)
    compact = PointCloud(kx, kr, km)
    q = torch.as_tensor(query).to(cuda)
    qm = torch.ones(len(query), dtype=torch.bool, device=cuda)
    g = surf_correspondences_grid(q, qm, dev_cloud, 64)
    t = surf_correspondences(q, qm, compact, ref_count=int(km.sum()))
    qd = q.double()
    scale = (qd * qd).sum(-1) + 1e4
    tol = 1e-5 * 25 + 1e-4 + 4 * EPS32 * scale
    pairs = ((t.a_idx, g.a_idx), (t.b_idx, g.b_idx), (t.c_idx, g.c_idx))
    d_t = [((compact.xyz[ti].double() - qd) ** 2).sum(-1) for ti, _ in pairs]
    d_g = [((dev_cloud.xyz[gi].double() - qd) ** 2).sum(-1) for _, gi in pairs]
    near_gate = torch.stack([(d - 25.0).abs() <= tol for d in d_g]).any(0)
    assert int(g.valid.sum()) > 500
    assert not ((t.valid != g.valid) & ~near_gate).any()
    both = t.valid & g.valid
    for (ti, gi), dt, dg in zip(pairs, d_t, d_g):
        moved = both & (compact.xyz[ti] != dev_cloud.xyz[gi]).any(-1)
        assert not (moved & ((dt - dg).abs() > tol)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("latent", [False, True])
def test_cuda_pipeline_matches_cpu_and_counts_launches(cuda, latent):
    """The staged Pipeline on the card: its stages' replays launch what the
    config says, the run op by op (``stages.eager()``) launches the same
    through the wrappers and ends bitwise where the replays do, and both
    stay near the CPU run."""
    run = dict(n_frames=5 if latent else 3, profile="hdl64-small",
               n_azimuth=700, speed=0.6, seed=2)
    cfg = tpl.PROFILES[run["profile"]]
    if latent:
        cfg = latent_vote_config(cfg)
    graphs = stages.stage_graphs(cfg, cuda)
    replays = [g.replays for g in graphs]
    _zero_launches()
    pipe, res = _run_synthetic(cfg, run, "cuda")
    n_mapped = sum(r.mapped for r in res)
    # the stages replay their graphs; the wrappers count the host loop's
    # keyframe stacks alone
    assert _launches() == keyframe_launches(n_mapped)
    assert graph_launches_since(graphs, replays) == expected_launches(
        cfg, len(res), n_mapped, keyframes=0)
    _zero_launches()
    with stages.eager():
        eager, eager_res = _run_synthetic(cfg, run, "cuda")
    assert _launches() == expected_launches(cfg, len(res), n_mapped)
    np.testing.assert_array_equal(eager.mapped_positions(),
                                  pipe.mapped_positions())
    cpu_pipe, _ = _run_synthetic(cfg, run, "cpu")
    # the CPU and the card round differently; see test_torch_pipeline.py
    np.testing.assert_allclose(pipe.mapped_positions(),
                               cpu_pipe.mapped_positions(), rtol=0, atol=0.02)


def _launches() -> dict:
    return {k.source.name: k.launches for k in KERNELS}


def _zero_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def _run_synthetic(cfg, run, device):
    pipe = tpl.Pipeline(cfg, device=device)
    frames = tpl.synthetic_frames(run["n_frames"], cfg, run["n_azimuth"],
                                  run["speed"], run["seed"])
    return pipe, [pipe.process_frame(xyz, mask) for _, xyz, mask in frames]


# graph against eager, fused against staged, under deterministic sums (module
# docstring): the runs measured bitwise equal; held to the 1e-5 of the CPU
# twins in tests/test_torch_fused.py
GRAPH_ATOL = 1e-5
# two runs with PyTorch's default settings: with index_add_'s atomic sums
# they were held to 3 cm, with the ordered sums bitwise
DEFAULT_ATOL_M = 0.0


@pytest.fixture
def deterministic_sums():
    """PyTorch's deterministic algorithms, for this test only.  Graphs are
    captured with the setting in force, so none outlives the test."""
    from light_loam_tpu_torch.parallel import sharded

    fused.clear_graphs()
    sharded.clear_graphs()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)
    fused.clear_graphs()
    sharded.clear_graphs()


def _small_frames(cfg, n, device):
    return [(torch.as_tensor(xyz).to(device), torch.as_tensor(mask).to(device))
            for _, xyz, mask in tpl.synthetic_frames(n, cfg, 700, 0.6, 2)]


def _init_states(cfg, device):
    return (OdometryState.init(cfg.scan.max_less_sharp,
                               cfg.scan.max_less_flat, device),
            MappingState.init(cfg.mapping, device))


@pytest.mark.cuda
@pytest.mark.parametrize("surf_knn", ["auto", "tiled"])
def test_graph_replay_matches_eager_body(cuda, monkeypatch, deterministic_sums,
                                         surf_knn):
    """Three frames through ``fused_frame_step`` (one capture, then one
    replay per frame, no eager pass) and through the eager body on the
    same states; the call makes no host read, under the tiled search too.
    A traced replay runs the kernels the wrappers counted at capture."""
    base = tpl.PROFILES["hdl64-small"]
    cfg = dataclasses.replace(
        base, odometry=dataclasses.replace(base.odometry, surf_knn=surf_knn))
    frames = _small_frames(cfg, 3, cuda)
    body_calls = []
    real_body = fused._fused_frame_body
    monkeypatch.setattr(fused, "_fused_frame_body",
                        lambda *a: body_calls.append(1) or real_body(*a))
    _zero_launches()
    graph = fused.frame_graph(cfg, cuda)
    assert len(body_calls) == fused.WARMUP_PASSES + 1
    per_replay = replay_launches(cfg)
    assert graph.kernel_launches == per_replay
    # the wrappers counted the warm-up and the capture pass, and count no
    # replay
    passes = expected_launches(cfg, len(body_calls), len(body_calls),
                               keyframes=0)
    assert _launches() == passes
    assert replay_kernel_counts(graph)[0] == per_replay

    odo_g, map_g = _init_states(cfg, cuda)
    odo_e, map_e = _init_states(cfg, cuda)
    for xyz, mask in frames:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            odo_g, map_g, out_g, mout_g, div_g = fused.fused_frame_step(
                odo_g, map_g, xyz, mask, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        odo_e, map_e, out_e, mout_e, div_e = real_body(odo_e, map_e, xyz,
                                                       mask, cfg)
        assert not bool(div_g) and not bool(div_e)
        for got, want in ((out_g.t_w, out_e.t_w), (out_g.q_w, out_e.q_w),
                          (mout_g.t_w, mout_e.t_w), (mout_g.q_w, mout_e.q_w),
                          (map_g.t_wm, map_e.t_wm)):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=0, atol=GRAPH_ATOL)
        assert int(mout_e.map_surf_points) > 0
        assert int(mout_g.map_surf_points) == int(mout_e.map_surf_points)
    # one capture served every frame; the eager body above ran unpatched
    assert len(body_calls) == fused.WARMUP_PASSES + 1
    assert graph.replays == 3 and fused.frame_graph(cfg, cuda) is graph
    eager = expected_launches(cfg, 3, 3, keyframes=0)
    assert _launches() == {name: passes[name] + eager[name] for name in eager}


@pytest.mark.cuda
def test_chunk_graph_matches_per_frame_graph(cuda, deterministic_sums):
    """A chunk of 3 frames (three replays fed from one device buffer, one
    host read) against three per-frame calls; frames given on the host, as
    the replay entry points give them."""
    cfg = tpl.PROFILES["hdl64-small"]
    frames = _small_frames(cfg, 3, "cpu")
    odo, mp = _init_states(cfg, cuda)
    per_frame = []
    for xyz, mask in frames:
        odo, mp, _, mout, _ = fused.fused_frame_step(odo, mp, xyz, mask, cfg)
        per_frame.append(mout.t_w.cpu().numpy())
    odo2, mp2, outs = fused.fused_chunk_step(
        *_init_states(cfg, cuda), torch.stack([f[0] for f in frames]),
        torch.stack([f[1] for f in frames]), cfg)
    assert fused.frame_graph(cfg, cuda, chunk=3).replays == 3
    assert not outs.diverged.any()
    np.testing.assert_allclose(outs.map_t.cpu().numpy(), np.stack(per_frame),
                               rtol=0, atol=GRAPH_ATOL)
    np.testing.assert_allclose(odo2.t_w.cpu().numpy(), odo.t_w.cpu().numpy(),
                               rtol=0, atol=GRAPH_ATOL)
    assert int(mp2.frame) == int(mp.frame) == 3


def _fused_and_staged(cuda, run):
    base = tpl.PROFILES["hdl64-small"]
    cfg = dataclasses.replace(base, fused_step=True)
    graph = fused.frame_graph(cfg, cuda)
    _zero_launches()
    pipe, res = _run_synthetic(cfg, run, "cuda")
    assert graph.replays == run["n_frames"] and all(r.mapped for r in res)
    # the fused run went through the graph alone, but for the host loop's
    # keyframe stack (one segment sum a frame)
    assert KNN5.launches == VOTE.launches == LM.launches == 0
    assert SEGSUM.launches == run["n_frames"]
    staged, sres = _run_synthetic(base, run, "cuda")
    assert len(pipe._keyframes) == len(staged._keyframes) == run["n_frames"]
    assert "fused_step" in pipe.timers.report()
    return pipe, res, staged, sres


@pytest.mark.cuda
def test_fused_pipeline_matches_staged_on_card(cuda, deterministic_sums):
    """The Pipeline with ``fused_step`` on the card: the staged run's
    positions, its bookkeeping, one replay per frame."""
    run = dict(n_frames=4, n_azimuth=700, speed=0.6, seed=2)
    pipe, res, staged, sres = _fused_and_staged(cuda, run)
    np.testing.assert_allclose(pipe.mapped_positions(),
                               staged.mapped_positions(), rtol=0,
                               atol=GRAPH_ATOL)
    for rf, rs in zip(res, sres):
        np.testing.assert_allclose(rf.odom_t, rs.odom_t, atol=GRAPH_ATOL)


@pytest.mark.cuda
def test_fused_pipeline_near_staged_with_atomic_sums(cuda):
    """The same with PyTorch's default settings, as the entry points run:
    with the ordered sums the two runs are bitwise equal (module
    docstring)."""
    fused.clear_graphs()
    run = dict(n_frames=4, n_azimuth=700, speed=0.6, seed=2)
    pipe, _, staged, _ = _fused_and_staged(cuda, run)
    np.testing.assert_allclose(pipe.mapped_positions(),
                               staged.mapped_positions(), rtol=0,
                               atol=DEFAULT_ATOL_M)
    fused.clear_graphs()


def _to(tree, device):
    """Nested NamedTuples of tensors, moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(_to(part, device) for part in tree))


@pytest.mark.cuda
def test_mapping_step_recenters_on_card(cuda):
    """A pose eight cubes away recenters the grid: on the card the step
    selects the re-sorted store, as it does on CPU tensors from the same
    state (live rows and their cells; the centroids differ by the rounding
    of the sums)."""
    cfg = tpl.PROFILES["hdl64-small"]
    run = dict(n_frames=2, n_azimuth=700, speed=0.6, seed=2)
    pipe, _ = _run_synthetic(cfg, run, "cpu")
    far = torch.tensor([400.0, 0.0, 0.0])
    stores = {}
    for device in ("cpu", cuda):
        odo = _to(pipe.odo_state, device)
        state, out = mapping_step(_to(pipe.map_state, device), odo.corner_last,
                                  odo.surf_last, odo.q_w, far.to(device),
                                  cfg.mapping)
        assert not torch.equal(state.cen.cpu(), pipe.map_state.cen)
        stores[str(device)] = (state, out)
    (s_cpu, o_cpu), (s_gpu, o_gpu) = stores.values()
    assert torch.equal(s_gpu.cen.cpu(), s_cpu.cen)
    assert int(o_gpu.map_surf_points) == int(o_cpu.map_surf_points) > 0
    assert int(o_gpu.map_corner_points) == int(o_cpu.map_corner_points) > 0
    assert torch.equal(s_gpu.surf.mask.cpu(), s_cpu.surf.mask)
    assert torch.equal(s_gpu.surf.cell.cpu(), s_cpu.surf.cell)
    np.testing.assert_allclose(s_gpu.surf.xyz.cpu().numpy(),
                               s_cpu.surf.xyz.numpy(), rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Q,N", [(1, 2048, 32768), (3, 2048, 32768),
                                   (4, 8192, 65536), (2, 300, 5000)])
def test_knn5_lanes_equal_single_launches(cuda, B, Q, N):
    """``torch.vmap(knn5)``: one launch for all B lanes, each lane bit for
    bit its own single launch and within the Gram-form tolerance of the
    plain version on that lane, with per-lane counts that differ (one
    lane's queries all dead when B > 2)."""
    rng = np.random.default_rng(B + Q)
    ref = rng.uniform(-60, 60, (B, N, 3)).astype(np.float32)
    query = (ref[:, :Q] + rng.normal(scale=0.3, size=(B, Q, 3))).astype(
        np.float32)
    qc = [Q, Q * 5 // 8, 0, Q // 3][:B]
    rc = [N, N * 3 // 8, N // 2, 17][:B]
    mask = (rng.random((B, N)) < 0.9) & (np.arange(N)[None] < np.array(
        rc)[:, None])
    args = [torch.as_tensor(a).to(cuda) for a in (query, ref, mask)]
    counts = torch.tensor(np.stack([qc, rc], 1), dtype=torch.int32,
                          device=cuda)
    before = KNN5.launches
    d_b, i_b = torch.vmap(knn5)(*args, counts)
    torch.cuda.synchronize()
    assert KNN5.launches == before + 1
    assert d_b.shape == (B, Q, 5) and i_b.dtype == torch.int32
    for b in range(B):
        lane = [a[b] for a in args]
        d1, i1 = knn5(*lane, counts[b])
        assert torch.equal(d_b[b], d1) and torch.equal(i_b[b], i1)
        _check_knn(lane[0], lane[1], d_b[b], i_b[b],
                   *knn5_plain(*lane, counts[b]))
    # an unbatched operand is broadcast to every lane
    d_s, i_s = torch.vmap(knn5, in_dims=(0, None, None, 0))(
        args[0], args[1][0], args[2][0], counts)
    for b in range(B):
        d1, i1 = knn5(args[0][b], args[1][0], args[2][0], counts[b])
        assert torch.equal(d_s[b], d1) and torch.equal(i_s[b], i1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,K", [(4, 10, 163), (8, 10, 163), (4, 10, 829),
                                   (3, 5, 158)])
def test_compat_votes_lanes_equal_single_launches(cuda, B, R, K):
    """``torch.vmap(compat_votes)``: the (B, R) chunks as one launch of B·R
    chunks, whose launch geometry may differ from R's; the counts are
    integers, so each lane equals its own launch exactly, and the plain
    version on that lane within the votes' tolerance."""
    rng = np.random.default_rng(B * K)
    src = rng.uniform(-20, 20, (B, R, K, 3)).astype(np.float32)
    tgt = src + 0.3 + np.where(rng.random((B, R, K, 1)) < 0.25,
                               rng.uniform(2, 8, (B, R, K, 3)), 0.0)
    valid = (rng.random((B, R, K)) < 0.9).astype(np.float32)
    args = [torch.as_tensor(a.astype(np.float32)).to(cuda)
            for a in (src, tgt, valid)]
    before = VOTE.launches
    v_b = torch.vmap(compat_votes)(*args)
    torch.cuda.synchronize()
    assert VOTE.launches == before + 1 and v_b.shape == (B, R, K)
    for b in range(B):
        lane = [a[b] for a in args]
        assert torch.equal(v_b[b], compat_votes(*lane))
        diff = (v_b[b] - compat_votes_plain(*lane)).abs()
        assert diff.max().item() <= 1.0
        assert (diff > 0).float().mean().item() < 0.01
    v_s = torch.vmap(compat_votes, in_dims=(0, None, None))(
        args[0], args[1][0], args[2][0])
    for b in range(B):
        assert torch.equal(v_s[b], compat_votes(args[0][b], args[1][0],
                                                args[2][0]))


@pytest.mark.cuda
def test_batched_graph_replay_matches_eager_body(cuda, deterministic_sums):
    """Three frames of B = 3 lanes through ``batched_frame_step`` (one
    capture, then one replay per frame, with no host read) and through the
    eager vmapped body on the same states; the same lanes in reverse order
    (a lane's result must not depend on its place or its neighbours); a
    chunk of the three frames through ``batched_chunk_step``.  A replay
    launches each kernel once per call site for all lanes, and the wrappers
    count no replay."""
    cfg = tpl.PROFILES["hdl64-small"]
    B = 3
    lanes = [list(tpl.synthetic_frames(3, cfg, 700, 0.6, seed))
             for seed in range(B)]
    xs = torch.as_tensor(np.stack([[f[1] for f in lane] for lane in lanes],
                                  1)).to(cuda)
    ms = torch.as_tensor(np.stack([[f[2] for f in lane] for lane in lanes],
                                  1)).to(cuda)
    graph = fused.frame_graph(cfg, cuda, lanes=B)
    per_replay = replay_launches(cfg)
    assert graph.kernel_launches == per_replay
    assert replay_kernel_counts(graph)[0] == per_replay

    _zero_launches()
    state_g = batch.init_batch_state(cfg, B, cuda)
    state_e = batch.init_batch_state(cfg, B, cuda)
    rows = []
    for x, m in zip(xs, ms):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state_g, out_g, mout_g = batch.batched_frame_step(
                state_g, x, m, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert not any(_launches().values())
        state_e, out_e, mout_e = batch._batched_body(state_e, x, m, cfg)
        for got, want in ((out_g.t_w, out_e.t_w), (out_g.q_w, out_e.q_w),
                          (mout_g.t_w, mout_e.t_w), (mout_g.q_w, mout_e.q_w),
                          (state_g.mapping.t_wm, state_e.mapping.t_wm)):
            assert got.shape[0] == B
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=0, atol=GRAPH_ATOL)
        assert (mout_e.map_surf_points > 0).all()
        assert torch.equal(mout_g.map_surf_points, mout_e.map_surf_points)
        rows.append(mout_g.t_w.cpu().numpy())
        _zero_launches()
    assert graph.replays == 3
    # the lanes saw different worlds
    assert np.abs(rows[-1][0] - rows[-1][1]).max() > 1e-3
    state_r = batch.init_batch_state(cfg, B, cuda)
    for k, (x, m) in enumerate(zip(xs, ms)):
        state_r, _, mout_r = batch.batched_frame_step(
            state_r, x.flip(0), m.flip(0), cfg)
        np.testing.assert_allclose(mout_r.t_w.flip(0).cpu().numpy(), rows[k],
                                   rtol=0, atol=GRAPH_ATOL)

    fused.frame_graph(cfg, cuda, chunk=3, lanes=B)
    _zero_launches()
    state_c, (oq, ot, mq, mt) = batch.batched_chunk_step(
        batch.init_batch_state(cfg, B, cuda), xs, ms, cfg)
    assert mt.shape == (3, B, 3) and oq.shape == (3, B, 4)
    np.testing.assert_allclose(mt.cpu().numpy(), np.stack(rows), rtol=0,
                               atol=GRAPH_ATOL)
    assert state_c.mapping.frame.tolist() == [3] * B
    assert not any(_launches().values())


# the windowed refinement (models/refine.py): the card against the CPU, in
# float64, at the 1e-4 of tests/test_refine.py:111-112
REFINE_TOL = 1e-4
REFINE_ARGS = dict(n_keyframes=4, n_landmarks=256, n_iterations=4)


def _refine_run(cuda, cfg, n_frames=6):
    run = dict(n_frames=n_frames, n_azimuth=700, speed=0.6, seed=2)
    pipe, res = _run_synthetic(cfg, run, "cuda")
    frames = list(tpl.synthetic_frames(n_frames + 1, cfg, 700, 0.6, 2))
    return pipe, frames[-1][1:]


@pytest.mark.cuda
def test_refine_on_card_matches_cpu(cuda):
    """The refinement's work on the card and on the CPU from the same map
    and keyframes, in float64: refined poses within 1e-4.  (In float32 the
    landmark fit is decided by rounding, so the two devices pick other
    landmarks: chip_smoke.py phase 14 reports that gap.)"""
    from chip_smoke import refine_float64

    pipe, _ = _refine_run(cuda, tpl.PROFILES["hdl64-small"])
    for K in (2, 4):
        window = pipe._window(K)
        card = refine_float64(pipe.map_state.surf, window, cuda)
        cpu = refine_float64(pipe.map_state.surf, window, "cpu")
        for a, b in zip(card, cpu):
            np.testing.assert_allclose(a, b, rtol=0, atol=REFINE_TOL)
        # and the float32 call runs on the card: finite, near its window
        q, t = pipe.refine_recent_keyframes(**dict(REFINE_ARGS,
                                                   n_keyframes=K))
        assert np.isfinite(q).all() and np.isfinite(t).all()
        assert np.abs(t - window[1].cpu().numpy()).max() < 1.0


@pytest.mark.cuda
def test_refine_bitwise_repeatable_under_deterministic_sums(
        cuda, deterministic_sums):
    pipe, _ = _refine_run(cuda, tpl.PROFILES["hdl64-small"], n_frames=5)
    a = pipe.refine_recent_keyframes(**REFINE_ARGS)
    b = pipe.refine_recent_keyframes(**REFINE_ARGS)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_fused_frame_after_refine_apply_uses_the_refined_pose(
        cuda, deterministic_sums):
    """After apply=True the next fused frame copies the re-anchored state
    into its graph's buffers: it equals a staged step from the same state
    (1e-5), not a replay of the graph's stale odom→map correction."""
    base = tpl.PROFILES["hdl64-small"]
    cfg = dataclasses.replace(base, fused_step=True)
    pipe, nxt = _refine_run(cuda, cfg, n_frames=5)
    before = pipe.map_state.t_wm.clone()
    kf = pipe._keyframes[-2]
    pipe._keyframes[-2] = (kf[0], kf[1] + np.float32(0.1), *kf[2:])
    pipe.refine_recent_keyframes(**REFINE_ARGS, apply=True)
    assert float((pipe.map_state.t_wm - before).abs().max()) > 1e-6
    staged = tpl.Pipeline(base, device="cuda")
    staged.odo_state = _to(_to(pipe.odo_state, "cpu"), cuda)
    staged.map_state = _to(_to(pipe.map_state, "cpu"), cuda)
    staged.frame = pipe.frame
    graph = fused.frame_graph(cfg, cuda)
    replays = graph.replays
    r_f = pipe.process_frame(*nxt)
    r_s = staged.process_frame(*nxt)
    assert graph.replays == replays + 1
    np.testing.assert_allclose(r_f.map_t, r_s.map_t, rtol=0, atol=GRAPH_ATOL)
    np.testing.assert_allclose(r_f.odom_t, r_s.odom_t, rtol=0,
                               atol=GRAPH_ATOL)


@pytest.mark.cuda
def test_refine_profiler_trace_records_kernels(cuda, tmp_path):
    pipe, _ = _refine_run(cuda, tpl.PROFILES["hdl64-small"], n_frames=3)
    with pipe.timers.profiler_trace(str(tmp_path)) as prof:
        pipe.refine_recent_keyframes(**REFINE_ARGS)
    assert list(tmp_path.glob("*.pt.trace.json"))
    assert any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def _shard_cfg():
    """tests/test_sharded.py's mapping capacities."""
    from light_loam_tpu_torch.config import MappingConfig

    return MappingConfig(
        map_corner_capacity=8192, map_surf_capacity=16384,
        local_corner_capacity=8192, local_surf_capacity=16384,
        stack_corner_capacity=512, stack_surf_capacity=2048, knn_tile=1024)


def _shard_frames(cfg, device, n_frames=4):
    """tests/test_sharded.py's clouds of ``n_frames`` frames, each with the
    single-device state before it: [(state, corner, surf, q, t)]."""
    world = World.urban(seed=11)
    rng = np.random.default_rng(0)
    single = MappingState.init(cfg, device)
    frames = []
    for k in range(n_frames):
        pts = simulate_scan(world, np.array([0.5 * k, 0.0, 0.0]),
                            n_azimuth=500, noise=0.005, seed=30 + k)
        idx = rng.permutation(len(pts))

        def cloud(p, cap):
            xyz = torch.zeros((cap, 3))
            xyz[:len(p)] = torch.from_numpy(p)
            return PointCloud(xyz.to(device), torch.zeros(cap, device=device),
                              (torch.arange(cap) < len(p)).to(device))

        c, s = cloud(pts[idx[:400]], 512), cloud(pts[idx[400:2400]], 2048)
        q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
        t = torch.tensor([0.5 * k + 0.05, 0.05, 0.05], device=device)
        frames.append((single, c, s, q, t))
        single, _ = mapping_step(single, c, s, q, t, cfg)
    return frames


@pytest.fixture
def nccl_world_one(cuda, tmp_path):
    """This process as world 1 of an NCCL group on the card; its captured
    sharded steps go before the group does."""
    import torch.distributed as dist
    from light_loam_tpu_torch.parallel import sharded

    group = sharded.make_group(1, 0, "nccl", f"file://{tmp_path}/rdzv",
                               device=cuda)
    try:
        yield group
    finally:
        sharded.clear_graphs()
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_step_world_one_over_nccl(cuda, nccl_world_one):
    """``sharded_mapping_step`` at world 1 over NCCL on the card, one step
    from each of 4 successive single-device states (tests/test_sharded.py's
    capacities and clouds): within the JAX test's one-step bounds of
    ``mapping_step`` from the same state, every step one replay of the
    captured step, every 5-NN and every sum through the kernels."""
    from light_loam_tpu_torch.parallel import sharded
    from light_loam_tpu_torch.parallel.sharded import (
        shard_mapping_state,
        sharded_mapping_step,
    )

    cfg, group = _shard_cfg(), nccl_world_one
    assert group.captures
    frames = _shard_frames(cfg, cuda)
    KNN5.launches = 0
    for single, c, s, q, t in frames:
        state = shard_mapping_state(single, group, cfg)
        _, out_s = mapping_step(single, c, s, q, t, cfg)
        _, out_m = sharded_mapping_step(state, c, s, q, t, cfg, group)
        assert float((out_m.t_w - out_s.t_w).norm()) < 2e-2
        sf, sf_ref = int(out_m.surf_factors), int(out_s.surf_factors)
        assert abs(sf - sf_ref) <= max(5, 0.03 * sf_ref)
        mp, mp_ref = int(out_m.map_surf_points), int(out_s.map_surf_points)
        assert abs(mp - mp_ref) <= max(10, 0.02 * mp_ref)
    assert sf > 100
    (graph,) = sharded._GRAPHS.values()
    per_replay = 2 * cfg.outer_iterations
    assert graph.replays == 4
    # segment sums: the two owned-stack downsamples and two store re-sorts
    assert graph.kernel_launches == {"knn.cu": per_replay, "vote.cu": 0,
                                     "segsum.cu": 4, "lm.cu": 0}
    # the wrappers counted the warm-up and the capture pass and no replay;
    # the single-device steps launched their own
    assert KNN5.launches == (fused.WARMUP_PASSES + 1 + 4) * per_replay


@pytest.mark.cuda
@pytest.mark.parametrize("vote", [False, True])
def test_captured_sharded_step_equals_eager_body(cuda, nccl_world_one,
                                                 deterministic_sums, vote):
    """Under deterministic sums the captured step (one replay a step) is
    bitwise the eager body from the same resharded state, state and
    outputs; the capture counted 4 knn5 launches (2 with the vote's
    compat_votes), no collective at world 1 and no host read."""
    from light_loam_tpu_torch.parallel import sharded
    from light_loam_tpu_torch.parallel.sharded import (
        _sharded_step_body,
        shard_mapping_state,
        sharded_mapping_step,
    )

    cfg, group = _shard_cfg(), nccl_world_one
    if vote:
        cfg = dataclasses.replace(cfg, vote_mode="simple", vote_start_frame=1)
    for k, (single, c, s, q, t) in enumerate(_shard_frames(cfg, cuda)):
        state = shard_mapping_state(single, group, cfg)
        if k:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = sharded_mapping_step(state, c, s, q, t, cfg, group)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = _sharded_step_body(state, c, s, q, t, cfg, group)
        for a, b in zip(fused._leaves(got), fused._leaves(want)):
            assert torch.equal(a, b)
    assert int(want[1].surf_factors) > 100
    (graph,) = sharded._GRAPHS.values()
    assert graph.replays == 4 and graph.collectives == 0
    assert graph.kernel_launches == {
        "knn.cu": 2 * cfg.outer_iterations,
        "vote.cu": cfg.outer_iterations if vote else 0, "segsum.cu": 4,
        "lm.cu": 0}


@pytest.mark.cuda
def test_nccl_capture_probe_world_one(cuda, nccl_world_one):
    """A bare all-gather and all-reduce of the sharded step's sizes on the
    world-1 NCCL group, past ``ShardGroup``'s size-1 shortcuts, captured
    and replayed 10 times (chip_smoke.py phase 15 runs the same probe at
    the flagship sizes)."""
    from chip_smoke import nccl_capture_probe

    probe = nccl_capture_probe(nccl_world_one, _shard_cfg())
    assert probe["replays"] == 10 and probe["wrong"] == 0
    assert probe["rows"] == 512 + 2048 + 8192 + 16384


@pytest.mark.cuda
def test_runs_mode_fused_frame_captures(cuda):
    """``lessflat_mode="runs"`` in the fused frame: the capture holds it,
    and the positions are the staged runs-mode frames' (DEFAULT_ATOL_M:
    bitwise with the ordered sums)."""
    base = tpl.PROFILES["hdl64-small"]
    cfg = dataclasses.replace(
        base, scan=dataclasses.replace(base.scan, lessflat_mode="runs"))
    fcfg = dataclasses.replace(cfg, fused_step=True)
    fused.clear_graphs()
    run = dict(n_frames=4, n_azimuth=700, speed=0.6, seed=2)
    try:
        graph = fused.frame_graph(fcfg, cuda)
        pipe, res = _run_synthetic(fcfg, run, "cuda")
        staged, _ = _run_synthetic(cfg, run, "cuda")
        assert graph.replays == run["n_frames"] and all(r.mapped for r in res)
        np.testing.assert_allclose(pipe.mapped_positions(),
                                   staged.mapped_positions(), rtol=0,
                                   atol=DEFAULT_ATOL_M)
        assert np.abs(pipe.mapped_positions()[-1]).max() > 1.0
    finally:
        fused.clear_graphs()


def segsum_inputs(N, C, S, seed, dtype=torch.float32, device="cpu"):
    """(values (N, C), seg (N,)) like a voxel sum's: runs of 1-8 rows in
    sorted slots (some slots empty, some runs merged), one run of 2000
    rows, the slots past S - 1 clipped to S (over capacity), and the last
    third of the rows dead, in the dump slot S."""
    rng = np.random.default_rng(seed)
    live = (2 * N) // 3
    lengths = rng.integers(1, 9, max(1, live // 5))
    lengths[len(lengths) // 2] = 2000
    slots = np.minimum(np.sort(rng.integers(0, S + S // 4 + 1,
                                            len(lengths))), S)
    seg = np.repeat(slots, lengths)[:live]
    seg = np.concatenate([seg, np.full(N - len(seg), S)])
    values = rng.normal(0.0, 50.0, (N, C))
    return (torch.as_tensor(values, dtype=dtype).to(device),
            torch.as_tensor(seg, dtype=torch.int64).to(device))


# (N, C, S) of the main path (chip_smoke.py phase 3c): the less-flat
# rings, the surf store's full re-sort, the surf stack, the surf store's
# reduce, the refinement's landmark and pose-landmark blocks
SEGSUM_SHAPES = [(115200, 5, 115200), (270336, 5, 262144),
                 (32768, 5, 8192), (8192, 4, 8192), (32768, 12, 512),
                 (32768, 18, 8192)]


def segsum_edge_case(case, device):
    """(values, seg, S) of one edge of segsum.cu's tiles (64-512 rows,
    ``segsum_geometry``): no rows; rows all in the dump slot; one slot; a
    segment over three tiles or more; the last live row a tile's last row;
    262144 slots ~6 % live (long empty runs, a long empty tail); float64
    rows 18 wide (144 bytes, the refinement's blocks); float64 rows 600
    wide (4 rows a tile); values a view 20 bytes past a 16-byte
    boundary."""
    rng = np.random.default_rng(len(case))
    dtype = torch.float32
    if case == "no rows":
        S, seg = 300, np.zeros(0, np.int64)
    elif case == "dump rows only":
        S, seg = 77, np.full(900, 77)
    elif case == "one slot":
        S, seg = 1, np.r_[np.zeros(500, np.int64), np.ones(200, np.int64)]
    elif case == "segment over three tiles":
        S, seg = 400, np.r_[np.arange(100), np.full(600, 100),
                            np.arange(101, 300), np.full(50, 400)]
    elif case == "last live row at a tile end":
        S, seg = 400, np.r_[np.sort(rng.integers(0, 200, 512)),
                            np.full(300, 400)]
    elif case == "262144 slots 6% live":
        S = 262144
        live = np.sort(rng.choice(S, S * 6 // 100, replace=False))
        seg = np.r_[np.repeat(live, rng.integers(1, 3, live.size)),
                    np.full(8192, S)]
    elif case in ("float64 18 wide", "float64 600 wide"):
        C = 18 if case == "float64 18 wide" else 600
        values, seg = segsum_inputs(3000, C, 700, 7, torch.float64, device)
        return values, seg, 700
    else:  # "unaligned view"
        values, seg = segsum_inputs(32768, 5, 8192, 8, device=device)
        padded = torch.cat([values.new_zeros(1, 5), values])
        assert padded[1:].data_ptr() % 16 == 4
        return padded[1:], seg, 8192
    C = 4 if case == "one slot" else 5
    values = rng.normal(0.0, 50.0, (len(seg), C))
    return (torch.as_tensor(values, dtype=dtype).to(device),
            torch.as_tensor(seg, dtype=torch.int64).to(device), S)


SEGSUM_EDGES = ["no rows", "dump rows only", "one slot",
                "segment over three tiles", "last live row at a tile end",
                "262144 slots 6% live", "float64 18 wide", "float64 600 wide",
                "unaligned view"]
SEGSUM_CASES = (
    [pytest.param(("shape", N, C, S, dtype),
                  id=f"{N}-{C}-{S}-{str(dtype)[6:]}")
     for N, C, S in SEGSUM_SHAPES for dtype in (torch.float32, torch.float64)]
    + [pytest.param(("edge", case), id=case.replace(" ", "-"))
       for case in SEGSUM_EDGES])


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEGSUM_CASES)
def test_segment_sum_kernel_equals_plain(cuda, case):
    """The kernel bit for bit the plain version on CPU copies of its
    inputs (a left fold in row order, the kernel's order), and the same
    bits on a second launch; one launch counted per call.  The main path's
    shapes, then the edges of the kernel's tiles (``segsum_edge_case``)."""
    if case[0] == "shape":
        _, N, C, S, dtype = case
        values, seg = segsum_inputs(N, C, S, N + C, dtype, cuda)
    else:
        values, seg, S = segsum_edge_case(case[1], cuda)
    before = SEGSUM.launches
    got = segment_sum(values, seg, S)
    again = segment_sum(values, seg, S)
    torch.cuda.synchronize()
    assert SEGSUM.launches == before + 2
    assert got.shape == (S, values.shape[1]) and got.dtype == values.dtype
    want = segment_sum_plain(values.cpu(), seg.cpu(), S)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,S", [SEGSUM_SHAPES[0], SEGSUM_SHAPES[1],
                                   SEGSUM_SHAPES[4]])
def test_segment_sum_lanes_equal_single_launches(cuda, N, C, S):
    """B = 4 lanes under ``torch.vmap``, one launch: each lane bit for bit
    its single launch and its plain version."""
    B = 4
    lanes = [segsum_inputs(N, C, S, b, device=cuda) for b in range(B)]
    values = torch.stack([v for v, _ in lanes])
    seg = torch.stack([s for _, s in lanes])
    before = SEGSUM.launches
    got = torch.vmap(segment_sum, in_dims=(0, 0, None))(values, seg, S)
    torch.cuda.synchronize()
    assert SEGSUM.launches == before + 1 and got.shape == (B, S, C)
    for b in range(B):
        assert torch.equal(got[b], segment_sum(values[b], seg[b], S))
        np.testing.assert_array_equal(
            got[b].cpu().numpy(),
            segment_sum_plain(values[b].cpu(), seg[b].cpu(), S).numpy())


@pytest.mark.cuda
def test_segment_sum_refuses_bad_inputs(cuda):
    values, seg = segsum_inputs(1000, 5, 100, 0, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        segment_sum(values.half(), seg, 100)
    with pytest.raises(ValueError, match="dtype"):
        segment_sum(values, seg.int(), 100)
    with pytest.raises(ValueError, match="do not match"):
        segment_sum(values, seg[:-1], 100)


@pytest.mark.cuda
def test_one_writer_merge_is_repeatable(cuda):
    """``merge_sorted``'s two float ``index_add``s (ops/sorted_store.py)
    write at most one row into each live target, so on the card they add
    to 0 once and are exact in any order: the merge, run three times, is
    bitwise the same, and bitwise the CPU's."""
    from light_loam_tpu_torch.ops.sorted_store import merge_sorted
    from light_loam_tpu_torch.ops.voxel import voxel_downsample

    rng = np.random.default_rng(4)
    leaf = 0.4

    def cloud(n, live):
        xyz = torch.as_tensor(rng.uniform(-40, 40, (n, 3)), dtype=torch.float32)
        return xyz, torch.as_tensor(rng.random(n) < live)

    xyz, mask = cloud(60000, 0.7)
    cell = torch.as_tensor(rng.integers(0, 50, 60000), dtype=torch.int32)
    store_xyz, _, store_mask, store_cell = voxel_downsample(
        xyz, torch.zeros(60000), mask, leaf, 65536, extra_key=cell)
    new_xyz, new_mask = cloud(8192, 0.9)
    # half the new points fall into voxels the store holds
    new_xyz[:4096] = store_xyz[:4096] + 0.01
    new_cell = store_cell[:8192].clone()
    args = (store_xyz, store_cell, store_mask, new_xyz, new_cell, new_mask)
    want = merge_sorted(*args, leaf)
    runs = [merge_sorted(*(a.to(cuda) for a in args), leaf) for _ in range(3)]
    for run in runs:
        for got, ref in zip(run, want):
            assert torch.equal(got.cpu(), ref)
    assert int(want[2].sum()) > int(store_mask.sum())


@pytest.mark.cuda
def test_default_settings_runs_are_bitwise_equal(cuda):
    """Two staged runs and two fused runs of 3 hdl64-small frames with
    PyTorch's default settings, as the entry points run: the four
    trajectories bitwise equal (the sums are ordered)."""
    base = tpl.PROFILES["hdl64-small"]
    fused.clear_graphs()
    run = dict(n_frames=3, n_azimuth=700, speed=0.6, seed=2)
    try:
        paths = []
        for cfg in (base, base, dataclasses.replace(base, fused_step=True),
                    dataclasses.replace(base, fused_step=True)):
            pipe, res = _run_synthetic(cfg, run, "cuda")
            paths.append((pipe.mapped_positions(),
                          np.stack([r.odom_t for r in res])))
    finally:
        fused.clear_graphs()
    for mapped, odom in paths[1:]:
        np.testing.assert_array_equal(mapped, paths[0][0])
        np.testing.assert_array_equal(odom, paths[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("surf_knn", ["auto", "tiled"])
def test_graph_replay_matches_eager_body_default_settings(cuda, tmp_path,
                                                          surf_knn):
    """``test_graph_replay_matches_eager_body`` with PyTorch's default
    settings: three frames through ``fused_frame_step`` (one capture, then
    one replay per frame, no host read) and through the eager body on the
    same states, bitwise equal.  On a failure both runs' poses go to an
    .npz under ``tmp_path``, named in the message."""
    base = tpl.PROFILES["hdl64-small"]
    cfg = dataclasses.replace(
        base, odometry=dataclasses.replace(base.odometry, surf_knn=surf_knn))
    fused.clear_graphs()
    frames = _small_frames(cfg, 3, cuda)
    odo_g, map_g = _init_states(cfg, cuda)
    odo_e, map_e = _init_states(cfg, cuda)
    poses = {"graph": [], "eager": []}
    try:
        graph = fused.frame_graph(cfg, cuda)
        for xyz, mask in frames:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                odo_g, map_g, out_g, mout_g, _ = fused.fused_frame_step(
                    odo_g, map_g, xyz, mask, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            odo_e, map_e, out_e, mout_e, _ = fused._fused_frame_body(
                odo_e, map_e, xyz, mask, cfg)
            for name, out, mout, mp in (("graph", out_g, mout_g, map_g),
                                        ("eager", out_e, mout_e, map_e)):
                poses[name].append(torch.cat([
                    out.q_w, out.t_w, mout.q_w, mout.t_w, mp.t_wm]).cpu())
        assert graph.replays == 3 and fused.frame_graph(cfg, cuda) is graph
    finally:
        fused.clear_graphs()
    got, want = (torch.stack(poses[n]).numpy() for n in ("graph", "eager"))
    if not np.array_equal(got, want):
        path = tmp_path / "graph_vs_eager_poses.npz"
        np.savez(path, graph=got, eager=want)
        raise AssertionError(
            f"graph and eager body differ by {np.abs(got - want).max():.3e} "
            f"(rows: frames; columns: odometry q, t, mapping q, t, t_wm); "
            f"both runs' poses are in {path}")


@pytest.mark.cuda
@pytest.mark.parametrize("settings", ["default", "deterministic"])
def test_stage_replays_match_eager_bodies(cuda, request, settings):
    """Three hdl64-small frames: each stage's replay (models/stages.py)
    against its body run eagerly on the same inputs, from the eager run's
    carried states, bitwise, with PyTorch's default settings and under
    deterministic sums; the three replays of a frame read nothing to the
    host."""
    if settings == "deterministic":
        request.getfixturevalue("deterministic_sums")
    else:
        fused.clear_graphs()
    cfg = tpl.PROFILES["hdl64-small"]
    frames = _small_frames(cfg, 3, cuda)
    odo, mp = _init_states(cfg, cuda)
    try:
        graphs = stages.stage_graphs(cfg, cuda)
        for xyz, mask in frames:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                feats = graphs[0].run(xyz, mask)
                odo_g = graphs[1].run(odo, feats)
                map_g = graphs[2].run(mp, odo_g[0].corner_last,
                                      odo_g[0].surf_last, odo_g[1].q_w,
                                      odo_g[1].t_w)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            feats_e = stages._features_body(xyz, mask, cfg)
            odo_e = stages._odometry_body(odo, feats_e, cfg)
            map_e = stages._mapping_body(mp, odo_e[0].corner_last,
                                         odo_e[0].surf_last, odo_e[1].q_w,
                                         odo_e[1].t_w, cfg)
            for got, want in ((feats, feats_e), (odo_g, odo_e),
                              (map_g, map_e)):
                for a, b in zip(fused._leaves(got), fused._leaves(want)):
                    assert torch.equal(a, b)
            odo, mp = odo_e[0], map_e[0]
        assert int(mp.surf.mask.sum()) > 0
        assert [g.replays for g in graphs] == [3, 3, 3]
        assert all(g.graph is not None for g in graphs)
    finally:
        fused.clear_graphs()


def _busy_but_every_third_frame(pipe) -> bool:
    """A mapping step in flight stays busy but on every third frame."""
    return pipe._pending_map_out is not None and pipe.frame % 3 != 0


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["default", "async_drop", "skip_two"])
def test_staged_pipeline_captured_equals_eager(cuda, monkeypatch, regime):
    """Six hdl64-small frames through the staged Pipeline, its stages
    replayed, against the same frames op by op (``stages.eager()``),
    bitwise: the default, ``sync_mapping=False`` with drops (mapping held
    busy but on every third frame) and ``skip_frame_num=2``.  The replays
    launch what the config says; the wrappers count the keyframe stacks
    alone."""
    base = tpl.PROFILES["hdl64-small"]
    cfg = {"default": base,
           "async_drop": dataclasses.replace(base, sync_mapping=False),
           "skip_two": dataclasses.replace(base, odometry=dataclasses.replace(
               base.odometry, skip_frame_num=2))}[regime]
    if regime == "async_drop":
        monkeypatch.setattr(tpl.Pipeline, "_mapping_busy",
                            _busy_but_every_third_frame)
    run = dict(n_frames=6, n_azimuth=700, speed=0.6, seed=2)
    fused.clear_graphs()
    try:
        graphs = stages.stage_graphs(cfg, cuda)
        replays = [g.replays for g in graphs]
        _zero_launches()
        pipe, res = _run_synthetic(cfg, run, "cuda")
        n_mapped = sum(r.mapped for r in res)
        assert _launches() == keyframe_launches(n_mapped)
        assert graph_launches_since(graphs, replays) == expected_launches(
            cfg, len(res), n_mapped, keyframes=0)
        with stages.eager():
            eager, eager_res = _run_synthetic(cfg, run, "cuda")
    finally:
        fused.clear_graphs()
    if regime != "default":
        assert 0 < n_mapped < len(res)
    assert pipe.dropped_mapping_frames == eager.dropped_mapping_frames
    assert [r.mapped for r in res] == [r.mapped for r in eager_res]
    for r, e in zip(res, eager_res):
        np.testing.assert_array_equal(r.odom_t, e.odom_t)
        np.testing.assert_array_equal(r.odom_q, e.odom_q)
        if r.mapped:
            np.testing.assert_array_equal(r.map_t, e.map_t)
    np.testing.assert_array_equal(pipe.mapped_positions(),
                                  eager.mapped_positions())


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAILED_STAGE_CAPTURE = textwrap.dedent("""
    import json
    from light_loam_tpu_torch.models import pipeline as tpl
    from light_loam_tpu_torch.models import stages

    cfg = tpl.PROFILES["hdl64-small"]
    real_step = stages.odometry_step
    calls = []

    def reads_to_host(state, feats, ocfg, period, **kwargs):
        calls.append(float(state.t_w.sum()))
        return real_step(state, feats, ocfg, period, **kwargs)

    stages.odometry_step = reads_to_host
    pipe = tpl.Pipeline(cfg, device="cuda")
    _, xyz, mask = next(iter(tpl.synthetic_frames(1, cfg, 700, 0.6, 2)))
    try:
        pipe.process_frame(xyz, mask)
        raised = None
    except RuntimeError as exc:
        raised = str(exc)[:300]
    print("RESULT " + json.dumps(dict(
        raised=raised, calls=len(calls), frame=pipe.frame,
        cached=sorted(key[0] for key in stages._GRAPHS),
        device=str(pipe.odo_state.q_w.device))))
""")


# the odometry's LM solve (csrc/lm.cu) against the plain loop on the card,
# on every solve of ring-road sweeps at the benchmark cell's shapes (768
# edge and 1536 plane factors, 8 iterations a call), the vote gate closed
# (sweeps 0-5) and open (6-7); chip_smoke.py phase 4b makes the same run
@pytest.fixture(scope="module")
def lm_calls():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the "
                    "kernels")
    cfg = tpl.PROFILES["hdl64"]
    return cfg, record_lm_calls(cfg, ring_frames(LM_FRAMES, cfg),
                                torch.device("cuda", 0))


def _lm_both(q0, t0, fs, kw):
    """(kernel, plain loop) of one solve; the kernel launched once."""
    before = LM.launches
    got = lm_solve(q0, t0, fs, **kw)
    assert LM.launches == before + 1
    return got, _lm_loop(q0, t0, fs, **kw)


@pytest.mark.cuda
def test_lm_kernel_matches_plain_loop_on_ring_sweeps(lm_calls):
    """Every solve of the sweeps: q within 1e-5 and t within 1e-4 m of the
    plain loop on the same card (tests/test_torch_odometry.py's bounds),
    the cost within 1e-5 relative; both gate states seen, the open one
    with vote weights and vote masks."""
    cfg, calls = lm_calls
    gate = cfg.odometry.vote_start_frame
    assert len(calls) == LM_FRAMES * cfg.odometry.outer_iterations
    assert {c[0] > gate for c in calls} == {False, True}
    for frame, q0, t0, fs, kw in calls:
        assert fs.edge.cp.shape[0] == 768 and fs.plane.cp.shape[0] == 1536
        assert uses_lm_kernel(q0.device, q0.dtype, fs, _identity)
        if frame > gate:
            assert not torch.all(fs.plane.weight[fs.plane.mask] == 1.0)
        got, want = _lm_both(q0, t0, fs, kw)
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), rtol=0,
                                   atol=LM_Q_TOL)
        np.testing.assert_allclose(got[1].cpu().numpy(),
                                   want[1].cpu().numpy(), rtol=0,
                                   atol=LM_T_TOL_M)
        np.testing.assert_allclose(got[2].item(), want[2].item(), rtol=1e-5,
                                   atol=1e-6)


def _lm_open_gate_call(calls):
    _, q0, t0, fs, kw = calls[-1]
    return q0, t0, fs, kw


@pytest.mark.cuda
def test_lm_kernel_all_factors_masked(lm_calls):
    """No active factor: the pose comes back unchanged and the cost is 0,
    as from the plain loop."""
    q0, t0, fs, kw = _lm_open_gate_call(lm_calls[1])
    fs = FactorSet(edge=fs.edge._replace(mask=torch.zeros_like(fs.edge.mask)),
                   plane=fs.plane._replace(
                       mask=torch.zeros_like(fs.plane.mask)))
    for q, t, cost in _lm_both(q0, t0, fs, kw):
        assert torch.equal(q, q0) and torch.equal(t, t0)
        assert cost.item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["zero", "indefinite"])
def test_lm_kernel_singular_system_takes_no_step(lm_calls, system):
    """A system the solve cannot use gives a zero step, which the cost does
    not accept (lambda then grows x4, inside the kernel as in the plain
    loop): every factor at weight 0 (H = 0, g = 0, the damping alone on
    the diagonal), or lambda_init = -1 (the damped diagonal cancels, the
    Cholesky meets a non-positive pivot).  The pose comes back unchanged
    and the cost is the starting cost, as from the plain loop."""
    q0, t0, fs, kw = _lm_open_gate_call(lm_calls[1])
    if system == "zero":
        fs = FactorSet(
            edge=fs.edge._replace(weight=torch.zeros_like(fs.edge.weight)),
            plane=fs.plane._replace(weight=torch.zeros_like(fs.plane.weight)))
    else:
        kw = dict(kw, lambda_init=-1.0)
    (q, t, cost), (qp, tp, cp) = _lm_both(q0, t0, fs, kw)
    assert torch.equal(q, q0) and torch.equal(t, t0)
    assert torch.equal(qp, q0) and torch.equal(tp, t0)
    np.testing.assert_allclose(cost.item(), cp.item(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_lm_kernel_non_finite_input_takes_no_step(lm_calls):
    """One active plane factor at NaN: H is not finite, the Cholesky fails,
    every step is zero; the pose comes back unchanged and the cost NaN, as
    from the plain loop."""
    q0, t0, fs, kw = _lm_open_gate_call(lm_calls[1])
    cp = fs.plane.cp.clone()
    cp[int(torch.nonzero(fs.plane.mask)[0, 0]), 0] = float("nan")
    fs = FactorSet(edge=fs.edge, plane=fs.plane._replace(cp=cp))
    for q, t, cost in _lm_both(q0, t0, fs, kw):
        assert torch.equal(q, q0) and torch.equal(t, t0)
        assert math.isnan(cost.item())


@pytest.mark.cuda
def test_lm_kernel_lanes_are_one_launch(lm_calls):
    """The last 4 solves as lanes under ``torch.vmap``: one launch, each
    lane bit for bit its own single launch."""
    calls = [c[1:] for c in lm_calls[1][-4:]]
    kw = calls[0][3]
    stacked = [torch.stack(x) for x in zip(*(
        (q, t, *fs.edge, *fs.plane) for q, t, fs, _ in calls))]

    def body(q, t, *f):
        return lm_solve(q, t, FactorSet(edge=EdgeFactors(*f[:6]),
                                        plane=PlaneFactors(*f[6:])), **kw)

    before = LM.launches
    lanes = torch.vmap(body)(*stacked)
    assert LM.launches == before + 1
    for b, (q0, t0, fs, kwb) in enumerate(calls):
        single = lm_solve(q0, t0, fs, **kwb)
        for x, y in zip(lanes, single):
            assert torch.equal(x[b], y)


@pytest.mark.cuda
def test_lm_kernel_repeats_bit_for_bit(lm_calls):
    """Two runs of each open-gate solve on one card are equal bit for
    bit: the block sums add in a fixed order."""
    cfg, calls = lm_calls
    for _, q0, t0, fs, kw in calls[-cfg.odometry.outer_iterations:]:
        a, b = lm_solve(q0, t0, fs, **kw), lm_solve(q0, t0, fs, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_lm_kernel_factors_past_shared_memory(cuda):
    """Factors too many for shared memory go through the scratch buffer
    (a 4x wider sensor's capacities), with sweep fractions below 1 (the
    slerp of the distortion hook): the same solve as the plain loop, and
    the cost falls."""
    rng = np.random.default_rng(7)
    Ne, Np = 4 * 768, 4 * 1536
    assert staged_bytes(Ne, Np) == 0
    q_true = torch.tensor([0.01, -0.02, 0.03, 1.0])
    q_true = q_true / q_true.norm()
    t_true = torch.tensor([0.3, -0.1, 0.05])

    def world(cp):
        from light_loam_tpu_torch.core.quaternion import quat_rotate
        return quat_rotate(q_true[None], cp) + t_true

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    ecp = f32(rng.uniform(-30, 30, (Ne, 3)))
    d = f32(rng.normal(size=(Ne, 3)))
    pw = world(ecp) + f32(rng.normal(scale=0.01, size=(Ne, 3)))
    edge = EdgeFactors(ecp, pw + d, pw - d, f32(rng.uniform(0.5, 1, Ne)),
                       torch.ones(Ne), torch.as_tensor(rng.random(Ne) < 0.8))
    pcp = f32(rng.uniform(-30, 30, (Np, 3)))
    n = f32(rng.normal(size=(Np, 3)))
    n = n / n.norm(dim=1, keepdim=True)
    plane = PlaneFactors(pcp, world(pcp) + f32(rng.normal(scale=0.01,
                                                         size=(Np, 3))),
                         n, f32(rng.uniform(0.5, 1, Np)),
                         f32(rng.uniform(0.5, 2, Np)),
                         torch.as_tensor(rng.random(Np) < 0.8))
    fs = FactorSet(edge=EdgeFactors(*(x.to(cuda) for x in edge)),
                   plane=PlaneFactors(*(x.to(cuda) for x in plane)))
    q0 = torch.tensor([0.0, 0.0, 0.0, 1.0], device=cuda)
    t0 = torch.zeros(3, device=cuda)
    kw = dict(n_iterations=8, huber_delta=0.1)
    got, want = _lm_both(q0, t0, fs, kw)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=0, atol=LM_Q_TOL)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=0, atol=LM_T_TOL_M)
    start = _lm_loop(q0, t0, fs, n_iterations=0, huber_delta=0.1)[2]
    assert got[2].item() < 0.5 * start.item()


@pytest.mark.cuda
def test_odometry_stage_graph_launches_the_lm_kernel(cuda):
    """The flagship stages captured: the odometry graph launches the LM
    kernel once per outer iteration (6 a replay), the mapping graph (edge
    and plane-norm factors) and the features graph never."""
    cfg = tpl.PROFILES["hdl64"]
    graphs = dict(zip(stages.STAGES, stages.stage_graphs(cfg, cuda)))
    assert graphs["odometry"].kernel_launches["lm.cu"] == \
        cfg.odometry.outer_iterations == 6
    assert graphs["mapping"].kernel_launches["lm.cu"] == 0
    assert graphs["features"].kernel_launches["lm.cu"] == 0


# the feature picks (csrc/features.cu) against the plain picks, on every
# case of chip_smoke.feature_grids; chip_smoke.py phase 4c makes the same run
@pytest.fixture(scope="module")
def feature_cases():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and launch the "
                    "kernels")
    return feature_grids()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hdl64_sweep", "vlp16_sweep", "ties",
                                  "occluded", "short_rings", "dense",
                                  "empty"])
def test_feature_picks_kernel_equals_plain(feature_cases, case):
    """One launch gives the labels and order keys of the plain picks on
    the CPU bit for bit: ring-road sweeps of the HDL-64E and the VLP-16,
    the HDL-64E's with the occlusion filter, exact curvature ties, rings
    of fewer than 17, 17 and h_max points, dense short sectors, an empty
    scan."""
    grid, scan, pre = feature_cases[case]
    dev = torch.device("cuda", 0)
    before = FEATURES.launches
    label, okey = pick_features(_to(grid, dev), scan,
                                None if pre is None else pre.to(dev))
    assert FEATURES.launches == before + 1
    want_label, want_okey = plain_picks(grid, scan, pre)
    assert torch.equal(label.cpu(), want_label)
    assert torch.equal(okey.cpu(), want_okey)


@pytest.mark.cuda
def test_feature_stage_with_the_kernel_equals_the_plain_stage(cuda):
    """``extract_features`` on the card, with the kernel (one launch a
    call) and with the plain picks in its place: every tensor of the
    ScanFeatures bit for bit, on HDL-64E sweeps (one with the occlusion
    filter) and VLP-16 sweeps."""
    for scan, xyz, mask in stage_frames():
        xyz, mask = torch.as_tensor(xyz).to(cuda), torch.as_tensor(mask).to(
            cuda)
        before = FEATURES.launches
        got = extract_features(xyz, mask, scan)
        assert FEATURES.launches == before + 1
        with plain_feature_stage():
            want = extract_features(xyz, mask, scan)
        assert FEATURES.launches == before + 1
        assert int(got.sharp.mask.sum()) > 0 and int(got.flat.mask.sum()) > 0
        for a, b in zip(stages._leaves(got), stages._leaves(want)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_feature_picks_lanes_equal_single_launches(feature_cases):
    """Four range images of 64 rings as lanes under ``torch.vmap``: one
    launch, each lane bit for bit its own single launch."""
    dev = torch.device("cuda", 0)
    scan = feature_cases["hdl64_sweep"][1]
    grids = [_to(pad_rings(feature_cases[c][0], 64), dev)
             for c in FEATURE_LANE_CASES]
    stacked = [torch.stack(x) for x in zip(*((g.xyz, g.mask, g.counts)
                                             for g in grids))]
    before = FEATURES.launches
    label, okey = torch.vmap(lambda x, m, c: pick_features(
        RangeImage(x, None, m, c), scan))(*stacked)
    assert FEATURES.launches == before + 1
    for b, g in enumerate(grids):
        single = pick_features(g, scan)
        assert torch.equal(label[b], single[0])
        assert torch.equal(okey[b], single[1])


def _traced_grids(replay, tmp_path, kernel: str) -> list:
    """The launch grids of ``kernel`` in a profiled ``replay()``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e["args"]["grid"] for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "kernel" and kernel in e["name"]]


@pytest.mark.cuda
def test_feature_graphs_launch_the_picks_kernel(cuda, tmp_path):
    """The flagship stages captured: the features graph launches the picks
    kernel once a replay (``kernel_launches["features.cu"]``), with one
    block a ring, the odometry and mapping graphs never; the batched frame
    of B = 3 lanes once, with B R blocks."""
    cfg = tpl.PROFILES["hdl64"]
    R = cfg.scan.n_scans
    graphs = dict(zip(stages.STAGES, stages.stage_graphs(cfg, cuda)))
    assert [graphs[s].kernel_launches["features.cu"]
            for s in stages.STAGES] == [1, 0, 0]
    feats = graphs["features"]
    assert _traced_grids(lambda: feats.marks.replay(feats.graph, "features"),
                         tmp_path, "feature_picks_kernel") == [[R, 1, 1]]

    small, B = tpl.PROFILES["hdl64-small"], 3
    lanes = fused.frame_graph(small, cuda, lanes=B)
    assert lanes.kernel_launches["features.cu"] == 1
    lanes.index.zero_()
    try:
        grids = _traced_grids(
            lambda: lanes.marks.replay(lanes.graph, lanes.name), tmp_path,
            "feature_picks_kernel")
    finally:
        lanes.index.zero_()
    assert grids == [[B * small.scan.n_scans, 1, 1]]


@pytest.mark.cuda
def test_feature_picks_refuses_bad_inputs(cuda):
    """A wrong dtype, shape or device or a strided tensor raises before any
    launch; a suppression radius over the kernel's 32, rings too wide for
    a block's shared memory or no sector are refused by the launcher
    (cudaErrorInvalidValue), which launches nothing."""
    scan = tpl.PROFILES["hdl64"].scan
    grid = _to(dense_grid(R=4, H=256), cuda)
    bad = {
        "xyz float64": grid._replace(xyz=grid.xyz.double()),
        "mask shape": grid._replace(mask=grid.mask[:, :-1]),
        "counts int64": grid._replace(counts=grid.counts.long()),
        "counts on the CPU": grid._replace(counts=grid.counts.cpu()),
        "strided xyz": grid._replace(
            xyz=grid.xyz.transpose(0, 1).contiguous().transpose(0, 1)),
    }
    before = FEATURES.launches
    for name, g in bad.items():
        with pytest.raises(ValueError):
            pick_features(g, scan)
    with pytest.raises(ValueError):
        pick_features(grid, scan, pre_suppressed=grid.mask.float())
    refused = "CUDA error 1$"    # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match=refused):
        pick_features(grid, dataclasses.replace(scan, suppression_radius=33))
    with pytest.raises(RuntimeError, match=refused):
        pick_features(grid, dataclasses.replace(scan, n_sectors=0))
    wide = 14000
    with pytest.raises(RuntimeError, match=refused):
        pick_features(RangeImage(torch.zeros((1, wide, 3), device=cuda),
                                 None, torch.zeros((1, wide), dtype=torch.bool,
                                                   device=cuda),
                                 torch.zeros(1, dtype=torch.int32,
                                             device=cuda)), scan)
    assert FEATURES.launches == before
    # the flagship ring (2304 columns) still fits and launches
    pick_features(_to(dense_grid(R=4, H=2304), cuda), scan)
    assert FEATURES.launches == before + 1


@pytest.mark.cuda
def test_failed_stage_capture_raises(cuda):
    """An odometry body that reads to the host passes its eager warm-up and
    breaks its capture: the Pipeline's frame raises, the stage caches no
    graph, the frame is not run op by op in its place, nor on the CPU.  In
    a process of its own: a broken capture leaves its process's CUDA state
    behind (the fused frame's twin, ``test_failed_capture_raises``, comes
    last in this file for that reason)."""
    proc = subprocess.run(
        [sys.executable, "-c", FAILED_STAGE_CAPTURE], capture_output=True,
        text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("RESULT ")]
    assert proc.returncode == 0 and len(lines) == 1, proc.stderr[-3000:]
    got = json.loads(lines[0][len("RESULT "):])
    assert got["raised"]
    assert got["calls"] <= stages.WARMUP_PASSES + 1
    assert got["cached"] == ["features"]
    assert got["frame"] == 0 and got["device"] == "cuda:0"


@pytest.fixture(scope="module")
def hdl64_sweeps():
    """Three flagship sweeps as host arrays (the features stage stages
    them through pinned memory, as a LiDAR driver hands them over)."""
    cfg = tpl.PROFILES["hdl64"]
    return cfg, [(xyz, mask) for _, xyz, mask in tpl.synthetic_frames(3, cfg)]


def _timed_sweeps(cfg, sweeps, device, timers, last=None, ahead=0):
    """The benchmark's odometry front end over ``sweeps``: each stage under
    ``timers``, the pose read back; ``timers`` reset before the last sweep
    (the first captures the graphs, the second replays them first), which
    runs inside ``last`` when given.  With ``ahead`` the last sweep is
    queued behind a spin of the card of that many cycles, so the card runs
    behind the host through both stages."""
    odo = OdometryState.init(cfg.scan.max_less_sharp, cfg.scan.max_less_flat,
                             device)
    for k, (xyz, mask) in enumerate(sweeps):
        final = k == len(sweeps) - 1
        if final:
            timers.reset()
        with last if final and last is not None else contextlib.nullcontext():
            if final and ahead:
                torch.cuda._sleep(ahead)
            with timers.stage("features"):
                feats = stages.run_features(xyz, mask, cfg, device)
            with timers.stage("odometry"):
                odo, out = stages.run_odometry(odo, feats, cfg)
            timers.read(out.q_w)
            torch.cuda.synchronize()
    return timers.device_report()


# ~50 ms of the card's clock: longer than the host takes to enqueue a sweep
AHEAD_CYCLES = 10**8


def _spans_add_up(cfg, sweeps, device, ahead=0):
    timers = StageTimers(device=True)
    try:
        report = _timed_sweeps(cfg, sweeps, device, timers, ahead=ahead)
    finally:
        fused.clear_graphs()
    assert timers.missed == 0
    for stage in ("features", "odometry"):
        parts = sum(report[f"{stage}.{p}"].total_ms
                    for p in ("copy_in", "launch", "graph", "clone_out"))
        whole = report[stage].total_ms
        assert report[f"{stage}.graph"].count == 1
        assert parts == pytest.approx(whole, rel=0.02), (stage, report)
    assert report["odometry.gap"].count == 1


@pytest.mark.cuda
def test_stage_spans_add_up_to_the_stage(cuda, hdl64_sweeps):
    """One HDL-64 sweep: each stage's copy_in + launch + graph + clone_out
    within 2 % of the stage's own events."""
    _spans_add_up(*hdl64_sweeps, cuda)


@pytest.mark.cuda
def test_stage_spans_add_up_with_the_card_behind(cuda, hdl64_sweeps):
    """As test_stage_spans_add_up_to_the_stage, with the sweep queued
    behind a spin of the card (AHEAD_CYCLES): no host gap between the
    spans falls inside a stage."""
    _spans_add_up(*hdl64_sweeps, cuda, ahead=AHEAD_CYCLES)


def _graph_span_matches_the_profiler(cfg, sweeps, device, ahead=0):
    from torch.profiler import ProfilerActivity, profile

    timers = StageTimers(device=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        report = _timed_sweeps(cfg, sweeps, device, timers, last=prof,
                               ahead=ahead)
    finally:
        fused.clear_graphs()
    events = prof.profiler.kineto_results.events()
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.name() == "cudaGraphLaunch")
    assert len(launches) == 2
    for (_, corr), stage in zip(launches, ("features", "odometry")):
        acts = [e for e in events if "CUDA" in str(e.device_type())
                and e.correlation_id() == corr]
        assert len(acts) > 100, stage
        first = min(e.start_ns() for e in acts)
        last = max(e.start_ns() + e.duration_ns() for e in acts)
        assert report[f"{stage}.graph"].mean_ms == pytest.approx(
            (last - first) / 1e6, rel=0.05), stage


@pytest.mark.cuda
def test_graph_span_matches_the_profilers_kernels(cuda, hdl64_sweeps):
    """One profiled HDL-64 sweep: each stage's ``graph`` span within 5 % of
    the first to the last device activity of its replay in the profiler's
    timeline (those that share the cudaGraphLaunch call's correlation)."""
    _graph_span_matches_the_profiler(*hdl64_sweeps, cuda)


@pytest.mark.cuda
def test_graph_span_matches_the_profiler_with_the_card_behind(
        cuda, hdl64_sweeps):
    """As test_graph_span_matches_the_profilers_kernels, with the sweep
    queued behind a spin of the card (AHEAD_CYCLES): each graph is
    launched before the card reaches it."""
    _graph_span_matches_the_profiler(*hdl64_sweeps, cuda,
                                     ahead=AHEAD_CYCLES)


@pytest.mark.cuda
def test_failed_capture_raises(cuda, monkeypatch):
    """A body that reads to the host passes its eager warm-up and breaks
    the capture: the call raises, caches nothing and runs nothing eagerly
    in the graph's place."""
    cfg = tpl.PROFILES["hdl64-small"]
    real_step = fused.odometry_step
    calls = []

    def reads_to_host(state, feats, ocfg, period, **kwargs):
        calls.append(float(state.t_w.sum()))
        return real_step(state, feats, ocfg, period, **kwargs)

    monkeypatch.setattr(fused, "odometry_step", reads_to_host)
    fused.clear_graphs()
    (xyz, mask), = _small_frames(cfg, 1, cuda)
    with pytest.raises(RuntimeError):
        fused.fused_frame_step(*_init_states(cfg, cuda), xyz, mask, cfg)
    assert not fused._GRAPHS
    assert len(calls) <= fused.WARMUP_PASSES + 1
