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
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from chip_smoke import expected_launches, latent_vote_config
from light_loam_tpu_torch.core.frame import PointCloud
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
from light_loam_tpu_torch.ops.graphvote import full_graph_vote, simple_vote
from light_loam_tpu_torch.ops.knn import (
    surf_correspondences,
    surf_correspondences_grid,
)
from light_loam_tpu_torch.ops.voxel import compact_rows
from light_loam_tpu_torch.utils.synthetic import World, simulate_scan

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
    run = dict(n_frames=5 if latent else 3, profile="hdl64-small",
               n_azimuth=700, speed=0.6, seed=2)
    cfg = tpl.PROFILES[run["profile"]]
    if latent:
        cfg = latent_vote_config(cfg)
    KNN5.launches = VOTE.launches = 0
    pipe, res = _run_synthetic(cfg, run, "cuda")
    n_mapped = sum(r.mapped for r in res)
    want = expected_launches(cfg, len(res), n_mapped)
    assert {"vote.cu": VOTE.launches, "knn.cu": KNN5.launches} == want
    cpu_pipe, _ = _run_synthetic(cfg, run, "cpu")
    # the CPU and the card round differently; see test_torch_pipeline.py
    np.testing.assert_allclose(pipe.mapped_positions(),
                               cpu_pipe.mapped_positions(), rtol=0, atol=0.02)


def _run_synthetic(cfg, run, device):
    pipe = tpl.Pipeline(cfg, device=device)
    frames = tpl.synthetic_frames(run["n_frames"], cfg, run["n_azimuth"],
                                  run["speed"], run["seed"])
    return pipe, [pipe.process_frame(xyz, mask) for _, xyz, mask in frames]
