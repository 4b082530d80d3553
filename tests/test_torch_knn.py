"""Correspondence searches and the 5-NN of the PyTorch port against the JAX
package.

The odometry searches (corner, grid surf) must pick the same indices and
validity; the two-pass tiled surf search the same validity and picks at
the same exact distances (indices modulo ties), with or without its
live-prefix count, and the same points as the grid search.  ``knn5_plain`` (the plain version of the CUDA 5-NN kernel) is held
against ``knn_tiled`` and the Pallas kernel in interpret mode, mirroring
tests/test_pallas_knn.py: distances to rtol 1e-5 / atol 1e-4 plus two float32
ulps of |q|² + |r|² — the Gram form ‖q‖² + ‖r‖² − 2q·r rounds at that scale
(~5e-4 m² here), and jitted XLA contracts it into an FMA where eager PyTorch
does not; indices equal where a neighbour exists (d < 1e30; empty slots
carry index 0 here and any index in knn_tiled).

The CUDA kernel's host-side launch geometry, and its algorithm (segment
top-5 lists merged lexicographically) emulated in plain torch, are checked
here too; the kernel itself runs in test_torch_cuda.py."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.core.frame import PointCloud as JCloud
from light_loam_tpu.ops import knn as jk
from light_loam_tpu.ops.pallas_knn import knn_pallas
from light_loam_tpu.utils.synthetic import World, simulate_scan
from light_loam_tpu_torch.core.frame import PointCloud as TCloud
from light_loam_tpu_torch.ops import knn as tk
from light_loam_tpu_torch.ops import cuda_knn as ck
from light_loam_tpu_torch.ops.cuda_knn import KNN5, knn5, knn5_plain
from test_torch_cuda import lattice_knn_inputs

torch.set_num_threads(2)

RTOL, ATOL, GRAM_ULPS = 1e-5, 1e-4, 2.0


def _cloud(rng, n, scale=60.0):
    return (rng.random((n, 3), np.float32) - 0.5) * scale


def _counts(qc, rc):
    return torch.tensor([qc, rc], dtype=torch.int32)


def _assert_knn_equal(q, r, d_t, i_t, d_j, i_j):
    d_t, i_t = d_t.numpy(), i_t.numpy()
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    scale = (q * q).sum(-1)[:, None] + (r * r).sum(-1)[i_t]
    tol = RTOL * np.abs(d_j) + ATOL + GRAM_ULPS * np.finfo(np.float32).eps * scale
    assert (np.abs(d_t - d_j) <= tol).all(), np.abs(d_t - d_j).max()
    live = d_j < 1e30
    np.testing.assert_array_equal(i_t[live], i_j[live])
    assert (i_t[~live] == 0).all()
    assert i_t.dtype == np.int32


@pytest.mark.parametrize("Q,N", [(128, 1024), (300, 5000), (256, 2048)])
def test_knn5_plain_matches_knn_tiled_and_pallas(Q, N):
    rng = np.random.default_rng(0)
    q, r = _cloud(rng, Q), _cloud(rng, N)
    m = rng.random(N) > 0.2
    d_t, i_t = knn5_plain(torch.as_tensor(q), torch.as_tensor(r),
                          torch.as_tensor(m), _counts(Q, N), tile=1024)
    d_j, i_j = jk.knn_tiled(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                            k=5, tile=1024)
    _assert_knn_equal(q, r, d_t, i_t, d_j, i_j)
    d_p, i_p = knn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                          k=5, interpret=True)
    _assert_knn_equal(q, r, d_t, i_t, d_p, i_p)


def test_masked_columns_never_selected():
    rng = np.random.default_rng(1)
    q, r = _cloud(rng, 64), _cloud(rng, 512)
    m = np.zeros(512, bool)
    m[:7] = True
    d, i = knn5(torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(m),
                _counts(64, 512))
    assert int(i.max()) < 7
    assert torch.isfinite(d).all()


def test_fewer_live_points_than_k():
    rng = np.random.default_rng(5)
    q, r = _cloud(rng, 40), _cloud(rng, 300)
    m = np.zeros(300, bool)
    m[[3, 150, 299]] = True
    d_t, i_t = knn5_plain(torch.as_tensor(q), torch.as_tensor(r),
                          torch.as_tensor(m), _counts(40, 300), tile=128)
    d_j, i_j = jk.knn_tiled(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                            k=5, tile=128)
    _assert_knn_equal(q, r, d_t, i_t, d_j, i_j)
    assert (d_t[:, 3:] > 1e20).all() and (d_t[:, :3] < 1e20).all()


def test_all_masked_returns_big():
    rng = np.random.default_rng(2)
    q, r = _cloud(rng, 32), _cloud(rng, 256)
    d, i = knn5(torch.as_tensor(q), torch.as_tensor(r),
                torch.zeros(256, dtype=torch.bool), _counts(32, 256))
    assert (d > 1e20).all() and (i == 0).all()


def test_count_skip_matches_full_search():
    """Live-prefix operands: rows below query_count equal the full search
    exactly; rows at or past it come back as (1e30, 0)."""
    rng = np.random.default_rng(4)
    Q, N = 600, 5000
    q, r = _cloud(rng, Q), _cloud(rng, N)
    n_live_r, n_live_q = 1800, 450
    m = np.zeros(N, bool)
    m[:n_live_r] = True
    args = (torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(m))
    d_full, i_full = knn5_plain(*args, _counts(Q, N))
    d_skip, i_skip = knn5_plain(*args, _counts(n_live_q, n_live_r))
    assert torch.equal(d_skip[:n_live_q], d_full[:n_live_q])
    assert torch.equal(i_skip[:n_live_q], i_full[:n_live_q])
    assert (d_skip[n_live_q:] > 1e20).all() and (i_skip[n_live_q:] == 0).all()
    d_p, i_p = knn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                          k=5, interpret=True,
                          query_count=jnp.int32(n_live_q),
                          ref_count=jnp.int32(n_live_r))
    _assert_knn_equal(q[:n_live_q], r, d_skip[:n_live_q], i_skip[:n_live_q],
                      np.asarray(d_p)[:n_live_q], np.asarray(i_p)[:n_live_q])


def test_cpu_tensors_do_not_launch_the_kernel():
    KNN5.launches = 0
    rng = np.random.default_rng(6)
    knn5(torch.as_tensor(_cloud(rng, 16)), torch.as_tensor(_cloud(rng, 64)),
         torch.ones(64, dtype=torch.bool), _counts(16, 64))
    assert KNN5.launches == 0


@pytest.fixture(scope="module")
def scans():
    world = World.urban(seed=7)
    a = simulate_scan(world, np.zeros(3), n_azimuth=500, noise=0.01, seed=1)
    b = simulate_scan(world, np.array([0.3, 0.05, 0.0]), n_azimuth=500,
                      noise=0.01, seed=2)
    return a, b


def _ring_cloud(pts, n_rings, cap_per_ring, rng):
    """A ring-slotted cloud (ring r owns rows [r*C, r*C+C)) with holes."""
    ring = np.clip((np.arange(len(pts)) % n_rings), 0, n_rings - 1)
    xyz = np.zeros((n_rings * cap_per_ring, 3), np.float32)
    rel = np.zeros(n_rings * cap_per_ring, np.float32)
    mask = np.zeros(n_rings * cap_per_ring, bool)
    for r in range(n_rings):
        sel = pts[ring == r][:cap_per_ring]
        keep = rng.random(len(sel)) < 0.9
        rows = r * cap_per_ring + np.arange(len(sel))
        xyz[rows] = sel
        rel[rows] = r + 0.05
        mask[rows] = keep
    return xyz, rel, mask


def test_corner_correspondences_match_jax(scans):
    a, b = scans
    rng = np.random.default_rng(8)
    xyz, rel, mask = _ring_cloud(a, 16, 96, rng)
    qn = 700
    query = b[rng.permutation(len(b))[:qn]].astype(np.float32)
    qmask = rng.random(qn) < 0.95
    j = jk.corner_correspondences(jnp.asarray(query), jnp.asarray(qmask),
                                  JCloud(jnp.asarray(xyz), jnp.asarray(rel),
                                         jnp.asarray(mask)))
    t = tk.corner_correspondences(torch.as_tensor(query),
                                  torch.as_tensor(qmask),
                                  TCloud(torch.as_tensor(xyz),
                                         torch.as_tensor(rel),
                                         torch.as_tensor(mask)))
    assert int(np.asarray(j.valid).sum()) > 100
    for name in ("a_idx", "b_idx", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))


def test_surf_correspondences_grid_match_jax(scans):
    a, b = scans
    rng = np.random.default_rng(9)
    n_rings = 16
    xyz, rel, mask = _ring_cloud(a, n_rings, 256, rng)
    qn = 1000
    query = b[rng.permutation(len(b))[:qn]].astype(np.float32)
    qmask = rng.random(qn) < 0.95
    j = jk.surf_correspondences_grid(
        jnp.asarray(query), jnp.asarray(qmask),
        JCloud(jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask)), n_rings)
    t = tk.surf_correspondences_grid(
        torch.as_tensor(query), torch.as_tensor(qmask),
        TCloud(torch.as_tensor(xyz), torch.as_tensor(rel),
               torch.as_tensor(mask)), n_rings)
    assert int(np.asarray(j.valid).sum()) > 100
    for name in ("a_idx", "b_idx", "c_idx", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))


def _compacted(xyz, rel, mask):
    """The live rows of a cloud moved to its prefix in order, as the tiled
    odometry hand-off stores it (ops.voxel.compact_rows)."""
    n = int(mask.sum())
    out = [np.zeros_like(a) for a in (xyz, rel, mask)]
    for o, a in zip(out, (xyz, rel, mask)):
        o[:n] = a[mask]
    return (*out, n)


def _picked_sq_dist(query, ref_xyz, idx):
    return ((ref_xyz.astype(np.float64)[idx] - query.astype(np.float64)) ** 2
            ).sum(-1)


@pytest.mark.parametrize("ref_count", [False, True])
def test_surf_correspondences_tiled_match_jax(scans, ref_count):
    """The two-pass tiled search over a compacted cloud, with and without
    the live-prefix count: valid flags equal, and each pick at the same
    exact distance as JAX's (indices modulo ties)."""
    a, b = scans
    rng = np.random.default_rng(10)
    xyz, rel, mask = _ring_cloud(a[::8], 16, 512, rng)
    xyz, rel, mask, n_live = _compacted(xyz, rel, mask)
    assert n_live < len(mask) // 2
    qn = 1000
    query = b[rng.permutation(len(b))[:qn]].astype(np.float32)
    qmask = rng.random(qn) < 0.95
    count = n_live if ref_count else None
    j = jk.surf_correspondences(
        jnp.asarray(query), jnp.asarray(qmask),
        JCloud(jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask)),
        tile=512, ref_count=None if count is None else jnp.int32(count))
    t = tk.surf_correspondences(
        torch.as_tensor(query), torch.as_tensor(qmask),
        TCloud(torch.as_tensor(xyz), torch.as_tensor(rel),
               torch.as_tensor(mask)), tile=512, ref_count=count)
    valid = np.asarray(j.valid)
    assert valid.sum() > 100
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    for name in ("a_idx", "b_idx", "c_idx"):
        ti, ji = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert (ti[valid] < n_live).all()
        np.testing.assert_array_equal(
            _picked_sq_dist(query, xyz, ti)[valid],
            _picked_sq_dist(query, xyz, ji)[valid])


def test_live_prefix_skip_is_exact(scans):
    """Visiting only the live tiles of a compacted cloud gives the full
    sweep's matches exactly."""
    a, b = scans
    rng = np.random.default_rng(11)
    xyz, rel, mask, n_live = _compacted(*_ring_cloud(a[::8], 16, 512, rng))
    query = torch.as_tensor(b[:600].astype(np.float32))
    qmask = torch.ones(600, dtype=torch.bool)
    cloud = TCloud(torch.as_tensor(xyz), torch.as_tensor(rel),
                   torch.as_tensor(mask))
    full = tk.surf_correspondences(query, qmask, cloud, tile=512)
    skip = tk.surf_correspondences(query, qmask, cloud, tile=512,
                                   ref_count=n_live)
    assert -(-n_live // 512) < -(-len(mask) // 512)
    for f, s_ in zip(full, skip):
        assert torch.equal(f, s_)


@pytest.mark.parametrize("compacted", [False, True])
def test_surf_tiled_matches_grid(scans, compacted):
    """The tiled search, on a ring-slotted cloud or on its compacted copy
    (with the live count), finds the same points as the grid search on the
    ring-slotted cloud: ring-major order is global index order, and
    compaction keeps the order."""
    a, b = scans
    rng = np.random.default_rng(12)
    n_rings = 16
    xyz, rel, mask = _ring_cloud(a[::8], n_rings, 512, rng)
    query = torch.as_tensor(b[rng.permutation(len(b))[:1000]].astype(
        np.float32))
    qmask = torch.as_tensor(rng.random(1000) < 0.95)
    grid_cloud = TCloud(*(torch.as_tensor(x) for x in (xyz, rel, mask)))
    g = tk.surf_correspondences_grid(query, qmask, grid_cloud, n_rings)
    if compacted:
        cx, cr, cm, n_live = _compacted(xyz, rel, mask)
        cloud = TCloud(*(torch.as_tensor(x) for x in (cx, cr, cm)))
    else:
        cloud, n_live = grid_cloud, None
    t = tk.surf_correspondences(query, qmask, cloud, tile=1024,
                                ref_count=n_live)
    assert torch.equal(t.valid, g.valid) and int(g.valid.sum()) > 100
    v = g.valid
    for ti, gi in ((t.a_idx, g.a_idx), (t.b_idx, g.b_idx), (t.c_idx, g.c_idx)):
        assert torch.equal(cloud.xyz[ti][v], grid_cloud.xyz[gi][v])


# corner and surf capacities of the flagship mapping stage (HDL64_KITTI)
FLAGSHIP = [(2048, 32768), (8192, 65536)]
H100_SMS = 132


def _knn_cu_constants() -> dict:
    """The ``constexpr int`` constants of knn.cu, read from its source."""
    src = (Path(ck.__file__).parent.parent / "csrc" / "knn.cu").read_text()
    return {m[1]: int(m[2])
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}


def test_knn_host_constants_match_the_kernel_source():
    """The wrapper's copies of knn.cu's constants equal the source's, and
    the kernel's static shared memory (the float4 tile and QCAP (x, index)
    queue slots per query) needs no opt-in above 48 KB."""
    c = _knn_cu_constants()
    assert c["QB"] == ck.QUERIES_PER_BLOCK
    assert c["MAX_SEGMENTS"] == ck.MAX_SEGMENTS
    assert 16 * c["TILE"] + 8 * c["QCAP"] * c["QB"] <= 48 * 1024


@pytest.mark.parametrize("Q,N", FLAGSHIP)
@pytest.mark.parametrize("rc", [0, 1, 5, "S-1", "tile+1", 12288, 24576, "N"])
def test_knn_geometry_covers_every_pair_once(Q, N, rc):
    """Block (b, s) of knn.cu pairs rows [b * QB, b * QB + QB) below Q with
    references [s * length, min((s + 1) * length, rc)): each axis is covered
    once, so each pair of the live grid is."""
    g = ck.knn_geometry(Q, N)
    tile = _knn_cu_constants()["TILE"]
    rc = {"S-1": g.segments - 1, "tile+1": tile + 1, "N": N}.get(rc, rc)
    length = ck.segment_length(rc, g.segments)
    refs = np.zeros(rc, np.int64)
    for s in range(g.segments):
        lo = min(s * length, rc)
        refs[lo:min(lo + length, rc)] += 1
    rows = np.zeros(Q, np.int64)
    qb = ck.QUERIES_PER_BLOCK
    for b in range(g.query_blocks):
        rows[b * qb:(b + 1) * qb] += 1
    assert (refs == 1).all() and (rows == 1).all()
    if rc > (g.segments - 1) ** 2:
        # every segment holds live references
        assert (g.segments - 1) * length < rc


@pytest.mark.parametrize("Q,N,blocks,segments", [
    (1, 1, 1, 1), (128, 511, 1, 1), (129, 512, 2, 2), (300, 5000, 3, 16)])
def test_knn_geometry_at_small_capacities(Q, N, blocks, segments):
    """Segments: the largest power of two, at most MAX_SEGMENTS, that
    leaves MIN_SEGMENT references each at capacity N."""
    assert ck.knn_geometry(Q, N) == (blocks, segments)


@pytest.mark.parametrize("Q,N", FLAGSHIP)
def test_knn_geometry_fills_the_card(Q, N):
    g = ck.knn_geometry(Q, N)
    assert g.blocks >= H100_SMS
    # at the live counts the mapping stage hands over (chip_smoke phase 3's
    # "below": 5/8 of the queries), at least two blocks per SM stay live
    live_rows = Q * 5 // 8
    assert (-(-live_rows // ck.QUERIES_PER_BLOCK) * g.segments
            >= 2 * H100_SMS)


def _split_knn5(query, ref, mask, qc, rc, segments):
    """knn.cu's algorithm in plain torch: per segment the lexicographic
    top-5 of (d, index) over its references, padded with (1e30, 0); then
    the lexicographic top-5 of the union of the segment lists."""
    Q = query.shape[0]
    big, inf = ck.BIG, float("inf")
    q2 = (query * query).sum(-1)
    r2 = torch.where(mask, (ref * ref).sum(-1), inf)
    d = torch.clamp((q2[:, None] + r2[None, :]) - 2.0 * (query @ ref.T), min=0)
    length = ck.segment_length(rc, segments)
    lists_d, lists_i = [], []
    for s in range(segments):
        lo = min(s * length, rc)
        hi = min(lo + length, rc)
        dd = torch.cat([d[:, lo:hi], torch.full((Q, ck.K), inf)], 1)
        ii = torch.cat([torch.arange(lo, hi).expand(Q, -1),
                        torch.zeros((Q, ck.K), dtype=torch.int64)], 1)
        pick = torch.sort(dd, dim=1, stable=True).indices[:, :ck.K]
        sd, si = dd.gather(1, pick), ii.gather(1, pick)
        real = sd < big
        lists_d.append(torch.where(real, sd, big))
        lists_i.append(torch.where(real, si, 0))
    md, mi = torch.cat(lists_d, 1), torch.cat(lists_i, 1)
    # lexicographic on (d, index): by index, then stably by distance
    by_i = torch.sort(mi, dim=1, stable=True).indices
    md, mi = md.gather(1, by_i), mi.gather(1, by_i)
    by_d = torch.sort(md, dim=1, stable=True).indices[:, :ck.K]
    out_d, out_i = md.gather(1, by_d), mi.gather(1, by_d)
    dead = torch.arange(Q) >= qc
    out_d[dead], out_i[dead] = big, 0
    return out_d, out_i.to(torch.int32)


@pytest.mark.parametrize("Q,N,qc,rc", [(300, 5000, 300, 4001),
                                       (256, 4096, 200, 1000),
                                       (64, 1024, 64, 7)])
@pytest.mark.parametrize("segments", [None, 5, 32])
def test_segment_lists_and_merge_equal_the_single_scan(Q, N, qc, rc,
                                                       segments):
    """On lattice inputs (exact distances, many ties, tied references on
    the segment borders) the split algorithm equals knn5_plain exactly."""
    segments = segments or ck.knn_geometry(Q, N).segments
    q, r, m = (torch.as_tensor(a) for a in
               lattice_knn_inputs(Q, N, rc, seed=rc, segments=segments))
    counts = _counts(qc, rc)
    d_s, i_s = _split_knn5(q, r, m, qc, rc, segments)
    d_p, i_p = knn5_plain(q, r, m, counts)
    assert torch.equal(d_s, d_p) and torch.equal(i_s, i_p)
    assert bool((d_p[:qc, 1:] == d_p[:qc, :-1]).any())
