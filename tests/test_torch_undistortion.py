"""The port's motion-compensation hook and its correspondence searches
against literal NumPy ports of the reference, twins of
tests/test_undistortion.py and of tests/test_matching.py's literal-scan
cases.

  1. ``_transform_to_start(distortion=True)`` pointwise against the literal
     TransformToStart (laserOdometry.cpp:77-95): sweep fractions within
     2e-5, points within 2e-4 m (the JAX test's bounds);
  2. on scans with real intra-sweep motion (12 m/s), the port's odometry
     with distortion=True stays at the true motion (10 cm) and puts the
     undistorted points back on the world's surfaces (the JAX test's
     bounds, on the port alone);
  3. the corner and the tiled surf search against the reference's ring
     array scans: the same 1-NN index, the 2nd / 3rd points at the same
     distance (rtol 1e-5: argmin may pick another index at an exactly equal
     distance), on the right rings; and ``knn_tiled`` against brute force.
~15 s on two CPU threads.
"""

import numpy as np
import torch

from light_loam_tpu_torch.config import OdometryConfig, ScanConfig
from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.models.odometry import (
    OdometryState,
    _transform_to_start,
    odometry_step,
    transform_to_end,
)
from light_loam_tpu_torch.ops import knn
from light_loam_tpu_torch.ops.features import extract_features
from light_loam_tpu_torch.utils.synthetic import World, pad_cloud, simulate_scan
from test_matching import (
    NEARBY,
    literal_corner_match,
    literal_surf_match,
    make_ring_sorted_cloud,
)
from test_undistortion import _rot_np, _slerp_identity_np, _world_surface_dist

torch.set_num_threads(2)


def test_transform_to_start_matches_literal_port():
    rng = np.random.default_rng(0)
    n = 64
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    ring = rng.integers(0, 16, n)
    rel_time = rng.random(n)
    scan_period = 0.1
    rel = (ring + scan_period * rel_time).astype(np.float32)
    pc = PointCloud(xyz=torch.as_tensor(xyz), rel=torch.as_tensor(rel),
                    mask=torch.ones(n, dtype=torch.bool))
    # a non-trivial increment: ~3 deg rotation + 0.8 m translation
    axis = np.array([0.2, -0.3, 0.93])
    axis /= np.linalg.norm(axis)
    half = 0.025
    q = np.concatenate([axis * np.sin(half), [np.cos(half)]]).astype(np.float32)
    t = np.array([0.7, -0.3, 0.1], np.float32)

    out, s = _transform_to_start(torch.as_tensor(q), torch.as_tensor(t), pc,
                                 distortion=True, scan_period=scan_period)
    out, s = out.numpy(), s.numpy()
    np.testing.assert_allclose(s, rel_time, atol=2e-5)
    for i in range(n):
        q_pl = _slerp_identity_np(q.astype(np.float64), float(s[i]))
        expect = _rot_np(q_pl, xyz[i].astype(np.float64)) + s[i] * t
        np.testing.assert_allclose(out[i], expect, atol=2e-4)


def test_undistortion_recovers_geometry_on_distorted_scans():
    """(a) seeded with the exact increment, the distortion=True solve stays
    at the true motion; (b) undistorting with the solved increment puts the
    points of vertical structure back on the world's boxes, where the raw
    scan is warped by up to |v| ≈ 1.2 m."""
    scan_cfg = ScanConfig(n_scans=64, minimum_range=5.0, h_max=1024,
                          max_points=65536)
    cfg = OdometryConfig(outer_iterations=3, inner_iterations=4,
                         distortion=True)
    world = World.urban(seed=5)
    step = np.array([1.2, 0.0, 0.0], np.float32)  # 12 m/s

    feats = []
    for i in range(3):
        pts = simulate_scan(
            world, (step * i).astype(float), n_rings=scan_cfg.n_scans,
            lower_deg=scan_cfg.lower_bound_deg,
            upper_deg=scan_cfg.upper_bound_deg,
            n_azimuth=700, noise=0.005, seed=60 + i, sweep_motion=step,
        )
        xyz, mask = pad_cloud(pts, scan_cfg.max_points)
        feats.append(extract_features(torch.as_tensor(xyz),
                                      torch.as_tensor(mask), scan_cfg))

    q_i = torch.tensor([0.0, 0.0, 0.0, 1.0])
    t_v = torch.as_tensor(step)
    state = OdometryState.init(scan_cfg.max_less_sharp,
                               scan_cfg.max_less_flat, "cpu")
    state = state._replace(
        corner_last=transform_to_end(q_i, t_v, feats[1].less_sharp, True,
                                     scan_cfg.scan_period),
        surf_last=transform_to_end(q_i, t_v, feats[1].less_flat, True,
                                   scan_cfg.scan_period),
        q_lc=q_i, t_lc=t_v,
        frame=torch.tensor(2, dtype=torch.int32),
    )
    state, _ = odometry_step(state, feats[2], cfg, scan_cfg.scan_period)
    t_solved = state.t_lc.numpy()
    assert np.linalg.norm(t_solved - step) < 0.1, t_solved

    flat = feats[2].less_flat
    und, _s = _transform_to_start(state.q_lc, state.t_lc, flat,
                                  distortion=True,
                                  scan_period=scan_cfg.scan_period)
    m = flat.mask.numpy()
    sensor_start = step * 2.0
    raw_w = flat.xyz.numpy()[m] + sensor_start
    und_w = und.numpy()[m] + sensor_start
    dg_r, db_r = _world_surface_dist(world, raw_w)
    _dg_u, db_u = _world_surface_dist(world, und_w)
    on_box = db_r < dg_r
    assert on_box.sum() > 200
    raw_err = float(np.median(db_r[on_box]))
    und_err = float(np.median(db_u[on_box]))
    assert raw_err > 0.10, raw_err
    assert und_err < 0.5 * raw_err, (und_err, raw_err)


def _ref_cloud(xyz, rel):
    return PointCloud(xyz=torch.as_tensor(xyz), rel=torch.as_tensor(rel),
                      mask=torch.ones(len(xyz), dtype=torch.bool))


def _sq(xyz, i, q):
    return np.sum((xyz[i] - q) ** 2)


def test_corner_matches_literal_scan():
    rng = np.random.default_rng(0)
    xyz, rel, ring = make_ring_sorted_cloud(rng)
    queries = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
    out = knn.corner_correspondences(torch.as_tensor(queries),
                                     torch.ones(64, dtype=torch.bool),
                                     _ref_cloud(xyz, rel))
    for i in range(64):
        a, b = literal_corner_match(queries[i], xyz, ring)
        if a < 0 or b < 0:
            assert not bool(out.valid[i])
            continue
        assert bool(out.valid[i])
        assert int(out.a_idx[i]) == a
        b_k = int(out.b_idx[i])
        np.testing.assert_allclose(_sq(xyz, b_k, queries[i]),
                                   _sq(xyz, b, queries[i]), rtol=1e-5)
        assert ring[b_k] != ring[a] and abs(ring[b_k] - ring[a]) <= NEARBY


def test_surf_matches_literal_scan():
    rng = np.random.default_rng(1)
    xyz, rel, ring = make_ring_sorted_cloud(rng, n=600)
    queries = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
    out = knn.surf_correspondences(torch.as_tensor(queries),
                                   torch.ones(64, dtype=torch.bool),
                                   _ref_cloud(xyz, rel), tile=128)
    for i in range(64):
        a, b, c = literal_surf_match(queries[i], xyz, ring)
        if a < 0 or b < 0 or c < 0:
            assert not bool(out.valid[i])
            continue
        assert bool(out.valid[i])
        assert int(out.a_idx[i]) == a
        b_k, c_k = int(out.b_idx[i]), int(out.c_idx[i])
        np.testing.assert_allclose(_sq(xyz, b_k, queries[i]),
                                   _sq(xyz, b, queries[i]), rtol=1e-5)
        np.testing.assert_allclose(_sq(xyz, c_k, queries[i]),
                                   _sq(xyz, c, queries[i]), rtol=1e-5)
        assert ring[b_k] == ring[a]
        assert ring[c_k] != ring[a]


def test_knn_tiled_matches_bruteforce():
    rng = np.random.default_rng(2)
    ref = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    mask = np.ones(1000, bool)
    mask[900:] = False
    q = rng.uniform(-5, 5, (32, 3)).astype(np.float32)
    d, i = knn.knn_tiled(torch.as_tensor(q), torch.as_tensor(ref),
                         torch.as_tensor(mask), k=5, tile=256)
    d, i = d.numpy(), i.numpy()
    full = np.sum((q[:, None, :] - ref[None, :900, :]) ** 2, axis=-1)
    for r in range(32):
        np.testing.assert_allclose(np.sort(d[r]), np.sort(full[r])[:5],
                                   rtol=1e-3, atol=1e-4)
        assert (i[r] < 900).all()
    assert (np.diff(d, axis=1) >= -1e-6).all()
