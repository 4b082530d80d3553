"""Sparse-sensor profiles of the port (VLP-16 / HDL-32 / M2DGR VLP-32C),
twins of tests/test_profiles.py.

Each branch of ``compute_ring_ids`` (the 16-ring, 32-ring and "bounds"
formulas, and the 64-ring one beside them) is held to the JAX function on
one simulated scan of its profile, exactly: ring ids are integers from the
same float32 angle and C truncation (on live rows; rows of padding are
masked out by both).  The tracking runs go through the
port alone with the JAX tests' bounds and carry ``slow`` (3 frames of
odometry per profile).  ~5 s on two CPU threads without ``slow``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.config import HDL32 as J_HDL32
from light_loam_tpu.config import HDL64_KITTI as J_HDL64
from light_loam_tpu.config import M2DGR_VLP32C as J_M2DGR
from light_loam_tpu.config import VLP16 as J_VLP16
from light_loam_tpu.ops.features import compute_ring_ids as j_ring_ids
from light_loam_tpu_torch.config import (
    HDL32,
    HDL64_KITTI,
    M2DGR_VLP32C,
    VLP16,
    ScanConfig,
)
from light_loam_tpu_torch.models.odometry import OdometryState, odometry_step
from light_loam_tpu_torch.ops.features import compute_ring_ids, extract_features
from light_loam_tpu_torch.utils.synthetic import World, pad_cloud, simulate_scan

torch.set_num_threads(2)

# profile: (port config, JAX config, rings, lower, upper) of the scan
PROFILE_SCANS = {
    "vlp16": (VLP16, J_VLP16, 16, -15.0, 15.0),
    "hdl32": (HDL32, J_HDL32, 32, -30.0, 10.0),
    "m2dgr": (M2DGR_VLP32C, J_M2DGR, 32, -25.0, 15.0),
    "hdl64": (HDL64_KITTI, J_HDL64, 64, -24.9, 2.0),
}


@pytest.mark.parametrize("name", sorted(PROFILE_SCANS))
def test_ring_ids_match_jax(name):
    cfg, jcfg, n_rings, lo, hi = PROFILE_SCANS[name]
    pts = simulate_scan(World.urban(seed=6), np.zeros(3), n_rings=n_rings,
                        lower_deg=lo, upper_deg=hi, n_azimuth=500,
                        noise=0.01, seed=40)
    xyz, mask = pad_cloud(pts, 32768)
    # a few points off the sensor's vertical field: the range check
    xyz[:8, 2] = np.linspace(-60.0, 60.0, 8)
    ring, ok = compute_ring_ids(torch.as_tensor(xyz), torch.as_tensor(mask),
                                cfg.scan)
    j_ring, j_ok = j_ring_ids(jnp.asarray(xyz), jnp.asarray(mask), jcfg.scan)
    # padding rows (0, 0, 0) have no angle: XLA converts that NaN to ring
    # 0, torch to INT32_MIN; both are masked out, so only live rows compare
    np.testing.assert_array_equal(ring.numpy()[mask], np.asarray(j_ring)[mask])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert ok.sum() > 0.9 * mask.sum() - 8
    # every ring is hit (the hardcoded 32-beam formula bins the top beam
    # of a [-30, 10] deg scan out of range)
    assert len(np.unique(ring.numpy()[ok.numpy()])) >= n_rings - 1


def test_m2dgr_ring_formula():
    """M2DGR VLP-32C recipe: the linear bound formula over [-25, 15]
    replaces the hardcoded 32-beam one."""
    cfg = M2DGR_VLP32C.scan
    assert cfg.ring_formula == "bounds"
    angles = np.linspace(-25.0, 15.0, 32)
    r = 10.0
    xyz = np.stack([r * np.cos(np.radians(angles)), np.zeros_like(angles),
                    r * np.sin(np.radians(angles))], axis=1).astype(np.float32)
    mask = torch.ones(len(angles), dtype=torch.bool)
    ring, ok = compute_ring_ids(torch.as_tensor(xyz), mask, cfg)
    np.testing.assert_array_equal(ring.numpy(), np.arange(32))
    assert ok.all()
    ring32, _ = compute_ring_ids(torch.as_tensor(xyz), mask, HDL32.scan)
    assert not np.array_equal(ring32.numpy(), np.arange(32))


def test_ring_formula_validated():
    with pytest.raises(ValueError, match="ring_formula"):
        ScanConfig(ring_formula="bound")


def _track(profile, n_rings, lo, hi, seed0):
    scan_cfg = dataclasses.replace(profile.scan, h_max=512, max_points=32768)
    ocfg = dataclasses.replace(profile.odometry, outer_iterations=3,
                               inner_iterations=4)
    world = World.urban(seed=6)
    state = OdometryState.init(scan_cfg.max_less_sharp,
                               scan_cfg.max_less_flat, "cpu")
    for i in range(3):
        pts = simulate_scan(world, np.array([0.5 * i, 0.0, 0.0]),
                            n_rings=n_rings, lower_deg=lo, upper_deg=hi,
                            n_azimuth=500, noise=0.01, seed=seed0 + i)
        xyz, mask = pad_cloud(pts, scan_cfg.max_points)
        feats = extract_features(torch.as_tensor(xyz), torch.as_tensor(mask),
                                 scan_cfg)
        state, out = odometry_step(state, feats, ocfg)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("name", ["vlp16", "hdl32"])
def test_sparse_profile_tracks(name):
    profile, _, n_rings, lo, hi = PROFILE_SCANS[name]
    out = _track(profile, n_rings, lo, hi, 40)
    t = out.t_w.numpy()
    assert np.linalg.norm(t - [1.0, 0, 0]) < 0.25, f"{n_rings}-ring: {t}"
    assert int(out.corner_count) > 20
    assert int(out.plane_count) > 80


@pytest.mark.slow
def test_m2dgr_profile_tracks():
    out = _track(M2DGR_VLP32C, 32, -25.0, 15.0, 70)
    t = out.t_w.numpy()
    assert np.linalg.norm(t - [1.0, 0, 0]) < 0.25, f"M2DGR drift: {t}"
    assert int(out.corner_count) > 20
    assert int(out.plane_count) > 80
