"""The port's odometry and mapping steps against tests/oracle.py directly:
the independent float64 NumPy port of laserOdometry.cpp:439-831 and
laserMapping.cpp:1834-2101.  Twins of tests/test_odometry_oracle.py and
tests/test_mapping_oracle.py, with their bounds:

  * odometry, whole frames at the reference's 3 × 4 schedule with the vote
    active from frame 2: each increment within 2 % of the oracle's step +
    2 mm, rotation within 2e-3 rad;
  * mapping, two scan-to-map frames on the same gathered local map and
    downsampled stacks for both sides: the oracle within 0.15 m of the
    truth (map-content bias, see the JAX test) and the port within 5 mm /
    2e-3 rad of the oracle.

Float32 kernels against a float64 oracle, analytic Jacobians against
finite differences, and k-NN / eigenvector tie-breaking are what the bounds
absorb.  ~30 s on two CPU threads.
"""

import numpy as np
import torch

from light_loam_tpu_torch.config import MappingConfig
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.models.mapping import (
    MappingState,
    _gather_local,
    _recenter,
    mapping_step,
)
from light_loam_tpu_torch.models.odometry import OdometryState, odometry_step
from light_loam_tpu_torch.ops.features import extract_features
from light_loam_tpu_torch.ops.voxel import voxel_downsample
from light_loam_tpu_torch.utils.synthetic import (
    Box,
    World,
    pad_cloud,
    simulate_scan,
)
from oracle import oracle_mapping_frame, oracle_odometry_frame
from test_odometry_oracle import ODO, SCAN

torch.set_num_threads(2)


def _compact(pc):
    m = pc.mask.numpy()
    return (pc.xyz.numpy().astype(np.float64)[m],
            np.floor(pc.rel.numpy().astype(np.float64)[m]))


def _angle(q_a, q_b):
    return 2.0 * np.arccos(min(1.0, abs(float(np.dot(q_a, q_b)))))


def test_whole_frame_odometry_parity_vs_oracle():
    world = World.urban(seed=3)
    true_step = np.array([0.8, 0.02, 0.0])
    state = OdometryState.init(SCAN.max_less_sharp, SCAN.max_less_flat, "cpu")
    o_q = np.array([0.0, 0.0, 0.0, 1.0])
    o_t = np.zeros(3)
    for i in range(4):
        pts = simulate_scan(
            world, true_step * i, n_rings=SCAN.n_scans,
            lower_deg=SCAN.lower_bound_deg, upper_deg=SCAN.upper_bound_deg,
            n_azimuth=700, noise=0.005, seed=40 + i,
        )
        xyz, mask = pad_cloud(pts, SCAN.max_points)
        f = extract_features(torch.as_tensor(xyz), torch.as_tensor(mask),
                             SCAN)
        prev_corner, prev_surf = state.corner_last, state.surf_last
        frame_idx = int(state.frame)
        state, _ = odometry_step(state, f, ODO, SCAN.scan_period)
        if i == 0:
            continue  # no previous cloud: both sides are a no-op

        cl_xyz, cl_ring = _compact(prev_corner)
        sl_xyz, sl_ring = _compact(prev_surf)
        sharp = f.sharp.xyz.numpy().astype(np.float64)[f.sharp.mask.numpy()]
        flat = f.flat.xyz.numpy().astype(np.float64)[f.flat.mask.numpy()]
        o_q, o_t = oracle_odometry_frame(
            cl_xyz, cl_ring, sl_xyz, sl_ring, sharp, flat, o_q, o_t,
            frame=frame_idx, outer_iterations=ODO.outer_iterations,
            inner_iterations=ODO.inner_iterations,
            vote_start_frame=ODO.vote_start_frame,
            plane_vote_regions=ODO.plane_vote_regions,
        )
        k_t = state.t_lc.numpy().astype(np.float64)
        k_q = state.q_lc.numpy().astype(np.float64)
        dt = np.linalg.norm(k_t - o_t)
        step_len = max(np.linalg.norm(o_t), 1e-9)
        assert dt < 0.02 * step_len + 2e-3, (
            f"frame {i}: increment off the oracle by {dt:.5f} m "
            f"(oracle step {step_len:.3f} m, port {k_t}, oracle {o_t})")
        assert _angle(k_q, o_q) < 2e-3, f"frame {i}: rotation off the oracle"


MAP_CFG = MappingConfig(
    map_corner_capacity=16384,
    map_surf_capacity=32768,
    local_corner_capacity=8192,
    local_surf_capacity=16384,
    stack_corner_capacity=1024,
    stack_surf_capacity=4096,
    knn_tile=2048,
)


def _clouds(world, pos, rng, seed):
    pts = simulate_scan(world, pos, n_azimuth=900, noise=0.005, seed=seed)
    idx = rng.permutation(len(pts))

    def as_cloud(p, cap):
        xyz = np.zeros((cap, 3), np.float32)
        mask = np.zeros(cap, bool)
        n = min(len(p), cap)
        xyz[:n] = p[:n]
        mask[:n] = True
        return PointCloud(xyz=torch.as_tensor(xyz), rel=torch.zeros(cap),
                          mask=torch.as_tensor(mask))

    return as_cloud(pts[idx[:900]], 1024), as_cloud(pts[idx[900:4900]], 4096)


def test_whole_frame_mapping_parity_vs_oracle():
    cfg = MAP_CFG
    world = World.urban(seed=9)
    # close-in structure so one frame constrains all 6 dof
    world.boxes.append(Box(center=np.array([8.0, 8.0, 1.0]),
                           half=np.array([2.0, 2.0, 3.0]), yaw=0.3))
    world.boxes.append(Box(center=np.array([-6.0, -8.0, 0.0]),
                           half=np.array([1.5, 3.0, 2.5]), yaw=-0.4))
    rng = np.random.default_rng(4)

    state = MappingState.init(cfg, "cpu")
    c0, s0 = _clouds(world, np.zeros(3), rng, seed=11)
    state, _ = mapping_step(state, c0, s0, quat.quat_identity(),
                            torch.zeros(3), cfg)

    for k in (1, 2):
        true_t = np.array([0.5 * k, 0.05 * k, 0.0], np.float32)
        c1, s1 = _clouds(world, true_t.astype(np.float64), rng, seed=11 + k)
        q_odom = quat.quat_identity()
        t_odom = torch.as_tensor(true_t + np.float32(0.06))
        new_state, out = mapping_step(state, c1, s1, q_odom, t_odom, cfg)

        # the step's own solve inputs, in float64 for the oracle
        q_w0 = quat.quat_normalize(quat.quat_multiply(state.q_wm, q_odom))
        t_w0 = quat.quat_rotate(state.q_wm, t_odom) + state.t_wm
        corner_store, surf_store, _cen, center = _recenter(state, t_w0, cfg)
        lc_xyz, lc_mask, _ = _gather_local(corner_store, center, cfg,
                                           cfg.local_corner_capacity)
        ls_xyz, ls_mask, _ = _gather_local(surf_store, center, cfg,
                                           cfg.local_surf_capacity)
        sc_xyz, _, sc_mask, _ = voxel_downsample(
            c1.xyz, c1.rel, c1.mask, cfg.line_resolution,
            cfg.stack_corner_capacity)
        ss_xyz, _, ss_mask, _ = voxel_downsample(
            s1.xyz, s1.rel, s1.mask, cfg.plane_resolution,
            cfg.stack_surf_capacity)

        def comp(x, m):
            return x.numpy().astype(np.float64)[m.numpy()]

        o_q, o_t = oracle_mapping_frame(
            comp(lc_xyz, lc_mask), comp(ls_xyz, ls_mask),
            comp(sc_xyz, sc_mask), comp(ss_xyz, ss_mask),
            q_w0.numpy().astype(np.float64), t_w0.numpy().astype(np.float64),
            outer_iterations=cfg.outer_iterations,
            inner_iterations=cfg.inner_iterations,
            knn_gate_sq=cfg.knn_sq_gate, eig_ratio=cfg.line_eig_ratio,
            point_offset=cfg.line_point_offset, plane_gate=cfg.plane_fit_gate,
        )
        k_t = out.t_w.numpy().astype(np.float64)
        k_q = out.q_w.numpy().astype(np.float64)
        assert np.linalg.norm(o_t - true_t) < 0.15, (o_t, true_t)
        dt = np.linalg.norm(k_t - o_t)
        assert dt < 5e-3, f"frame {k}: mapping pose off the oracle by {dt:.5f} m"
        assert _angle(k_q, o_q) < 2e-3, f"frame {k}: rotation off the oracle"
        state = new_state
