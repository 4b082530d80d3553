"""Pipeline failure containment and keyframe-refinement wiring of the
port, twins of tests/test_pipeline_guards.py on the staged and on the
fused path (CPU tensors: the fused step runs its body eagerly).

Bounds are the JAX tests' own: an all-masked frame keeps the odometry pose
finite and within 2 m of the previous one (``run_chunked`` pads its tail
with such frames), and refined poses stay within 1 m of the mapping poses.
The apply=True recovery twin is tests/test_torch_refine_apply.py.  ~75 s
on two CPU threads (hdl64-small, 500 azimuth steps).
"""

import dataclasses

import numpy as np
import pytest
import torch

from light_loam_tpu_torch.models.pipeline import PROFILES, Pipeline
from light_loam_tpu_torch.utils.synthetic import World, pad_cloud, simulate_scan

torch.set_num_threads(2)

PATHS = {"staged": PROFILES["hdl64-small"],
         "fused": dataclasses.replace(PROFILES["hdl64-small"],
                                      fused_step=True)}


def frames_for(cfg, world, n, step=0.5):
    out = []
    for i in range(n):
        pts = simulate_scan(world, np.array([step * i, 0, 0]), n_azimuth=500,
                            noise=0.01, seed=50 + i)
        out.append(pad_cloud(pts, cfg.scan.max_points))
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_empty_frame_does_not_poison_pose(path):
    cfg = PATHS[path]
    world = World.urban(seed=12)
    pipe = Pipeline(cfg, device="cpu")
    fs = frames_for(cfg, world, 3)
    for f in fs[:2]:
        pipe.process_frame(*f)
    pose_before = pipe.process_frame(*fs[2]).odom_t

    # an (almost) empty frame: all-masked input
    empty = (np.zeros_like(fs[0][0]), np.zeros_like(fs[0][1]))
    r = pipe.process_frame(*empty)
    assert np.isfinite(r.odom_t).all()
    # pose must not have jumped wildly
    assert np.linalg.norm(r.odom_t - pose_before) < 2.0

    # recovery: a real frame afterwards still produces finite poses
    r2 = pipe.process_frame(*fs[2])
    assert np.isfinite(r2.odom_t).all()
    if r2.mapped:
        assert np.isfinite(r2.map_t).all()


@pytest.mark.parametrize("path", sorted(PATHS))
def test_keyframe_refinement_wiring(path):
    cfg = PATHS[path]
    world = World.urban(seed=13)
    pipe = Pipeline(cfg, device="cpu")
    for f in frames_for(cfg, world, 4):
        pipe.process_frame(*f)
    out = pipe.refine_recent_keyframes(n_keyframes=4, n_iterations=2,
                                       n_landmarks=256)
    assert out is not None
    q, t = out
    assert q.shape[1] == 4 and t.shape[1] == 3
    assert np.isfinite(t).all()
    # refined poses stay near the mapping poses (no divergence)
    kf_t = np.stack([k[1] for k in pipe._keyframes[-len(t):]])
    assert np.linalg.norm(t - kf_t, axis=1).max() < 1.0
    # apply=False leaves the pipeline as it was
    np.testing.assert_array_equal(pipe.mapped_positions()[-len(t):], kf_t)


def test_refinement_needs_two_keyframes():
    pipe = Pipeline(PROFILES["hdl64-small"], device="cpu")
    assert pipe.refine_recent_keyframes() is None
