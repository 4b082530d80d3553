"""Closing the refinement loop in the port's Pipeline, the twin of
tests/test_pipeline_guards.py::test_refinement_apply_recovers_corrupted_keyframes
on the staged and on the fused path.

apply=True rewrites the stored trajectory with the refined poses:
keyframes corrupted after the fact are pulled back toward their clean
poses by refining against the map's landmarks (the JAX test's bounds: the
total error shrinks below 0.8 of the corruption's, z almost fully, x and y
at least do not degrade), and the pipeline continues from the re-anchored
odom→map correction: the next frame is mapped, finite and within 1.5 m of
the newest refined position.  On the staged path that next frame is staged
and the one after it fused (a fused step copies the re-anchored state into
its own buffers); on the fused path it is fused.  ~70 s on two CPU threads
(hdl64-small, 500 azimuth steps).
"""

import dataclasses

import numpy as np
import pytest
import torch

from light_loam_tpu_torch.models.pipeline import PROFILES, Pipeline
from light_loam_tpu_torch.utils.synthetic import World
from test_torch_pipeline_guards import frames_for

torch.set_num_threads(2)

SMALL = PROFILES["hdl64-small"]
FUSED = dataclasses.replace(SMALL, fused_step=True)


def corrupt_window(pipe, K, rng):
    """Shift the newest K - 1 keyframes (window keyframe 0 stays clean) and
    their trajectory rows by up to 12 cm per axis; returns the rows."""
    base = len(pipe._keyframes) - (K - 1)
    rows = []
    for i in range(K - 1):
        kf = pipe._keyframes[base + i]
        t_bad = (kf[1] + rng.uniform(-0.12, 0.12, 3)).astype(np.float32)
        pipe._keyframes[base + i] = (kf[0], t_bad, *kf[2:])
        pipe._map_trajectory[kf[4]] = t_bad
        rows.append(kf[4])
    return rows


def recovery_errors(clean, corrupt, refined, rows):
    """Mean |error| per axis of the corrupted rows, before and after."""
    return (np.abs(corrupt[rows] - clean[rows]).mean(axis=0),
            np.abs(refined[rows] - clean[rows]).mean(axis=0))


def assert_recovered(err_c, err_r):
    assert err_r.sum() < 0.8 * err_c.sum(), (err_r, err_c)
    # z is observable through the ground-dominated landmark set; x and y
    # only weakly through near-horizontal planes, so they must not degrade
    assert err_r[2] < 0.2 * err_c[2], (err_r[2], err_c[2])
    assert err_r[0] < err_c[0] * 1.3 + 0.01
    assert err_r[1] < err_c[1] * 1.3 + 0.01


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_refinement_apply_recovers_corrupted_keyframes(path):
    cfg = FUSED if path == "fused" else SMALL
    world = World.urban(seed=19)
    pipe = Pipeline(cfg, device="cpu")
    frames = frames_for(cfg, world, 8)
    for f in frames[:6]:
        pipe.process_frame(*f)
    clean_traj = pipe.mapped_positions().copy()

    K = 4
    rows = corrupt_window(pipe, K, np.random.default_rng(0))
    corrupt_traj = pipe.mapped_positions().copy()

    out = pipe.refine_recent_keyframes(n_keyframes=K, n_iterations=4,
                                       n_landmarks=256, apply=True)
    assert out is not None
    q, t = out
    refined_traj = pipe.mapped_positions()
    np.testing.assert_array_equal(refined_traj[-K:], t)
    np.testing.assert_array_equal(pipe.mapped_trajectory()[0][-K:], q)
    assert_recovered(*recovery_errors(clean_traj, corrupt_traj,
                                      refined_traj, rows))

    # continuity from the re-anchored correction
    r = pipe.process_frame(*frames[6])
    assert r.mapped and np.isfinite(r.map_t).all()
    assert np.linalg.norm(r.map_t - refined_traj[-1]) < 1.5
    if path == "staged":
        pipe.cfg = FUSED  # the next frame as one fused step
        r2 = pipe.process_frame(*frames[7])
        assert r2.mapped and np.isfinite(r2.map_t).all()
        assert np.linalg.norm(r2.map_t - r.map_t) < 1.5
