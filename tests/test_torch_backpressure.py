"""Back-pressure (frame-drop) path of the port's Pipeline, twins of
tests/test_backpressure.py.

With ``sync_mapping=False`` a frame whose mapping step is still in flight
is dropped for mapping while odometry continues (laserMapping.cpp:
1571-1575).  On a card, "in flight" is a CUDA event that has not completed
(``Pipeline._mapping_busy``); CPU steps retire at once, so the tests wrap
``mapping_step`` where the staged path calls it (models/stages.py) to
record each dispatch and patch ``_mapping_busy`` to report a step busy
until the test releases it, as the JAX test holds its proxy's
``is_ready()`` false.  The stage hands the Pipeline copies of the step's
outputs, so the pending step is known by its place in the dispatch order:
it is always the last one dispatched.  The drop/retire bookkeeping is the subject;
the trajectory rows are compared exactly (atol 0).  ~70 s on two CPU
threads (hdl64-small, 500 azimuth steps; the wait test runs 4 frames
where the JAX test runs 6).
"""

import dataclasses

import numpy as np
import torch

from light_loam_tpu_torch.models import stages
from light_loam_tpu_torch.models.pipeline import PROFILES, Pipeline
from light_loam_tpu_torch.utils.synthetic import World, pad_cloud, simulate_scan

torch.set_num_threads(2)


class _SlowSteps:
    """Records every dispatched mapping step; a step stays busy until
    ``release()`` (the event of a step still running on the card)."""

    def __init__(self, monkeypatch):
        self.real_step = stages.mapping_step
        self.released = 0
        self.dispatched = []
        monkeypatch.setattr(stages, "mapping_step", self.step)
        monkeypatch.setattr(Pipeline, "_mapping_busy",
                            lambda pipe: self.busy(pipe))

    def step(self, *args, **kwargs):
        state, out = self.real_step(*args, **kwargs)
        self.dispatched.append(out)
        return state, out

    def busy(self, pipe) -> bool:
        return (pipe._pending_map_out is not None
                and len(self.dispatched) > self.released)

    def release(self):
        self.released = len(self.dispatched)


def _frame(world, cfg, i, seed0):
    pts = simulate_scan(world, np.array([0.5 * i, 0, 0]), n_azimuth=500,
                        noise=0.01, seed=seed0 + i)
    return pad_cloud(pts, cfg.scan.max_points)


def test_slow_mapping_drops_frames_and_keeps_trajectory_exact(monkeypatch):
    cfg = dataclasses.replace(PROFILES["hdl64-small"], sync_mapping=False)
    world = World.urban(seed=17)
    slow = _SlowSteps(monkeypatch)

    pipe = Pipeline(cfg, device="cpu")
    n_frames = 9
    for i in range(n_frames):
        if i > 0 and i % 3 == 0:
            # the in-flight step finishes every third frame; the two
            # frames in between arrive while mapping is busy
            slow.release()
        pipe.process_frame(*_frame(world, cfg, i, 70))

    # frames arriving while mapping is busy are dropped, not queued
    assert pipe.dropped_mapping_frames > 0
    n_mapped = len(slow.dispatched)
    assert n_mapped < n_frames
    assert pipe.dropped_mapping_frames == n_frames - n_mapped

    # the mapped trajectory is exactly the retired steps' own poses, in
    # order, and mapped_positions() flushes the in-flight step
    slow.release()
    traj = pipe.mapped_positions()
    dispatched = np.stack([o.t_w.numpy() for o in slow.dispatched])
    assert traj.shape == (n_mapped, 3)
    np.testing.assert_allclose(traj, dispatched, atol=0)

    qs, ts = pipe.mapped_trajectory()
    assert len(qs) == n_mapped and len(ts) == n_mapped
    np.testing.assert_allclose(ts, traj, atol=0)

    # odometry kept running across the drops
    assert pipe.frame == n_frames
    assert pipe.diverged_frames == 0

    # keyframes buffer at retirement: each carries the retired step's own
    # mapped pose and a unique trajectory row
    assert len(pipe._keyframes) == n_mapped
    idxs = [kf[4] for kf in pipe._keyframes]
    assert idxs == list(range(n_mapped)), idxs
    for kf in pipe._keyframes:
        np.testing.assert_allclose(kf[1], traj[kf[4]], atol=0)
        assert np.isfinite(kf[5]).all() and np.isfinite(kf[6]).all()


def test_sync_mode_never_drops():
    cfg = PROFILES["hdl64-small"]  # sync_mapping=True default
    world = World.urban(seed=18)
    pipe = Pipeline(cfg, device="cpu")
    for i in range(4):
        assert pipe.process_frame(*_frame(world, cfg, i, 80)).mapped
    assert pipe.dropped_mapping_frames == 0
    assert pipe.mapped_positions().shape == (4, 3)


def test_async_no_drop_waits_instead(monkeypatch):
    """drop_mapping_backlog=False turns the drop policy into waiting for
    retirement: no frame is shed even while every step looks busy."""
    cfg = dataclasses.replace(PROFILES["hdl64-small"], sync_mapping=False,
                              drop_mapping_backlog=False)
    world = World.urban(seed=17)
    slow = _SlowSteps(monkeypatch)

    pipe = Pipeline(cfg, device="cpu")
    n_frames = 4
    for i in range(n_frames):
        # never released: under the drop policy every dispatch would look
        # busy, so this proves the wait path
        pipe.process_frame(*_frame(world, cfg, i, 70))
    pipe._retire_mapping(wait=True)

    assert pipe.dropped_mapping_frames == 0
    assert len(slow.dispatched) == n_frames
    assert pipe.mapped_positions().shape == (n_frames, 3)
