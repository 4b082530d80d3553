"""Lane-sharded batches (parallel/batch_sharded.py): twins of
tests/test_batch_sharded.py with B = 4 lanes over 2 ranks (spawned CPU
processes joined by gloo, tests/torch_ranks.py), against the port's
unsharded batched step on the same frames.

Lanes never interact and each rank runs the same per-lane body, so the
tolerances are the JAX test's: frame step odometry t_w 1e-5, mapping t_w
1e-4, surf factors equal; chunk step 1e-4 / 1e-4 and mapping q_w 1e-3.
~40 s on the CPU.
"""

import numpy as np
import pytest
import torch

from light_loam_tpu_torch.config import (
    MappingConfig,
    OdometryConfig,
    PipelineConfig,
    ScanConfig,
)
from light_loam_tpu_torch.models.batch import (
    batched_chunk_step,
    batched_frame_step,
    init_batch_state,
)
from light_loam_tpu_torch.parallel.batch_sharded import (
    gather_lanes,
    init_sharded_batch_state,
    put_chunk_frames,
    put_frames,
    sharded_batched_chunk_step,
    sharded_batched_frame_step,
)
from light_loam_tpu_torch.parallel.sharded import ShardGroup
from light_loam_tpu_torch.utils.synthetic import World, pad_cloud, simulate_scan
from torch_ranks import run_ranks

torch.set_num_threads(2)

# tests/test_batch_sharded.py's CFG
CFG = PipelineConfig(
    scan=ScanConfig(n_scans=16, h_max=256, max_points=4096),
    odometry=OdometryConfig(outer_iterations=2, inner_iterations=2),
    mapping=MappingConfig(
        map_corner_capacity=2048, map_surf_capacity=4096,
        local_corner_capacity=2048, local_surf_capacity=4096,
        stack_corner_capacity=512, stack_surf_capacity=1024,
        knn_tile=512,
    ),
)
B, K, WORLD = 4, 3, 2


def _frames(batch, n_frames):
    """tests/test_batch_sharded.py's frames: (K, B, P, 3), (K, B, P)."""
    world = World.urban(seed=4, n_boxes=6, n_poles=4)
    xs, ms = [], []
    for i in range(n_frames):
        lanes = [pad_cloud(simulate_scan(
            world, np.array([0.4 * i, 0.1 * b, 0.0]), n_rings=16,
            lower_deg=-15.0, upper_deg=15.0, n_azimuth=180, noise=0.01,
            seed=100 * b + i), CFG.scan.max_points) for b in range(batch)]
        xs.append(np.stack([x for x, _ in lanes]))
        ms.append(np.stack([m for _, m in lanes]))
    return np.stack(xs), np.stack(ms)


def _frame_rank(group, xyz, mask):
    state = init_sharded_batch_state(CFG, B, group)
    for x, m in zip(xyz, mask):
        dx, dm = put_frames(x, m, group)
        assert dx.shape[0] == B // group.size
        state, odo, mout = sharded_batched_frame_step(state, dx, dm, CFG)
    return {name: gather_lanes(v, group).numpy() for name, v in (
        ("odo_t", odo.t_w), ("map_t", mout.t_w),
        ("surf_factors", mout.surf_factors))}


def _chunk_rank(group, xyz, mask):
    state = init_sharded_batch_state(CFG, B, group)
    dx, dm = put_chunk_frames(xyz, mask, group)
    state, rows = sharded_batched_chunk_step(state, dx, dm, CFG)
    return [gather_lanes(r, group, dim=1).numpy() for r in rows]


@pytest.fixture(scope="module")
def frames():
    return _frames(B, K)


def test_sharded_batch_matches_unsharded(frames, tmp_path):
    xyz, mask = frames
    state = init_batch_state(CFG, B, device="cpu")
    for x, m in zip(xyz, mask):
        state, odo, mout = batched_frame_step(
            state, torch.from_numpy(x), torch.from_numpy(m), CFG)
    ranks = run_ranks(_frame_rank, WORLD, tmp_path, xyz, mask)
    for got in ranks:
        np.testing.assert_allclose(got["odo_t"], odo.t_w.numpy(), atol=1e-5)
        np.testing.assert_allclose(got["map_t"], mout.t_w.numpy(), atol=1e-4)
        np.testing.assert_array_equal(got["surf_factors"],
                                      mout.surf_factors.numpy())
    t = ranks[0]["map_t"]
    assert np.isfinite(t).all() and t.shape == (B, 3)
    # every lane produced its own pose
    assert len(np.unique(t[:, 1].round(4))) > 1


def test_sharded_chunk_matches_unsharded(frames, tmp_path):
    xyz, mask = frames
    state = init_batch_state(CFG, B, device="cpu")
    _, (rq_o, rt_o, rq_m, rt_m) = batched_chunk_step(
        state, torch.from_numpy(xyz), torch.from_numpy(mask), CFG)
    for sq_o, st_o, sq_m, st_m in run_ranks(_chunk_rank, WORLD, tmp_path,
                                            xyz, mask):
        assert st_m.shape == (K, B, 3)
        np.testing.assert_allclose(st_o, rt_o.numpy(), atol=1e-4)
        np.testing.assert_allclose(st_m, rt_m.numpy(), atol=1e-4)
        np.testing.assert_allclose(sq_m, rq_m.numpy(), atol=1e-3)
        assert np.isfinite(st_m).all()


def test_lanes_must_divide_evenly():
    group = ShardGroup(0, 3, "cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        init_sharded_batch_state(CFG, B, group)
    with pytest.raises(ValueError, match="divide evenly"):
        put_frames(np.zeros((B, 8, 3), np.float32), np.zeros((B, 8), bool),
                   group)
    # rank 1 of 2 holds lanes 2 and 3, on its device
    x, m = put_frames(np.arange(B * 6, dtype=np.float32).reshape(B, 2, 3),
                      np.ones((B, 2), bool), ShardGroup(1, 2, "cpu"))
    assert x.shape == (2, 2, 3) and float(x[0, 0, 0]) == 12.0
