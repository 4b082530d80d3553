"""The batched lanes of the PyTorch port (models/batch.py) against the
port's own single-lane steps and against the JAX package's batched step.

Mirrors tests/test_batch.py on CPU tensors, at its configuration (16 rings,
8192 points, 2 × 3 LM iterations, B = 3 lanes of distinct geometry, 4
frames).  On the CPU ``batched_frame_step`` runs ``torch.vmap`` of the
single-lane body, with the kernels' vmap rules running the plain versions
per lane; the card replays the same body as a CUDA graph
(tests/test_torch_cuda.py).

Tolerances:

  * each lane against the port's own ``odometry_step`` / ``mapping_step``
    run on that lane alone, one step from the lane's carried state: 1e-5 m
    (the same ops on the same values; vmap only changes how a contraction
    is blocked: measured 3.9e-7 m on an odometry step and 1.2e-7 m on a
    mapping step).  The mapping step is fed the batched run's own odometry
    of the lane (pose, corner_last, surf_last): from the unbatched
    odometry's, ~1e-8 m apart, one mapping step can end mm apart, since a
    plane set or a line gate decided otherwise in the first outer
    iteration moves the second's 5-NN sets.  The file runs on one CPU
    thread: with two, the batched and the unbatched GEMM of the normal
    equations split their sums differently, and one mapping step of three
    identical lanes moved 1.3e-5 m from the single lane's; over frames
    such differences grow through the gates to mm, as in
    tests/test_batch.py;
  * against ``light_loam_tpu.models.batch.batched_frame_step``, its planes
    fit by tests/oracle.py's float64 least squares (tests/oracle_planes.py;
    the package's own float32 adjugate decides the plane gate by rounding
    tens of metres out and moved a step 1.6 cm from the port's): the bands
    of tests/test_torch_fused.py, from the JAX package's carried state 1e-3
    m / 1e-4 for odometry and 1e-2 m / 1e-3 for mapping per step (jitted
    XLA contracts multiply-adds, tests/test_torch_odometry.py), and over
    the whole run every position within 2 cm;
  * ``batched_chunk_step`` against per-frame batched steps: exactly (on the
    CPU both are the same body in a loop).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu import config as jconfig
from light_loam_tpu.models import batch as jbatch
from light_loam_tpu.utils.synthetic import World, pad_cloud, simulate_scan
from oracle_planes import oracle_planes
from light_loam_tpu_torch import config as tconfig
from light_loam_tpu_torch import convert
from light_loam_tpu_torch.models import batch as tbatch
from light_loam_tpu_torch.models.fused import _leaves
from light_loam_tpu_torch.models.mapping import mapping_step
from light_loam_tpu_torch.models.odometry import odometry_step
from light_loam_tpu_torch.ops.features import extract_features

torch.set_num_threads(2)


def _cfg(c):
    """tests/test_batch.py's configuration, from either package."""
    return c.PipelineConfig(
        scan=c.ScanConfig(n_scans=16, h_max=512, max_points=8192),
        odometry=c.OdometryConfig(outer_iterations=2, inner_iterations=3),
        mapping=c.MappingConfig(
            map_corner_capacity=2048, map_surf_capacity=4096,
            local_corner_capacity=2048, local_surf_capacity=4096,
            stack_corner_capacity=512, stack_surf_capacity=1024,
            knn_tile=512,
        ),
    )


CFG, JCFG = _cfg(tconfig), _cfg(jconfig)
B, N_FRAMES = 3, 4


def lane_frames():
    """(xs (K, B, N, 3), ms (K, B, N)) numpy: tests/test_batch.py's lanes,
    each at its own lateral offset."""
    world = World.urban(seed=6)
    xs, ms = [], []
    for i in range(N_FRAMES):
        frame = [pad_cloud(simulate_scan(
            world, np.array([0.5 * i, 0.6 * b - 0.6, 0.0]), n_rings=16,
            lower_deg=-15.0, upper_deg=15.0, n_azimuth=450, noise=0.01,
            seed=31 * b + i), CFG.scan.max_points) for b in range(B)]
        xs.append(np.stack([f[0] for f in frame]))
        ms.append(np.stack([f[1] for f in frame]))
    return np.stack(xs), np.stack(ms)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lanes():
    return lane_frames()


def _t(a, dtype):
    return torch.as_tensor(a, dtype=dtype)


def _outputs(odo, mout):
    return tuple(t.numpy().copy() for t in (odo.q_w, odo.t_w, mout.q_w,
                                            mout.t_w))


@pytest.fixture(scope="module")
def port_run(lanes):
    """The port's batched run: per frame (odom_q, odom_t, map_q, map_t),
    each (B, ...), the states before each frame and the final state."""
    xs, ms = lanes
    state = tbatch.init_batch_state(CFG, B, device="cpu")
    rows, before = [], []
    for x, m in zip(xs, ms):
        before.append(state)
        state, odo, mout = tbatch.batched_frame_step(
            state, _t(x, torch.float32), _t(m, torch.bool), CFG)
        rows.append(_outputs(odo, mout))
    return rows, before, state


@pytest.fixture(scope="module")
def jax_run(lanes):
    """The JAX package's batched run, its planes fit by tests/oracle.py's
    float64 least squares (tests/oracle_planes.py): per frame the state
    before it (numpy leaves) and (odom_q, odom_t, map_q, map_t)."""
    xs, ms = lanes
    state = jbatch.init_batch_state(JCFG, B)
    steps = []
    with oracle_planes():
        for x, m in zip(xs, ms):
            before = tuple(jax.tree_util.tree_map(np.asarray, s)._asdict()
                           for s in (state.odometry, state.mapping))
            state, odo, mout = jbatch.batched_frame_step(
                state, jnp.asarray(x), jnp.asarray(m), JCFG)
            steps.append((before, tuple(np.asarray(a) for a in (
                odo.q_w, odo.t_w, mout.q_w, mout.t_w))))
    return steps


def _lane(tree, b):
    if isinstance(tree, torch.Tensor):
        return tree[b]
    return type(tree)(*(_lane(part, b) for part in tree))


def test_batched_lanes_match_single_lane_steps(lanes, port_run):
    xs, ms = lanes
    rows, before, state = port_run
    after = before[1:] + [state]
    for k in range(N_FRAMES):
        for b in range(B):
            feats = extract_features(_t(xs[k, b], torch.float32),
                                     _t(ms[k, b], torch.bool), CFG.scan)
            _, odo = odometry_step(
                _lane(before[k].odometry, b), feats, CFG.odometry,
                CFG.scan.scan_period, read_live_count=False)
            # the mapping step from the batched run's own odometry of the
            # lane, so that both sides map the same inputs
            odo_state = _lane(after[k].odometry, b)
            _, mout = mapping_step(
                _lane(before[k].mapping, b), odo_state.corner_last,
                odo_state.surf_last, torch.as_tensor(rows[k][0][b]),
                torch.as_tensor(rows[k][1][b]), CFG.mapping)
            for got, want in zip(rows[k], _outputs(odo, mout)):
                np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5)
    assert state.mapping.frame.tolist() == [N_FRAMES] * B
    # the lanes moved, apart: the comparison is not 0 == 0
    map_t = rows[-1][3]
    assert np.linalg.norm(map_t, axis=1).min() > 0.5
    assert np.abs(map_t[0] - map_t[1]).max() > 1e-3


def test_batched_step_matches_jax_from_carried_state(lanes, jax_run):
    xs, ms = lanes
    for k, ((odo_np, map_np), (jq, jt, jmq, jmt)) in enumerate(jax_run):
        state = tbatch.BatchState(
            convert.odometry_state_from_numpy(odo_np),
            convert.mapping_state_from_numpy(map_np))
        _, odo, mout = tbatch.batched_frame_step(
            state, _t(xs[k], torch.float32), _t(ms[k], torch.bool), CFG)
        np.testing.assert_allclose(odo.q_w.numpy(), jq, rtol=0, atol=1e-4)
        np.testing.assert_allclose(odo.t_w.numpy(), jt, rtol=0, atol=1e-3)
        np.testing.assert_allclose(mout.q_w.numpy(), jmq, rtol=0, atol=1e-3)
        np.testing.assert_allclose(mout.t_w.numpy(), jmt, rtol=0, atol=1e-2)


def test_batched_run_matches_jax_run(port_run, jax_run):
    rows, _, _ = port_run
    for (_, odo_t, _, map_t), (_, (_, jt, _, jmt)) in zip(rows, jax_run):
        assert np.linalg.norm(odo_t - jt, axis=1).max() < 0.02
        assert np.linalg.norm(map_t - jmt, axis=1).max() < 0.02


def test_batched_chunk_matches_per_frame_batched(lanes, port_run):
    xs, ms = lanes
    rows, _, state = port_run
    state2, outs = tbatch.batched_chunk_step(
        tbatch.init_batch_state(CFG, B, device="cpu"),
        _t(xs, torch.float32), _t(ms, torch.bool), CFG)
    for got, want in zip(outs, zip(*rows)):
        assert got.shape[:2] == (N_FRAMES, B)
        np.testing.assert_array_equal(got.numpy(), np.stack(want))
    for a, b in zip(_leaves(state2), _leaves(state)):
        assert torch.equal(a, b)


def test_batched_body_runs_no_op_lane_by_lane(lanes):
    """Every op of the body has a batching rule: none falls back to
    PyTorch's per-lane loop, which warns "There is a performance drop
    because we have not yet implemented the batching rule"."""
    xs, ms = lanes
    state = tbatch.init_batch_state(CFG, B, device="cpu")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        for k in range(2):
            state, _, mout = tbatch.batched_frame_step(
                state, _t(xs[k], torch.float32), _t(ms[k], torch.bool), CFG)
    assert mout.t_w.shape == (B, 3) and torch.isfinite(mout.t_w).all()

