"""The fused whole-frame step of the PyTorch port (models/fused.py) against
its own staged pipeline and against the JAX package's fused step.

Mirrors tests/test_fused.py on CPU tensors, where ``fused_frame_step``
runs the body that a card replays as a CUDA graph (the replay itself is
tested on the card, tests/test_torch_cuda.py).  Inputs are the numpy scans
of that file (hdl64-small, 500 azimuth steps, 0.5 m per frame).

Tolerances:

  * fused against staged in the port: 1e-4 m / 1e-5 as in the JAX test;
    on the CPU the two run the same ops on the same values, so they agree
    exactly, the map store selected on the device included;
  * chunked against per-frame fused: exactly (a Python loop over the same
    body; the JAX test needs 3 cm because ``lax.scan`` compiles anew);
  * the port's fused step against ``light_loam_tpu.models.fused.
    fused_frame_step`` from the same carried state: the one-step bands of
    tests/test_torch_odometry.py (1e-3 m / 1e-4 against the jitted
    odometry) and tests/test_torch_mapping.py (1e-2 m / 1e-3, 5 % in factor
    counts, 1 % in map points); over the whole run each mapped position
    within 2 cm, the band of tests/test_torch_pipeline.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.models import fused as jfused
from light_loam_tpu.models.mapping import MappingState as JMappingState
from light_loam_tpu.models.odometry import OdometryState as JOdometryState
from light_loam_tpu.utils.synthetic import World, pad_cloud, simulate_scan
from light_loam_tpu_torch import convert
from light_loam_tpu_torch.models import fused as tfused
from light_loam_tpu_torch.models.mapping import MappingState
from light_loam_tpu_torch.models.odometry import OdometryState
from light_loam_tpu_torch.models.pipeline import PROFILES, Pipeline

torch.set_num_threads(2)

BASE = PROFILES["hdl64-small"]


def _frames(cfg, world, n, step=0.5):
    out = []
    for i in range(n):
        pts = simulate_scan(world, np.array([step * i, 0.0, 0.0]),
                            n_azimuth=500, noise=0.01, seed=100 + i)
        out.append(pad_cloud(pts, cfg.scan.max_points))
    return out


def _init(cfg):
    return (OdometryState.init(cfg.scan.max_less_sharp,
                               cfg.scan.max_less_flat, "cpu"),
            MappingState.init(cfg.mapping, "cpu"))


def _t(a, dtype):
    return torch.as_tensor(a, dtype=dtype)


def test_fused_matches_staged_pipeline():
    frames = _frames(BASE, World.urban(seed=21), 5)
    staged = Pipeline(BASE, device="cpu")
    fused = Pipeline(dataclasses.replace(BASE, fused_step=True), device="cpu")

    for xyz, mask in frames:
        rs = staged.process_frame(xyz, mask)
        rf = fused.process_frame(xyz, mask)
        assert rf.mapped == rs.mapped
        np.testing.assert_allclose(rf.odom_t, rs.odom_t, atol=1e-4)
        np.testing.assert_allclose(rf.odom_q, rs.odom_q, atol=1e-5)
        np.testing.assert_allclose(rf.map_t, rs.map_t, atol=1e-4)
        np.testing.assert_allclose(rf.map_q, rs.map_q, atol=1e-5)

    # shared bookkeeping: trajectory history and keyframe buffers match
    assert len(fused._map_trajectory) == len(staged._map_trajectory)
    np.testing.assert_allclose(
        np.stack(fused._map_trajectory), np.stack(staged._map_trajectory),
        atol=1e-4,
    )
    assert len(fused._keyframes) == len(staged._keyframes)
    assert fused.diverged_frames == staged.diverged_frames == 0
    # the store the fused step selected on the device is the staged one
    for a, b in zip(fused.map_state.surf, staged.map_state.surf):
        assert torch.equal(a, b)
    # one stage in the timers
    report = fused.timers.report()
    assert "fused_step" in report and "odometry" not in report


def test_fused_recenter_frame_selects_the_resorted_store(monkeypatch):
    """The mapping step computes both store merges and selects on the
    device.  A pose that leaves the grid's margin recenters it, and the
    selected store must be the re-sorted one (what map_store_mode="resort"
    returns); a pose inside the margin must select the sorted merge.  With
    the full re-sort made to return an empty store, each frame shows which
    of the two it took."""
    from light_loam_tpu_torch.models import mapping as tmapping

    frames = _frames(BASE, World.urban(seed=21), 2)
    pipe = Pipeline(BASE, device="cpu")
    for xyz, mask in frames:
        pipe.process_frame(xyz, mask)
    odo = pipe.odo_state
    far = torch.tensor([400.0, 0.0, 0.0])  # 8 cubes of 50 m along x

    def step(t, cfg=BASE.mapping):
        return tmapping.mapping_step(pipe.map_state, odo.corner_last,
                                     odo.surf_last, odo.q_w, t, cfg)

    st_far, out_far = step(far)
    st_near, out_near = step(odo.t_w)
    st_resort, _ = step(far, dataclasses.replace(BASE.mapping,
                                                 map_store_mode="resort"))
    assert not torch.equal(st_far.cen, pipe.map_state.cen)
    assert torch.equal(st_near.cen, pipe.map_state.cen)
    for a, b in zip(tfused._leaves(st_far), tfused._leaves(st_resort)):
        assert torch.equal(a, b)
    assert int(out_far.map_surf_points) > 0

    real_full = tmapping._merge_full

    def empty_full(*args):
        store = real_full(*args)
        return store._replace(mask=torch.zeros_like(store.mask))

    monkeypatch.setattr(tmapping, "_merge_full", empty_full)
    _, out_far_empty = step(far)
    st_near_sorted, out_near_sorted = step(odo.t_w)
    assert int(out_far_empty.map_surf_points) == 0
    assert int(out_far_empty.map_corner_points) == 0
    assert int(out_near_sorted.map_surf_points) \
        == int(out_near.map_surf_points) > 0
    for a, b in zip(tfused._leaves(st_near_sorted), tfused._leaves(st_near)):
        assert torch.equal(a, b)


def test_chunked_matches_per_frame_fused():
    frames = _frames(BASE, World.urban(seed=24), 4)
    odo, mp = _init(BASE)
    per_frame_t = []
    for xyz, mask in frames:
        odo, mp, o, mout, div = tfused.fused_frame_step(
            odo, mp, _t(xyz, torch.float32), _t(mask, torch.bool), BASE)
        per_frame_t.append(mout.t_w.numpy())
        assert not bool(div)

    xs = _t(np.stack([f[0] for f in frames]), torch.float32)
    ms = _t(np.stack([f[1] for f in frames]), torch.bool)
    odo2, mp2, outs = tfused.fused_chunk_step(*_init(BASE), xs, ms, BASE)
    assert not outs.diverged.any()
    assert outs.map_t.shape == (4, 3) and outs.odom_q.shape == (4, 4)
    assert outs.map_surf_points.dtype == torch.int32
    np.testing.assert_array_equal(outs.map_t.numpy(), np.stack(per_frame_t))
    # final states agree too (the chunk threads state through its frames)
    for a, b in zip(tfused._leaves((odo2, mp2)), tfused._leaves((odo, mp))):
        assert torch.equal(a, b)

    # run_chunked: 4 frames in chunks of 3 = a full chunk and a tail padded
    # with an empty frame, whose row is trimmed
    _, mp3, host = tfused.run_chunked(iter(frames), BASE, chunk_size=3,
                                      device="cpu")
    assert isinstance(host.map_t, np.ndarray) and host.map_t.shape == (4, 3)
    np.testing.assert_array_equal(host.map_t, np.stack(per_frame_t))
    assert int(mp3.frame) == 6  # the two empty tail frames passed through
    with pytest.raises(ValueError, match="empty"):
        tfused.run_chunked(iter(()), BASE, chunk_size=3, device="cpu")


def test_fused_interleaves_with_staged_on_skip_frames():
    """With skip_frame_num=2, only every other frame maps: those run
    fused, the rest fall back to staged features+odometry.  The two
    paths share OdometryState/MappingState — this gates that the
    interleaved run matches a pure-staged run with the same skip."""
    cfg_skip = dataclasses.replace(
        BASE, odometry=dataclasses.replace(BASE.odometry, skip_frame_num=2))
    frames = _frames(cfg_skip, World.urban(seed=23), 5)

    staged = Pipeline(cfg_skip, device="cpu")
    mixed = Pipeline(dataclasses.replace(cfg_skip, fused_step=True),
                     device="cpu")
    for i, (xyz, mask) in enumerate(frames):
        rs = staged.process_frame(xyz, mask)
        rm = mixed.process_frame(xyz, mask)
        assert rm.mapped == rs.mapped == (i % 2 == 0)
        np.testing.assert_allclose(rm.odom_t, rs.odom_t, atol=1e-4)
        if rs.mapped:
            np.testing.assert_allclose(rm.map_t, rs.map_t, atol=1e-4)
    assert len(mixed._map_trajectory) == len(staged._map_trajectory) == 3
    assert mixed.timers.stages["fused_step"].count == 3
    assert mixed.timers.stages["odometry"].count == 2


def _nan_on_empty(real_step):
    """odometry_step that emits a NaN t_w whenever the scan has no sharp
    points: the injected failure of tests/test_fused.py."""
    def step(state, feats, ocfg, period, **kwargs):
        state2, odo = real_step(state, feats, ocfg, period, **kwargs)
        poison = torch.where(feats.sharp.mask.any(), 0.0, float("nan"))
        state2 = state2._replace(t_w=state2.t_w + poison)
        return state2, odo._replace(t_w=odo.t_w + poison)
    return step


def test_fused_divergence_containment(monkeypatch):
    """A non-finite odometry pose must not poison the world pose: the
    fused step keeps the previous pose, resets the warm start, and
    reports the divergence flag (the staged path's host policy, on the
    device)."""
    cfg = dataclasses.replace(BASE, fused_step=True)
    frames = _frames(cfg, World.urban(seed=22), 3)
    monkeypatch.setattr(tfused, "odometry_step",
                        _nan_on_empty(tfused.odometry_step))

    pipe = Pipeline(cfg, device="cpu")
    for xyz, mask in frames[:2]:
        res = pipe.process_frame(xyz, mask)
        assert np.isfinite(res.odom_t).all()
    pose_before = pipe._last_odo_pose[1].copy()
    assert pipe.diverged_frames == 0

    # empty scan → injected NaN pose → containment must engage
    xyz, mask = frames[2]
    res = pipe.process_frame(xyz, np.zeros_like(mask))
    assert pipe.diverged_frames == 1
    assert np.isfinite(res.odom_t).all()
    np.testing.assert_allclose(res.odom_t, pose_before, atol=1e-5)
    np.testing.assert_array_equal(pipe.odo_state.q_lc.numpy(), [0, 0, 0, 1])
    np.testing.assert_array_equal(pipe.odo_state.t_lc.numpy(), [0, 0, 0])

    # and the pipeline keeps tracking on the next good frame
    res2 = pipe.process_frame(xyz, mask)
    assert np.isfinite(res2.odom_t).all()
    assert pipe.diverged_frames == 1


def test_chunk_internal_divergence_containment(monkeypatch):
    """A diverging frame in the MIDDLE of a chunk must not poison the rest
    of it: the contained frame holds the previous pose, adds nothing to
    the map, and the frames after it keep tracking — exactly like the
    per-frame fused path fed the same corrupted stream."""
    frames = _frames(BASE, World.urban(seed=25), 5)
    frames[2] = (frames[2][0], np.zeros_like(frames[2][1]))
    monkeypatch.setattr(tfused, "odometry_step",
                        _nan_on_empty(tfused.odometry_step))

    odo, mp = _init(BASE)
    ref_map_t, ref_counts = [], []
    for xyz, mask in frames:
        odo, mp, o, mout, div = tfused.fused_frame_step(
            odo, mp, _t(xyz, torch.float32), _t(mask, torch.bool), BASE)
        ref_map_t.append(mout.t_w.numpy())
        ref_counts.append(int(mout.map_corner_points))

    xs = _t(np.stack([f[0] for f in frames]), torch.float32)
    ms = _t(np.stack([f[1] for f in frames]), torch.bool)
    _, _, outs = tfused.fused_chunk_step(*_init(BASE), xs, ms, BASE)

    # exactly the injected frame is flagged, nothing leaks NaN
    np.testing.assert_array_equal(outs.diverged.numpy(),
                                  [False, False, True, False, False])
    assert torch.isfinite(outs.map_t).all()
    assert torch.isfinite(outs.odom_t).all()
    # contained frame holds the previous odometry pose and adds no map
    # points (empty stack: counts frozen at the previous frame's value)
    np.testing.assert_allclose(outs.odom_t[2].numpy(), outs.odom_t[1].numpy(),
                               atol=1e-5)
    counts = outs.map_corner_points.numpy()
    assert counts[2] == counts[1]
    # later frames of the same chunk match the per-frame path exactly
    np.testing.assert_array_equal(outs.map_t.numpy(), np.stack(ref_map_t))
    np.testing.assert_array_equal(counts, ref_counts)
    assert counts[4] > counts[2]  # the map is still alive


# -- against the JAX package's fused step -------------------------------

@pytest.fixture(scope="module")
def jax_fused_run():
    """5 frames through the JAX package's fused_frame_step: per frame the
    states before it (as numpy leaves) and its outputs."""
    frames = _frames(BASE, World.urban(seed=21), 5)
    from light_loam_tpu.models.pipeline import PROFILES as JPROFILES

    jcfg = JPROFILES["hdl64-small"]
    odo = JOdometryState.init(jcfg.scan.max_less_sharp,
                              jcfg.scan.max_less_flat)
    mp = JMappingState.init(jcfg.mapping)
    steps = []
    for xyz, mask in frames:
        before = tuple(jax.tree_util.tree_map(np.asarray, s)._asdict()
                       for s in (odo, mp))
        odo, mp, o, mout, div = jfused.fused_frame_step(
            odo, mp, jnp.asarray(xyz), jnp.asarray(mask), jcfg)
        steps.append((before, jax.tree_util.tree_map(np.asarray, (o, mout)),
                      bool(div)))
    return frames, steps


def test_fused_step_matches_jax_fused_step_from_carried_state(jax_fused_run):
    frames, steps = jax_fused_run
    (odo_np, map_np), (jo, jmout), jdiv = steps[4]
    xyz, mask = frames[4]
    _, new_map, to, tmout, tdiv = tfused.fused_frame_step(
        convert.odometry_state_from_numpy(odo_np),
        convert.mapping_state_from_numpy(map_np),
        _t(xyz, torch.float32), _t(mask, torch.bool), BASE)
    assert bool(tdiv) == jdiv is False
    # odometry: the band against the jitted step
    np.testing.assert_allclose(to.q_w.numpy(), jo.q_w, rtol=0, atol=1e-4)
    np.testing.assert_allclose(to.t_w.numpy(), jo.t_w, rtol=0, atol=1e-3)
    assert abs(int(to.plane_count) - int(jo.plane_count)) <= 2
    assert abs(int(to.corner_count) - int(jo.corner_count)) <= 2
    # mapping: the whole-step band
    np.testing.assert_allclose(tmout.q_w.numpy(), jmout.q_w, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tmout.t_w.numpy(), jmout.t_w, rtol=0, atol=1e-2)
    for name in ("corner_factors", "surf_factors"):
        j = int(getattr(jmout, name))
        assert abs(int(getattr(tmout, name)) - j) <= 0.05 * j, name
    for name in ("map_corner_points", "map_surf_points"):
        j = int(getattr(jmout, name))
        assert abs(int(getattr(tmout, name)) - j) <= 0.01 * j, name
    assert int(new_map.frame) == 5


def test_fused_run_matches_jax_fused_run(jax_fused_run):
    frames, steps = jax_fused_run
    odo, mp = _init(BASE)
    for (xyz, mask), (_, (jo, jmout), _) in zip(frames, steps):
        odo, mp, to, tmout, div = tfused.fused_frame_step(
            odo, mp, _t(xyz, torch.float32), _t(mask, torch.bool), BASE)
        assert not bool(div)
        assert np.linalg.norm(to.t_w.numpy() - jo.t_w) < 0.02
        assert np.linalg.norm(tmout.t_w.numpy() - jmout.t_w) < 0.02
    assert np.linalg.norm(tmout.t_w.numpy() - [2.0, 0.0, 0.0]) < 0.3
