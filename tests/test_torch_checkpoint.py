"""Checkpoint / resume of the PyTorch port, the map accessors and the PLY
export.

Mirrors tests/test_checkpoint_compat.py (3 tests), ``test_checkpoint_
roundtrip``, ``test_ply_export``, ``test_rslidar_quat_remap_is_unit`` and
``test_map_output_accessors`` of tests/test_aux.py and ``test_checkpoint_
resume_continuity`` of tests/test_kitti_e2e.py, and adds the two loads
across the packages: both write one ``.npz`` layout (utils/checkpoint.py),
so a snapshot of either loads in the other.

Tolerances: a resume within one package replays the same ops on the same
values (atol 1e-5, as in the JAX test).  After a load across the packages
the next frame is held to the one-step bands of tests/test_torch_odometry.py
(1e-3 m / 1e-4 against the jitted odometry step) and
tests/test_torch_mapping.py (1e-2 m / 1e-3 for the mapping step), the
JAX package's planes fit by tests/oracle.py's float64 least squares
(tests/oracle_planes.py).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.models import mapping as jmapping
from light_loam_tpu.models import pipeline as jpl
from light_loam_tpu.utils import export as jexport
from light_loam_tpu.utils.synthetic import World, pad_cloud, simulate_scan
from oracle_planes import oracle_planes
from light_loam_tpu_torch.config import MappingConfig
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.models import mapping as tmapping
from light_loam_tpu_torch.models import pipeline as tpl
from light_loam_tpu_torch.models.fused import _leaves
from light_loam_tpu_torch.models.mapping import MappingState
from light_loam_tpu_torch.models.odometry import OdometryState
from light_loam_tpu_torch.utils.checkpoint import load_state, save_state
from light_loam_tpu_torch.utils.export import write_ply, write_trajectory_ply

torch.set_num_threads(2)

CFG = tpl.PROFILES["hdl64-small"]
JCFG = jpl.PROFILES["hdl64-small"]


def _frame(i, seed0=40, world_seed=21):
    pts = simulate_scan(World.urban(seed=world_seed),
                        np.array([0.4 * i, 0, 0]), n_azimuth=500, noise=0.01,
                        seed=seed0 + i)
    return pad_cloud(pts, CFG.scan.max_points)


def _run_and_save(tmp_path, n_frames=2):
    pipe = tpl.Pipeline(CFG, device="cpu")
    for i in range(n_frames):
        pipe.process_frame(*_frame(i))
    ckpt = str(tmp_path / "full.npz")
    pipe.save(ckpt)
    return pipe, ckpt


def _resave_without(src, dst, drop_keys):
    data = np.load(src)
    kept = {k: data[k] for k in data.files if k not in drop_keys}
    np.savez(dst, **kept)


def test_missing_trailing_leaf_falls_back_to_template(tmp_path):
    """A snapshot taken before a field was appended to MappingState loads:
    the missing TRAILING leaf takes the fresh-pipeline (init) value and
    everything else restores exactly."""
    pipe, ckpt = _run_and_save(tmp_path)
    data = np.load(ckpt)
    map_idx = sorted(
        int(m.group(1)) for k in data.files
        if (m := re.fullmatch(r"map__(\d+)", k))
    )
    assert map_idx == list(range(len(_leaves(pipe.map_state))))
    legacy = str(tmp_path / "legacy.npz")
    _resave_without(ckpt, legacy, {f"map__{map_idx[-1]}"})

    fresh = tpl.Pipeline(CFG, device="cpu")
    template_leaf = _leaves(fresh.map_state)[-1].clone()
    assert int(_leaves(pipe.map_state)[-1]) == 2  # the saved value differs
    fresh.load(legacy)
    leaves = _leaves(fresh.map_state)
    assert torch.equal(leaves[-1], template_leaf)
    # earlier leaves restored from the snapshot, not the template
    assert torch.equal(leaves[0], _leaves(pipe.map_state)[0])
    assert leaves[0].abs().sum() > 0
    # and the restored pipeline still steps
    r = fresh.process_frame(*_frame(2))
    assert np.isfinite(r.odom_t).all()


def test_missing_middle_leaf_fails_loudly(tmp_path):
    """A gap that is NOT a trailing suffix means the field order changed —
    positional assignment would silently scramble state, so it must raise."""
    _, ckpt = _run_and_save(tmp_path)
    broken = str(tmp_path / "broken.npz")
    _resave_without(ckpt, broken, {"map__0"})
    pipe = tpl.Pipeline(CFG, device="cpu")
    with pytest.raises(ValueError, match="non-trailing"):
        pipe.load(broken)


def test_legacy_checkpoint_without_map_quats(tmp_path):
    """Snapshots written before map_quats existed restore with identity
    rotations so the quat/position histories stay in lockstep; one written
    before the containment poses restores them from the states."""
    pipe, ckpt = _run_and_save(tmp_path)
    legacy = str(tmp_path / "noquats.npz")
    _resave_without(ckpt, legacy, {
        "extra__map_quats", "extra__last_odo_q", "extra__last_odo_t",
        "extra__last_map_q", "extra__last_map_t"})

    fresh = tpl.Pipeline(CFG, device="cpu")
    fresh.load(legacy)
    qs, ts = fresh.mapped_trajectory()
    assert len(qs) == len(ts) == len(pipe.mapped_positions())
    # xyzw layout: identity is [0,0,0,1]
    np.testing.assert_allclose(
        qs, np.tile([0.0, 0, 0, 1.0], (len(ts), 1)), atol=0
    )
    for got, want in zip(fresh._last_odo_pose + fresh._last_map_pose,
                         pipe._last_odo_pose + pipe._last_map_pose):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6)
    # re-saving the restored pipeline round-trips
    fresh.save(str(tmp_path / "resave.npz"))


def test_checkpoint_roundtrip(tmp_path):
    mc = MappingConfig(map_corner_capacity=1024, map_surf_capacity=2048)
    odo = OdometryState.init(256, 512, "cpu")
    odo = odo._replace(t_w=torch.tensor([1.0, 2.0, 3.0]),
                       frame=torch.tensor(7, dtype=torch.int32))
    mp = MappingState.init(mc, "cpu")
    mp = mp._replace(t_wm=torch.tensor([0.1, 0.2, 0.3]))

    path = str(tmp_path / "ckpt.npz")
    save_state(path, odo, mp, frame=7, extra={"note": 42})
    odo2, mp2, frame, extra = load_state(
        path, OdometryState.init(256, 512, "cpu"), MappingState.init(mc, "cpu")
    )
    assert frame == 7
    assert int(extra["note"]) == 42
    np.testing.assert_allclose(odo2.t_w.numpy(), [1, 2, 3])
    np.testing.assert_allclose(mp2.t_wm.numpy(), [0.1, 0.2, 0.3])
    assert int(odo2.frame) == 7
    for a, b in zip(_leaves((odo2, mp2)), _leaves((odo, mp))):
        assert a.dtype == b.dtype and torch.equal(a, b)

    # shape mismatch must be detected
    with pytest.raises(ValueError, match="shape mismatch"):
        load_state(path, OdometryState.init(128, 512, "cpu"),
                   MappingState.init(mc, "cpu"))


def test_checkpoint_layout_is_the_jax_packages(tmp_path):
    """Key for key, dtype for dtype and shape for shape the file a fresh
    JAX pipeline writes (the treedef text apart, which no reader reads)."""
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tpl.Pipeline(CFG, device="cpu").save(tpath)
    jpl.Pipeline(JCFG).save(jpath)
    t, j = np.load(tpath), np.load(jpath)
    assert sorted(t.files) == sorted(j.files)
    for k in t.files:
        if k.endswith("__treedef"):
            assert t[k].dtype == np.uint8 and "corner" in bytes(t[k]).decode()
            continue
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k])


def test_checkpoint_resume_continuity(tmp_path):
    """Resuming from a snapshot must reproduce the uninterrupted run."""
    def frame(i):
        return _frame(i, seed0=0, world_seed=8)

    a = tpl.Pipeline(CFG, device="cpu")
    for i in range(3):
        a.process_frame(*frame(i))
    ckpt = str(tmp_path / "mid.npz")
    a.save(ckpt)
    ra3 = a.process_frame(*frame(3))

    b = tpl.Pipeline(CFG, device="cpu")
    b.load(ckpt)
    assert b.frame == 3
    rb3 = b.process_frame(*frame(3))
    np.testing.assert_allclose(rb3.odom_t, ra3.odom_t, atol=1e-5)
    np.testing.assert_allclose(rb3.odom_q, ra3.odom_q, atol=1e-5)
    np.testing.assert_allclose(rb3.map_t, ra3.map_t, atol=1e-5)
    # mapped-pose history survives the snapshot (viz/trajectory parity)
    ta, tb = a.mapped_positions(), b.mapped_positions()
    assert len(tb) == len(ta)
    np.testing.assert_allclose(tb, ta, atol=1e-5)


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    """3 frames through each package's pipeline, each saved; then frame 3
    through each.  The JAX package fits its planes by tests/oracle.py's
    float64 least squares (tests/oracle_planes.py) in these runs and in the
    run from the port's file: its own float32 adjugate decides the plane gate by
    rounding tens of metres out and moved the next frame 1.7 cm."""
    tmp = tmp_path_factory.mktemp("cross")
    frames = [_frame(i, seed0=0, world_seed=8) for i in range(4)]
    t, j = tpl.Pipeline(CFG, device="cpu"), jpl.Pipeline(JCFG)
    with oracle_planes():
        for xyz, mask in frames[:3]:
            t.process_frame(xyz, mask)
            j.process_frame(xyz, mask)
        paths = {"torch": str(tmp / "torch.npz"), "jax": str(tmp / "jax.npz")}
        t.save(paths["torch"])
        j.save(paths["jax"])
        jres = j.process_frame(*frames[3])
    return frames, paths, t.process_frame(*frames[3]), jres


def _assert_next_frame_agrees(got, want):
    """The one-step bands of the odometry and mapping parity tests."""
    np.testing.assert_allclose(got.odom_t, want.odom_t, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.odom_q, want.odom_q, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.map_t, want.map_t, rtol=0, atol=1e-2)
    np.testing.assert_allclose(got.map_q, want.map_q, rtol=0, atol=1e-3)


def test_jax_checkpoint_loads_in_the_port(two_runs):
    frames, paths, _, jres = two_runs
    pipe = tpl.Pipeline(CFG, device="cpu")
    pipe.load(paths["jax"])
    data = np.load(paths["jax"])
    assert pipe.frame == 3 and int(pipe.odo_state.frame) == 3
    for i, leaf in enumerate(_leaves(pipe.map_state)):
        np.testing.assert_array_equal(leaf.numpy(), data[f"map__{i}"])
    for i, leaf in enumerate(_leaves(pipe.odo_state)):
        np.testing.assert_array_equal(leaf.numpy(), data[f"odo__{i}"])
    assert len(pipe.mapped_positions()) == 3
    res = pipe.process_frame(*frames[3])
    # the JAX run's own next frame, from the very state the file holds
    _assert_next_frame_agrees(res, jres)


def test_port_checkpoint_loads_in_jax(two_runs):
    frames, paths, tres, _ = two_runs
    pipe = jpl.Pipeline(JCFG)
    pipe.load(paths["torch"])
    data = np.load(paths["torch"])
    assert pipe.frame == 3 and int(pipe.odo_state.frame) == 3
    for i, leaf in enumerate(jax.tree_util.tree_leaves(pipe.map_state)):
        assert leaf.dtype == data[f"map__{i}"].dtype
        np.testing.assert_array_equal(np.asarray(leaf), data[f"map__{i}"])
    assert len(pipe.mapped_positions()) == 3
    with oracle_planes():
        res = pipe.process_frame(*frames[3])
    _assert_next_frame_agrees(tres, res)


def test_ply_export(tmp_path):
    xyz = np.random.default_rng(0).normal(size=(50, 3))
    mask = np.ones(50, bool)
    mask[40:] = False
    n = write_ply(str(tmp_path / "c.ply"), xyz, mask)
    assert n == 40
    head = open(tmp_path / "c.ply").read().splitlines()
    assert head[0] == "ply" and "element vertex 40" in head[2]
    assert jexport.write_ply(str(tmp_path / "jc.ply"), xyz, mask) == 40
    assert open(tmp_path / "c.ply").read() == open(tmp_path / "jc.ply").read()
    write_ply(str(tmp_path / "col.ply"), xyz, color=(255, 0, 7))
    assert open(tmp_path / "col.ply").read().splitlines()[-1].endswith("255 0 7")

    n = write_trajectory_ply(str(tmp_path / "t.ply"), xyz[:10])
    assert n == 10
    jexport.write_trajectory_ply(str(tmp_path / "jt.ply"), xyz[:10])
    assert open(tmp_path / "t.ply").read() == open(tmp_path / "jt.ply").read()


def test_rslidar_quat_remap_is_unit():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    out = tmapping.rslidar_quat_remap(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    want = np.asarray(jmapping.rslidar_quat_remap(jnp.asarray(q)))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


def test_map_output_accessors(tmp_path):
    mc = MappingConfig(
        map_corner_capacity=4096, map_surf_capacity=8192,
        local_corner_capacity=4096, local_surf_capacity=8192,
        stack_corner_capacity=512, stack_surf_capacity=2048, knn_tile=1024,
    )
    pts = simulate_scan(World.urban(seed=2), np.zeros(3), n_azimuth=400, seed=0)
    idx = np.random.default_rng(0).permutation(len(pts))

    def cloud(p, cap):
        xyz = np.zeros((cap, 3), np.float32)
        m = np.zeros(cap, bool)
        k = min(len(p), cap)
        xyz[:k] = p[:k]
        m[:k] = True
        return PointCloud(torch.as_tensor(xyz), torch.zeros(cap),
                          torch.as_tensor(m))

    st, out = tmapping.mapping_step(
        MappingState.init(mc, "cpu"), cloud(pts[idx[:300]], 512),
        cloud(pts[idx[300:1500]], 2048), quat.quat_identity(), torch.zeros(3),
        mc,
    )
    sx, sm = tmapping.surround_cloud(st, out.t_w, mc, capacity=8192)
    assert sx.shape == (8192, 3) and int(sm.sum()) > 100
    # everything is near the origin, so the surround is the whole map
    assert int(sm.sum()) == int(out.map_corner_points) + int(out.map_surf_points)
    (cx, cm), (ux, um) = tmapping.full_map_cloud(st)
    assert int(um.sum()) == int(out.map_surf_points)
    assert int(cm.sum()) == int(out.map_corner_points)
    reg = tmapping.register_cloud(out.q_w, out.t_w,
                                  torch.as_tensor(pts[:10].astype(np.float32)))
    assert torch.isfinite(reg).all()
    want = jmapping.register_cloud(jnp.asarray(out.q_w.numpy()),
                                   jnp.asarray(out.t_w.numpy()),
                                   jnp.asarray(pts[:10].astype(np.float32)))
    np.testing.assert_allclose(reg.numpy(), np.asarray(want), atol=1e-5)


def test_pipeline_export_map_and_high_freq_pose(tmp_path):
    pipe, _ = _run_and_save(tmp_path)
    counts = pipe.export_map(str(tmp_path / "map"))
    assert counts == {"corner": int(pipe.map_state.corner.mask.sum()),
                      "surf": int(pipe.map_state.surf.mask.sum())}
    assert counts["surf"] > 1000
    for name in ("corner", "surf"):
        head = open(tmp_path / f"map_{name}.ply").read().splitlines()
        assert head[2] == f"element vertex {counts[name]}"
        assert len(head) == counts[name] + 7
    # after a retired sync step the composed pose is the mapped pose
    q, t = pipe.high_freq_pose(*pipe._last_odo_pose)
    np.testing.assert_allclose(t, pipe._last_map_pose[1], atol=1e-5)
    np.testing.assert_allclose(np.abs(q @ pipe._last_map_pose[0]), 1.0,
                               atol=1e-5)
