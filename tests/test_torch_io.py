"""The port's replay entry points: KITTI reader, pose writer, evaluation,
``run_kitti``, the CLI, and ``core/pose.py``.

Mirrors tests/test_kitti_e2e.py: a miniature dataset in the reference's
directory layout is written from synthetic scans, read by both packages'
readers, replayed by the port (per frame, fused and chunked, at hdl64-small
so that no test needs the ``slow`` mark) and scored.  ``io/kitti.py`` and
``io/evaluation.py`` are copies of NumPy-only modules, so whatever both
packages compute from the same numbers must be equal: the readers'
arrays and the pose files byte for byte, the metrics to 1e-12.  Poses
(float32 tensors against float32 JAX arrays) agree to 1e-6.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.core import pose as jpose
from light_loam_tpu.io import evaluation as jeval
from light_loam_tpu.io import kitti as jkitti
from light_loam_tpu.utils.synthetic import World, simulate_scan
from light_loam_tpu_torch.core import pose as tpose
from light_loam_tpu_torch.io import evaluation as teval
from light_loam_tpu_torch.io import kitti as tkitti
from light_loam_tpu_torch.models import pipeline as tpl

torch.set_num_threads(2)

N_FRAMES = 5
CAPACITY = tpl.PROFILES["hdl64-small"].scan.max_points


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    """A 5-frame 'sequence 99' in kittiHelper layout (kittiHelper.cpp:65-130):
    sequences/99/times.txt, velodyne/sequences/99/velodyne/NNNNNN.bin,
    results/99.txt (camera-frame GT)."""
    root = tmp_path_factory.mktemp("kitti")
    seq_dir = root / "sequences" / "99"
    vel_dir = root / "velodyne" / "sequences" / "99" / "velodyne"
    res_dir = root / "results"
    for d in (seq_dir, vel_dir, res_dir):
        os.makedirs(d, exist_ok=True)

    world = World.urban(seed=7)
    times, gt_rows = [], []
    for i in range(N_FRAMES):
        pos = np.array([0.5 * i, 0.0, 0.0])
        pts = simulate_scan(world, pos, n_azimuth=700, noise=0.01, seed=i)
        rec = np.zeros((len(pts), 4), np.float32)
        rec[:, :3] = pts
        rec[:, 3] = np.arange(len(pts)) % 7
        rec.tofile(vel_dir / f"{i:06d}.bin")
        times.append(0.1 * i)
        # camera-frame GT: lidar x-forward maps to camera z-forward
        H = np.eye(4)
        H[:3, 3] = [0.0, 0.0, pos[0]]
        gt_rows.append(H[:3].reshape(-1))
    np.savetxt(seq_dir / "times.txt", np.asarray(times), fmt="%.6f")
    np.savetxt(res_dir / "99.txt", np.asarray(gt_rows), fmt="%.6e")
    return str(root)


def _gt_lidar(root):
    gt_cam = tkitti.read_gt_poses(os.path.join(root, "results", "99.txt"))
    R, t = tkitti.gt_to_lidar_frame(gt_cam)
    return np.concatenate([R, t[:, :, None]], axis=2)


def test_kitti_sequence_reader_matches_jax(mini_kitti):
    seq, jseq = tkitti.KittiSequence(mini_kitti, "99"), jkitti.KittiSequence(
        mini_kitti, "99")
    assert len(seq) == len(jseq) == N_FRAMES
    assert seq.gt is not None and seq.gt.shape == (N_FRAMES, 3, 4)
    np.testing.assert_array_equal(seq.gt, jseq.gt)
    np.testing.assert_array_equal(seq.times, jseq.times)
    assert seq.frame_path(3) == jseq.frame_path(3)
    ts, pts = next(iter(seq))
    assert pts.shape[1] == 4 and len(pts) > 1000
    np.testing.assert_array_equal(pts, next(iter(jseq))[1])

    frames = list(seq.padded_frames(capacity=65536))
    jframes = list(jseq.padded_frames(capacity=65536))
    assert len(frames) == N_FRAMES
    _, xyz, mask = frames[0]
    assert xyz.shape == (65536, 3) and mask.sum() == len(pts)
    for (t, x, m), (jt, jx, jm) in zip(frames, jframes):
        assert t == jt
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(m, jm)

    # the padded reader keeps the intensity and drops what does not fit
    path = seq.frame_path(0)
    x, inten, m = tkitti.read_lidar_bin_padded(path, 100)
    assert x.shape == (100, 3) and m.all()
    np.testing.assert_array_equal(inten, pts[:100, 3])
    Rj, tj = jkitti.gt_to_lidar_frame(jseq.gt)
    Rt, tt = tkitti.gt_to_lidar_frame(seq.gt)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)


def test_padded_frames_surfaces_reader_errors(tmp_path):
    """A missing/unreadable .bin must raise in the consumer, not strand it
    on q.get() forever after the reader thread dies (the worker ships the
    exception as the queue sentinel)."""
    seq_dir = tmp_path / "sequences" / "99"
    vel_dir = tmp_path / "velodyne" / "sequences" / "99" / "velodyne"
    os.makedirs(seq_dir), os.makedirs(vel_dir)
    np.savetxt(seq_dir / "times.txt", np.array([0.0, 0.1, 0.2]), fmt="%.6f")
    for i in range(2):  # frame 2's .bin is missing
        rec = np.zeros((100, 4), np.float32)
        rec[:, 0] = np.arange(100) + 1.0
        rec.tofile(vel_dir / f"{i:06d}.bin")

    seq = tkitti.KittiSequence(str(tmp_path), "99")
    assert seq.gt is None
    got = []
    with pytest.raises(FileNotFoundError):
        for item in seq.padded_frames(capacity=256):
            got.append(item)
    assert len(got) == 2  # both real frames arrived before the error


def test_padded_frames_early_stop_ends_the_reader(mini_kitti):
    """A consumer that stops early must not leave the reader thread blocked
    on a full queue."""
    import threading

    before = threading.active_count()
    seq = tkitti.KittiSequence(mini_kitti, "99")
    for i, _ in enumerate(seq.padded_frames(capacity=1024, prefetch=1)):
        if i == 1:
            break
    assert threading.active_count() == before


def test_pose_writers_write_identical_files(tmp_path):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(6, 3)).astype(np.float32) * 10
    poses = teval.poses_from_quat_trans(q, t)
    np.testing.assert_allclose(poses, jeval.poses_from_quat_trans(q, t),
                               rtol=0, atol=1e-6)
    paths = [str(tmp_path / "torch.txt"), str(tmp_path / "jax.txt")]
    for path, writer in zip(paths, (tkitti.KittiPoseWriter,
                                    jkitti.KittiPoseWriter)):
        w = writer(path)
        for p in poses:
            w.write(p[:, :3], p[:, 3])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    back = tkitti.read_gt_poses(paths[0])
    assert back.shape == (6, 3, 4)
    np.testing.assert_allclose(back[0], np.eye(4)[:3], atol=1e-6)
    # a new writer truncates, as a fresh run must
    tkitti.KittiPoseWriter(paths[0])
    assert os.path.getsize(paths[0]) == 0


def test_evaluation_matches_jax():
    rng = np.random.default_rng(1)
    n = 600
    gt = np.tile(np.eye(4)[:3], (n, 1, 1))
    gt[:, 0, 3] = np.arange(n, dtype=float)
    gt[:, 1, 3] = 5 * np.sin(np.arange(n) / 40.0)
    est = gt.copy()
    est[:, :, 3] += rng.normal(scale=0.05, size=(n, 3)).cumsum(0)
    yaw = 1e-4 * np.arange(n)
    est[:, 0, 0], est[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    est[:, 1, 0], est[:, 1, 1] = np.sin(yaw), np.cos(yaw)

    assert abs(teval.ate_rmse(est, gt) - jeval.ate_rmse(est, gt)) <= 1e-12
    assert teval.ate_rmse(est, gt) > 0.1
    np.testing.assert_allclose(teval.trajectory_distances(gt),
                               jeval.trajectory_distances(gt), rtol=0,
                               atol=1e-12)
    e, je = (m.kitti_relative_errors(est, gt) for m in (teval, jeval))
    assert e.n_segments == je.n_segments > 0
    assert abs(e.t_err_percent - je.t_err_percent) <= 1e-12
    assert abs(e.r_err_deg_per_m - je.r_err_deg_per_m) <= 1e-12
    assert e.t_err_percent > 0 and e.r_err_deg_per_m > 0

    # the checks of tests/test_aux.py: a perfect and a 2 %-scaled run
    assert teval.kitti_relative_errors(gt, gt).t_err_percent < 1e-9
    scaled = gt.copy()
    scaled[:, :, 3] *= 0.98
    np.testing.assert_allclose(
        teval.kitti_relative_errors(scaled, gt).t_err_percent, 2.0, atol=0.05)
    short = teval.kitti_relative_errors(gt[:50], gt[:50])
    assert short.n_segments == 0 and np.isnan(short.t_err_percent)


@pytest.fixture(scope="module")
def per_frame_run(mini_kitti, tmp_path_factory):
    result = str(tmp_path_factory.mktemp("out") / "traj_99.txt")
    pipe = tpl.run_kitti(mini_kitti, "99", result, profile="hdl64-small",
                         device="cpu")
    return pipe, result


def test_run_kitti_end_to_end(mini_kitti, per_frame_run):
    pipe, result = per_frame_run
    est = tkitti.read_gt_poses(result)
    assert est.shape == (N_FRAMES, 3, 4)
    np.testing.assert_allclose(est[0], np.eye(4)[:3], atol=1e-6)
    err = teval.ate_rmse(est, _gt_lidar(mini_kitti))
    assert err < 0.30, f"ATE too high on mini sequence: {err}"
    assert pipe.dropped_mapping_frames == 0 and pipe.frame == N_FRAMES


@pytest.mark.parametrize("mode", ["chunked", "fused"])
def test_run_kitti_chunked_and_fused_replay(mini_kitti, per_frame_run,
                                            tmp_path, mode):
    """Chunked replay (chunk_size=3: 5 frames = one full chunk + one tail
    chunk padded with an empty frame, whose output row is trimmed) and the
    fused per-frame replay: one row per input frame, and on the CPU the
    staged run's poses exactly."""
    result = str(tmp_path / f"traj_99_{mode}.txt")
    kwargs = dict(chunk_size=3) if mode == "chunked" else dict(fused=True)
    out = tpl.run_kitti(mini_kitti, "99", result, profile="hdl64-small",
                        device="cpu", **kwargs)
    if mode == "chunked":
        assert not out.diverged.any() and out.map_t.shape == (N_FRAMES, 3)
    else:
        assert out.cfg.fused_step and out.timers.stages["fused_step"].count == 5
    est = tkitti.read_gt_poses(result)
    assert est.shape == (N_FRAMES, 3, 4)
    np.testing.assert_allclose(est[0], np.eye(4)[:3], atol=1e-6)
    assert teval.ate_rmse(est, _gt_lidar(mini_kitti)) < 0.30
    assert open(result).read() == open(per_frame_run[1]).read()


def test_run_kitti_high_freq_and_max_frames(mini_kitti, tmp_path):
    result = str(tmp_path / "hf.txt")
    pipe = tpl.run_kitti(mini_kitti, "99", result, profile="hdl64-small",
                         max_frames=3, pose_source="high_freq", device="cpu")
    est = tkitti.read_gt_poses(result)
    assert est.shape == (3, 3, 4) and pipe.frame == 3
    # with every frame mapped and retired, the composed pose is the mapped
    q, t = pipe.mapped_trajectory()
    rel = teval.poses_from_quat_trans(q, t)
    np.testing.assert_allclose(est[:, :, 3], rel[:, :, 3] - rel[0, :, 3],
                               atol=1e-5)
    with pytest.raises(ValueError, match="pose_source"):
        tpl.run_kitti(mini_kitti, "99", result, pose_source="bogus",
                      device="cpu")


@pytest.mark.parametrize("flags", [[], ["--fused"], ["--chunk", "3"]])
def test_cli_kitti_to_scored_trajectory(mini_kitti, tmp_path, capsys, flags):
    """The command a user runs: KITTI folder in, pose file out, scored by
    the evaluation CLI against the lidar-frame ground truth that the kitti
    CLI dumps."""
    result = str(tmp_path / "out.txt")
    tpl.main(["--dataset", mini_kitti, "--sequence", "99", "--result", result,
              "--profile", "hdl64-small", "--frames", "3", "--device", "cpu",
              *flags])
    out = capsys.readouterr().out
    assert f"trajectory written to {result}" in out
    assert ("chunked replay" in out) == (flags == ["--chunk", "3"])
    assert tkitti.read_gt_poses(result).shape == (3, 3, 4)

    gt_out = str(tmp_path / "gt_lidar.txt")
    tkitti.main(["--dataset", mini_kitti, "--sequence", "99", "--frames", "2",
                 "--no-sleep", "--gt-out", gt_out])
    assert "replayed 2 frames" in capsys.readouterr().out
    teval.main([result, gt_out])
    out = capsys.readouterr().out
    assert "frames: 3" in out and "ATE RMSE" in out
    ate = float(out.split("ATE RMSE:")[1].split()[0])
    assert ate < 0.30
    with pytest.raises(SystemExit):
        teval.main([result])


def test_evaluation_module_runs_as_a_script(per_frame_run):
    """``python -m light_loam_tpu_torch.io.evaluation EST GT`` in a process
    of its own, which must not load jax."""
    _, result = per_frame_run
    code = ("import sys, runpy; sys.argv = ['evaluation', %r, %r]; "
            "runpy.run_module('light_loam_tpu_torch.io.evaluation', "
            "run_name='__main__'); "
            "assert 'jax' not in sys.modules" % (result, result))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "ATE RMSE: 0.0000 m" in proc.stdout


def test_pose_matches_jax():
    rng = np.random.default_rng(2)

    def rand_pose(n=None):
        shape = (4,) if n is None else (n, 4)
        q = rng.normal(size=shape).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        return q, rng.normal(size=shape[:-1] + (3,)).astype(np.float32)

    (qa, ta), (qb, tb) = rand_pose(), rand_pose()
    pts = rng.normal(size=(16, 3)).astype(np.float32) * 5
    ja, jb = (jpose.Pose(jnp.asarray(q), jnp.asarray(t))
              for q, t in ((qa, ta), (qb, tb)))
    a, b = (tpose.Pose(torch.as_tensor(q), torch.as_tensor(t))
            for q, t in ((qa, ta), (qb, tb)))

    def same(t_val, j_val):
        np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=0,
                                   atol=1e-6)

    for got, want in ((tpose.compose(a, b), jpose.compose(ja, jb)),
                      (tpose.inverse(a), jpose.inverse(ja)),
                      (a.normalize(), ja.normalize())):
        same(got.q, want.q)
        same(got.t, want.t)
    same(a.matrix(), ja.matrix())
    same(tpose.transform_points(a, torch.as_tensor(pts)),
         jpose.transform_points(ja, jnp.asarray(pts)))
    ident = tpose.Pose.identity(device="cpu")
    same(ident.q, jpose.Pose.identity().q)
    assert ident.t.device.type == "cpu" and ident.matrix().shape == (4, 4)
    # a∘a⁻¹ is the identity, and batched poses broadcast
    round_trip = tpose.compose(a, tpose.inverse(a))
    np.testing.assert_allclose(round_trip.t.numpy(), 0, atol=1e-5)
    qs, ts = rand_pose(3)
    batch = tpose.Pose(torch.as_tensor(qs), torch.as_tensor(ts))
    same(batch.matrix(), jpose.Pose(jnp.asarray(qs), jnp.asarray(ts)).matrix())
    same(tpose.transform_points(batch, torch.as_tensor(pts)),
         jpose.transform_points(jpose.Pose(jnp.asarray(qs), jnp.asarray(ts)),
                                jnp.asarray(pts)))
