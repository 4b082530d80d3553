"""End-to-end SLAM pipeline: the host frame loop replacing the reference's
four ROS processes and pub/sub topics (SURVEY.md §1 dataflow).

Counterpart of ``light_loam_tpu/models/pipeline.py``.  Per frame:

    raw cloud ──▶ extract_features ──▶ odometry_step ──▶ mapping_step

all on the Pipeline's ``device``, as three staged steps (each one
captured CUDA graph on a card, models/stages.py, as the JAX package jits
each) or, with ``PipelineConfig.fused_step``, as one device program
(models/fused.py).  The reference's back-pressure — mapping
drops frames while it is busy (laserMapping.cpp:1571-1575) — is kept: a
mapping step is dispatched only when the previous one has retired (a CUDA
event recorded after the step has completed), otherwise the frame is
dropped for mapping while odometry goes on.  With ``sync_mapping`` (the
default) every step retires before its frame returns.
Besides the stages, the frame's timers (``Pipeline.timers``) hold host
spans of the pose read (``pose_read``), the keyframe stack
(``keyframe_stack``) and the retire of a mapping step (``retire``), and
count every read of the card on the frame path (``StageTimers.read``).
``refine_recent_keyframes`` re-estimates the newest buffered keyframes
jointly against plane landmarks of the map (models/refine.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from light_loam_tpu_torch.config import (
    HDL32,
    HDL64_KITTI,
    HDL64_SMALL,
    M2DGR_VLP32C,
    VLP16,
    PipelineConfig,
)
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.models import stages
from light_loam_tpu_torch.models.mapping import (
    MappingState,
    check_mapping_config,
)
from light_loam_tpu_torch.models.odometry import (
    OdometryState,
    check_odometry_config,
)
from light_loam_tpu_torch.models.refine import extract_landmarks, refine_window
from light_loam_tpu_torch.ops.features import check_scan_config
from light_loam_tpu_torch.ops.voxel import voxel_downsample
from light_loam_tpu_torch.utils.timing import StageTimers

PROFILES = {
    "hdl64": HDL64_KITTI,
    "vlp16": VLP16,
    "hdl32": HDL32,
    "m2dgr": M2DGR_VLP32C,
    "hdl64-small": HDL64_SMALL,  # small static shapes for tests
}


def resolve_device(device) -> torch.device:
    """torch.device for ``device``.  Asking for CUDA raises without a usable
    card (the port never falls back to the CPU) and under an
    ``LLT_MATMUL_PRECISION`` other than "highest" (the port runs full
    float32 matmuls only; see the package docstring)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        tier = os.environ.get("LLT_MATMUL_PRECISION", "highest")
        if tier != "highest":
            raise ValueError(
                f"LLT_MATMUL_PRECISION={tier!r}: the PyTorch port runs only "
                "'highest' (full float32 matmuls) on CUDA")
    return dev


@dataclass
class FrameResult:
    frame: int
    odom_q: np.ndarray
    odom_t: np.ndarray
    mapped: bool
    map_q: Optional[np.ndarray] = None
    map_t: Optional[np.ndarray] = None


@dataclass
class Pipeline:
    cfg: PipelineConfig = field(default_factory=lambda: HDL64_KITTI)
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        check_scan_config(self.cfg.scan)
        check_odometry_config(self.cfg.odometry)
        check_mapping_config(self.cfg.mapping)
        scan = self.cfg.scan
        dev = self.device
        self.odo_state = OdometryState.init(scan.max_less_sharp,
                                            scan.max_less_flat, dev)
        self.map_state = MappingState.init(self.cfg.mapping, dev)
        self.frame = 0
        self.dropped_mapping_frames = 0
        self.diverged_frames = 0
        self._last_odo_pose = (np.asarray([0.0, 0.0, 0.0, 1.0], np.float32),
                               np.zeros(3, np.float32))
        self._last_map_pose = (np.asarray([0.0, 0.0, 0.0, 1.0], np.float32),
                               np.zeros(3, np.float32))
        # full-length mapped-pose history, one row per retired step
        self._map_trajectory: list = []
        self._map_quats: list = []
        # bounded window of (map_q, map_t, stack_xyz, stack_mask, traj
        # index, odo_q, odo_t) per retired step, for windowed refinement
        self._keyframes: list = []
        self.map_saturation_events = 0
        self.local_overflow_events = 0
        self.timers = StageTimers(budget_ms=self.cfg.frame_budget_ms,
                                  device=dev.type == "cuda")
        self._pending_map_out = None
        self._pending_map_state = None
        self._pending_done = None
        self._pending_kf = None

    # -- mapping back-pressure ------------------------------------------
    def _mapping_busy(self) -> bool:
        if self._pending_map_out is None or self._pending_done is None:
            return False
        return not self._pending_done.query()

    def _retire_mapping(self, wait: bool) -> None:
        if self._pending_map_out is None:
            return
        if not wait and self._mapping_busy():
            return
        out = self._pending_map_out
        read = self.timers.read
        with self.timers.host("retire"):
            self.map_state = self._pending_map_state
            q = read(out.q_w)
            t = read(out.t_w)
            self._last_map_pose = (q, t)
            self._map_trajectory.append(t.copy())
            self._map_quats.append(q.copy())
            if self._pending_kf is not None:
                q_odo, t_odo, sx, sm = self._pending_kf
                self._keyframes.append(
                    (q, t, read(sx), read(sm), len(self._map_trajectory) - 1,
                     q_odo, t_odo))
                if len(self._keyframes) > 16:
                    self._keyframes.pop(0)
                self._pending_kf = None
            # saturation watch: the voxel-dedup store drops overflow silently
            m = self.cfg.mapping
            if (int(read(out.map_surf_points)) >= m.map_surf_capacity
                    or int(read(out.map_corner_points))
                    >= m.map_corner_capacity):
                self.map_saturation_events += 1
            if int(read(out.local_overflow)) > 0:
                self.local_overflow_events += 1
        self._pending_map_out = None
        self._pending_map_state = None
        self._pending_done = None

    # -- one frame ------------------------------------------------------
    def process_frame(self, xyz: np.ndarray, mask: np.ndarray) -> FrameResult:
        cfg = self.cfg
        dev = self.device
        if (
            cfg.fused_step
            and cfg.sync_mapping
            and self.frame % cfg.odometry.skip_frame_num == 0
        ):
            return self._process_frame_fused(xyz, mask)
        # each stage one graph replay on a card (models/stages.py)
        with self.timers.stage("features"):
            feats = stages.run_features(xyz, mask, cfg, dev)
        with self.timers.stage("odometry"):
            self.odo_state, odo = stages.run_odometry(self.odo_state, feats,
                                                      cfg)

        # failure containment: a non-finite odometry pose must not poison
        # downstream state — keep the previous pose and count the frame
        with self.timers.host("pose_read"):
            odo_q = self.timers.read(odo.q_w)
            odo_t = self.timers.read(odo.t_w)
        if not np.isfinite(odo_t).all():
            self.diverged_frames += 1
            q_prev, t_prev = self._last_odo_pose
            self.odo_state = self.odo_state._replace(
                q_w=torch.as_tensor(q_prev).to(dev),
                t_w=torch.as_tensor(t_prev).to(dev),
                q_lc=torch.as_tensor(np.asarray([0.0, 0.0, 0.0, 1.0],
                                                np.float32)).to(dev),
                t_lc=torch.zeros(3, device=dev),
            )
            odo = odo._replace(q_w=self.odo_state.q_w, t_w=self.odo_state.t_w)
            odo_q, odo_t = q_prev.copy(), t_prev.copy()
        else:
            self._last_odo_pose = (odo_q, odo_t)

        mapped = False
        if self.frame % cfg.odometry.skip_frame_num == 0:
            self._retire_mapping(wait=not cfg.drop_mapping_backlog)
            if self._mapping_busy():
                # previous mapping still in flight → drop this frame
                # (laserMapping.cpp:1571-1575)
                self.dropped_mapping_frames += 1
            else:
                with self.timers.stage("mapping"):
                    new_state, map_out = stages.run_mapping(
                        self.map_state,
                        self.odo_state.corner_last,
                        self.odo_state.surf_last,
                        odo.q_w, odo.t_w, cfg,
                    )
                self._pending_map_out = map_out
                self._pending_map_state = new_state
                if dev.type == "cuda":
                    self._pending_done = torch.cuda.Event()
                    self._pending_done.record()
                self._pending_kf = (odo_q, odo_t, *self._keyframe_stack())
                mapped = True

        result = FrameResult(frame=self.frame, odom_q=odo_q, odom_t=odo_t,
                             mapped=mapped)
        if mapped:
            self._retire_mapping(wait=cfg.sync_mapping)
            # async mode: the last *retired* pose (stale by up to one step)
            result.map_q, result.map_t = self._last_map_pose
        self.frame += 1
        self.timers.frame_done()
        return result

    def _process_frame_fused(self, xyz: np.ndarray, mask: np.ndarray) -> FrameResult:
        """Latency mode: the whole frame as one program (models/fused.py).

        Bookkeeping (keyframe buffering, trajectory, saturation watch) is
        shared with the staged path via the pending/_retire_mapping
        machinery; mapping retires synchronously because this path only
        engages with sync_mapping.
        """
        from light_loam_tpu_torch.models.fused import fused_frame_step

        with self.timers.stage("fused_step"):
            self.odo_state, new_state, odo, map_out, diverged = fused_frame_step(
                self.odo_state, self.map_state,
                torch.as_tensor(xyz, dtype=torch.float32),
                torch.as_tensor(mask, dtype=torch.bool), self.cfg,
            )
        # enqueue the keyframe-stack downsample BEFORE any host read so it
        # queues behind the fused program on the device; the first read
        # below then covers both in one wait
        kf_stack = self._keyframe_stack()
        with self.timers.host("pose_read"):
            odo_q = self.timers.read(odo.q_w)
            odo_t = self.timers.read(odo.t_w)
            diverged = bool(self.timers.read(diverged))
        if diverged:
            self.diverged_frames += 1
        else:
            self._last_odo_pose = (odo_q, odo_t)
        self._pending_map_out = map_out
        self._pending_map_state = new_state
        self._pending_kf = (odo_q, odo_t, *kf_stack)
        self._retire_mapping(wait=True)
        result = FrameResult(
            frame=self.frame, odom_q=odo_q, odom_t=odo_t, mapped=True,
            map_q=self._last_map_pose[0], map_t=self._last_map_pose[1],
        )
        self.frame += 1
        self.timers.frame_done()
        return result

    # -- windowed refinement (models/refine.py) -------------------------
    def _window(self, n_keyframes: int):
        """The newest ``n_keyframes`` buffered keyframes on the pipeline's
        device: (q (K, 4), t (K, 3), stack_xyz (K, P, 3), stack_mask (K,
        P))."""
        kfs = self._keyframes[-n_keyframes:]
        return tuple(torch.as_tensor(np.stack([k[i] for k in kfs])).to(
            self.device) for i in range(4))

    def refine_recent_keyframes(
        self, n_keyframes: int = 4,
        n_landmarks: int = 512, n_iterations: int = 4,
        apply: bool = False,
    ):
        """Jointly re-refine the most recent keyframe poses against plane
        landmarks extracted from the map (the Schur-complement window — a
        capability beyond the reference's frame-at-a-time back end).

        Returns (q (K,4), t (K,3)) refined poses for the stored window as
        numpy, or None if fewer than 2 keyframes are buffered.  A keyframe
        is buffered for every RETIRED mapping step, carrying that step's
        mapped pose, odometry pose and surf stack (all of the same frame,
        in async/drop regimes too).  Everything runs on the pipeline's
        device; the refined poses are read back once, at the end.

        ``apply=True`` integrates the result: the stored keyframes and the
        mapped trajectory rows they came from are rewritten with the
        refined poses, and the odom→map correction (q_wm, t_wm — the
        transformUpdate state, laserMapping.cpp:119-123) is re-anchored on
        the newest refined pose, so the next frame, staged or fused,
        continues from it.
        """
        if len(self._keyframes) < 2:
            return None
        self._retire_mapping(wait=True)
        qs, ts, stacks, masks = self._window(n_keyframes)
        K = qs.shape[0]
        lm = extract_landmarks(self.map_state.surf.xyz,
                               self.map_state.surf.mask, n_landmarks)
        q_dev, t_dev, _ = refine_window(qs, ts, stacks, masks, lm,
                                        n_iterations=n_iterations)
        q, t = q_dev.cpu().numpy(), t_dev.cpu().numpy()

        if apply:
            base = len(self._keyframes) - K
            for i in range(K):
                kf = self._keyframes[base + i]
                self._keyframes[base + i] = (q[i], t[i], *kf[2:])
                idx = kf[4]
                if idx is not None and 0 <= idx < len(self._map_trajectory):
                    self._map_trajectory[idx] = t[i].copy()
                    self._map_quats[idx] = q[i].copy()
            self._last_map_pose = (q[-1].copy(), t[-1].copy())
            # re-anchor the odom→map correction on the refined newest pose,
            # paired with the odometry pose OF THAT SAME FRAME (stored with
            # the keyframe; _last_odo_pose can be a later frame's in
            # async/drop regimes, which would fold the intervening motion
            # into the correction)
            newest = self._keyframes[-1]
            q_odo = torch.as_tensor(newest[5]).to(self.device)
            t_odo = torch.as_tensor(newest[6]).to(self.device)
            q_wm = quat.quat_normalize(
                quat.quat_multiply(q_dev[-1], quat.quat_inverse(q_odo)))
            t_wm = t_dev[-1] - quat.quat_rotate(q_wm, t_odo)
            self.map_state = self.map_state._replace(q_wm=q_wm, t_wm=t_wm)
        return q, t

    def _keyframe_stack(self, stack_points: int = 2048):
        """(stack_xyz, stack_mask) of the surf cloud a mapping step is about
        to consume — captured at dispatch, buffered at retirement."""
        surf = self.odo_state.surf_last
        with self.timers.host("keyframe_stack"):
            sx, _, sm, _ = voxel_downsample(
                surf.xyz, surf.rel, surf.mask,
                self.cfg.mapping.plane_resolution, stack_points,
            )
        return sx, sm

    # -- checkpoint / resume (snapshot of map + pose state) --------------
    def save(self, path: str) -> None:
        from light_loam_tpu_torch.utils.checkpoint import save_state

        self._retire_mapping(wait=True)
        extra = {
            # divergence-containment fallback poses must survive resume:
            # without them a non-finite pose on the first post-resume frame
            # would reset the world pose to the identity (origin)
            "last_odo_q": self._last_odo_pose[0],
            "last_odo_t": self._last_odo_pose[1],
            "last_map_q": self._last_map_pose[0],
            "last_map_t": self._last_map_pose[1],
        }
        if self._map_trajectory:
            extra["map_trajectory"] = np.stack(self._map_trajectory)
            extra["map_quats"] = np.stack(self._map_quats)
        save_state(path, self.odo_state, self.map_state, frame=self.frame,
                   extra=extra)

    def load(self, path: str) -> None:
        from light_loam_tpu_torch.utils.checkpoint import load_state

        self.odo_state, self.map_state, self.frame, extra = load_state(
            path, self.odo_state, self.map_state
        )
        traj = extra.get("map_trajectory")
        self._map_trajectory = [] if traj is None else list(traj)
        quats = extra.get("map_quats")
        if quats is None and self._map_trajectory:
            # legacy checkpoint (trajectory saved before quats were):
            # identity rotations keep the lists in lockstep so
            # mapped_trajectory()/save() don't crash on np.stack.  The
            # package layout is xyzw (identity == [0,0,0,1]); [1,0,0,0]
            # here would be a 180-deg x-rotation silently persisted as
            # real data on the next save().
            quats = [np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
                     for _ in self._map_trajectory]
        self._map_quats = [] if quats is None else list(quats)
        # restore containment fallbacks (older checkpoints without the
        # extras fall back to the restored odometry/mapping state poses)
        if "last_odo_q" in extra:
            self._last_odo_pose = (
                np.asarray(extra["last_odo_q"], np.float32),
                np.asarray(extra["last_odo_t"], np.float32),
            )
        else:
            self._last_odo_pose = (
                self.odo_state.q_w.cpu().numpy().astype(np.float32),
                self.odo_state.t_w.cpu().numpy().astype(np.float32),
            )
        if "last_map_q" in extra:
            self._last_map_pose = (
                np.asarray(extra["last_map_q"], np.float32),
                np.asarray(extra["last_map_t"], np.float32),
            )
        else:
            self._last_map_pose = self.high_freq_pose(*self._last_odo_pose)

    def mapped_positions(self) -> np.ndarray:
        """(N, 3) mapped positions of every retired mapping step (the
        /aft_mapped_path analog, laserMapping.cpp:2297-2305)."""
        self._retire_mapping(wait=True)
        if not self._map_trajectory:
            return np.zeros((0, 3), np.float32)
        return np.stack(self._map_trajectory)

    def mapped_trajectory(self):
        """Mapped poses as (q (N, 4), t (N, 3)), one row per retired step
        (the reference's RESULT_PATH rows, laserMapping.cpp:2284-2326)."""
        self._retire_mapping(wait=True)
        if not self._map_trajectory:
            return np.zeros((0, 4), np.float32), np.zeros((0, 3), np.float32)
        return np.stack(self._map_quats), np.stack(self._map_trajectory)

    # -- map exports (the /laser_cloud_surround, /laser_cloud_map rviz
    #    surface, laserMapping.cpp:2171-2203) ---------------------------
    def export_map(self, path_prefix: str) -> dict:
        from light_loam_tpu_torch.models.mapping import full_map_cloud
        from light_loam_tpu_torch.utils.export import write_ply

        self._retire_mapping(wait=True)
        (cx, cm), (sx, sm) = full_map_cloud(self.map_state)
        n_c = write_ply(f"{path_prefix}_corner.ply", cx.cpu().numpy(),
                        cm.cpu().numpy())
        n_s = write_ply(f"{path_prefix}_surf.ply", sx.cpu().numpy(),
                        sm.cpu().numpy())
        return {"corner": n_c, "surf": n_s}

    # -- current best pose (the high-frequency publish path,
    #    laserMapping.cpp:168-247, without the rslidar Euler remap) ------
    def high_freq_pose(self, odo_q: np.ndarray, odo_t: np.ndarray):
        ms = self.map_state
        q_odo = torch.as_tensor(odo_q, dtype=torch.float32).to(self.device)
        t_odo = torch.as_tensor(odo_t, dtype=torch.float32).to(self.device)
        q = quat.quat_multiply(ms.q_wm, q_odo)
        t = quat.quat_rotate(ms.q_wm, t_odo) + ms.t_wm
        return self.timers.read(q), self.timers.read(t)


def synthetic_frames(
    n_frames: int,
    cfg: PipelineConfig,
    n_azimuth: int = 1800,
    speed: float = 1.0,
    seed: int = 0,
):
    """Yield (true position, padded xyz, mask) of a simulated straight run
    through ``World.urban(seed)`` — the frames ``run_synthetic`` feeds."""
    from light_loam_tpu_torch.utils.synthetic import World, pad_cloud, simulate_scan

    world = World.urban(seed=seed)
    for i in range(n_frames):
        pos = np.array([speed * i, 0.02 * i, 0.0])
        pts = simulate_scan(
            world, pos, n_rings=cfg.scan.n_scans,
            lower_deg=cfg.scan.lower_bound_deg,
            upper_deg=cfg.scan.upper_bound_deg,
            n_azimuth=n_azimuth, noise=0.01, seed=100 + i,
        )
        yield (pos, *pad_cloud(pts, cfg.scan.max_points))


def _live_viz(pipe, prefix: Optional[str], every: int, frame_idx: int,
              gt=None):
    """Refresh the PNG/HTML dashboard in place every ``every`` frames —
    the live-view analog of the reference's rviz window (keep the HTML
    open in a browser and reload).  Waits for in-flight mapping and copies
    the map stores to the host, so it trades throughput for
    observability; gate it with ``every``."""
    if not prefix or not every or (frame_idx + 1) % every:
        return
    from light_loam_tpu_torch.utils import viz

    viz.render_pipeline(pipe, prefix, gt=gt)


def run_synthetic(
    n_frames: int = 20,
    profile: str = "hdl64",
    n_azimuth: int = 1800,
    speed: float = 1.0,
    seed: int = 0,
    fused: bool = False,
    device: str = "cuda",
    viz_prefix: Optional[str] = None,
    viz_every: int = 0,
):
    """Drive the pipeline over a simulated straight run; returns
    (pipeline, results, true positions)."""
    cfg = PROFILES[profile]
    if fused:
        cfg = dataclasses.replace(cfg, fused_step=True)
    pipe = Pipeline(cfg, device=device)
    results = []
    truth = []
    for i, (pos, xyz, mask) in enumerate(
            synthetic_frames(n_frames, cfg, n_azimuth, speed, seed)):
        results.append(pipe.process_frame(xyz, mask))
        truth.append(pos)
        _live_viz(pipe, viz_prefix, viz_every, i, gt=np.asarray(truth))
    pipe._retire_mapping(wait=True)
    return pipe, results, np.asarray(truth)


def _rotation_matrix(q: np.ndarray) -> np.ndarray:
    return quat.quat_to_matrix(torch.as_tensor(q)).numpy()


def run_kitti(
    dataset_folder: str,
    sequence: str,
    result_path: str,
    profile: str = "hdl64",
    max_frames: Optional[int] = None,
    pose_source: str = "mapped",
    fused: bool = False,
    chunk_size: int = 0,
    device: str = "cuda",
    viz_prefix: Optional[str] = None,
    viz_every: int = 0,
):
    """KITTI sequence → trajectory file (the reference's RESULT_PATH
    artifact, laserMapping.cpp:2284-2326).

    ``pose_source``:
      * "mapped" (default, reference-faithful): one row per *retired*
        mapping step, written from the mapping thread's own poses like
        laserMapping.cpp:2284-2326 — under back-pressure drops the file
        has fewer rows than input frames, exactly like the reference;
      * "high_freq": one row per input frame from the low-latency
        composed pose (the /aft_mapped_to_init_high_frec analog,
        laserMapping.cpp:168-247) — denser but odometry-grade on frames
        mapping dropped.

    ``chunk_size`` > 1 switches to the offline chunked runner
    (models/fused.run_chunked): K frames per host read — the fastest way
    to replay a whole sequence.  Implies pose_source="mapped" semantics
    with every frame mapping (no drop policy, no skip decimation); returns
    the ChunkOutput instead of a Pipeline.
    """
    from light_loam_tpu_torch.io.kitti import KittiPoseWriter, KittiSequence

    if pose_source not in ("mapped", "high_freq"):
        raise ValueError(f"unknown pose_source: {pose_source!r}")
    cfg = PROFILES[profile]
    if fused:
        cfg = dataclasses.replace(cfg, fused_step=True)
    device = resolve_device(device)
    seq = KittiSequence(dataset_folder, sequence)
    writer = KittiPoseWriter(result_path)
    n = len(seq) if max_frames is None else min(len(seq), max_frames)

    def frame_stream():
        count = 0
        for _ts, xyz, mask in seq.padded_frames(cfg.scan.max_points):
            if count >= n:
                break
            yield xyz, mask
            count += 1

    if chunk_size and chunk_size > 1:
        from light_loam_tpu_torch.models.fused import run_chunked

        _, _, outs = run_chunked(frame_stream(), cfg, chunk_size=chunk_size,
                                 device=device)
        for q, t in zip(outs.map_q, outs.map_t):
            writer.write(_rotation_matrix(q), t)
        return outs

    pipe = Pipeline(cfg, device=device)
    for i, (xyz, mask) in enumerate(frame_stream()):
        res = pipe.process_frame(xyz, mask)
        if pose_source == "high_freq":
            q, t = pipe.high_freq_pose(res.odom_q, res.odom_t)
            writer.write(_rotation_matrix(q), t)
        _live_viz(pipe, viz_prefix, viz_every, i)
    pipe._retire_mapping(wait=True)
    if pose_source == "mapped":
        for q, t in zip(*pipe.mapped_trajectory()):
            writer.write(_rotation_matrix(q), t)
    return pipe


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="light_loam_tpu_torch SLAM pipeline (PyTorch/CUDA)")
    ap.add_argument("--dataset", help="KITTI dataset folder (kittiHelper layout)")
    ap.add_argument("--sequence", default="04")
    ap.add_argument("--result", default="trajectory.txt")
    ap.add_argument("--profile", default="hdl64", choices=sorted(PROFILES))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="run on the synthetic world instead of KITTI data")
    ap.add_argument("--viz", metavar="PREFIX", default=None,
                    help="write PNG quick-looks (PREFIX_traj.png, "
                         "PREFIX_map.png) and PREFIX_view.html after the "
                         "run — the headless stand-in for the reference's "
                         "rviz launch (needs matplotlib)")
    ap.add_argument("--viz-every", type=int, default=0, metavar="N",
                    help="with --viz: ALSO refresh the dashboard in "
                         "place every N frames (live view — keep "
                         "PREFIX_view.html open and reload; waits for "
                         "in-flight mapping each refresh)")
    ap.add_argument("--fused", action="store_true",
                    help="latency mode: run each frame as ONE device "
                         "program (models/fused.py; on a card, one CUDA "
                         "graph replay) instead of three staged steps")
    ap.add_argument("--chunk", type=int, default=0, metavar="K",
                    help="offline mode: replay K frames per host read "
                         "(models/fused.run_chunked) — fastest whole-"
                         "sequence replay; every frame maps")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.viz:
        from light_loam_tpu_torch.utils import viz

        viz._require_agg()  # fail before the run, not after it

    t0 = time.time()
    gt = None
    if args.synthetic or not args.dataset:
        n = args.frames or 20
        if args.chunk > 1:
            from light_loam_tpu_torch.models.fused import run_chunked

            cfg = PROFILES[args.profile]
            frames = synthetic_frames(n, cfg)
            truth = []

            def stream():
                for pos, xyz, mask in frames:
                    truth.append(pos)
                    yield xyz, mask

            _, _, outs = run_chunked(stream(), cfg, chunk_size=args.chunk,
                                     device=resolve_device(args.device))
            err = np.linalg.norm(outs.map_t[-1] - truth[-1])
            print(f"frames: {n} (chunk={args.chunk})  "
                  f"final mapped pose error: {err:.3f} m")
            print(f"wall: {time.time() - t0:.2f}s")
            return
        pipe, results, truth = run_synthetic(
            n_frames=n, profile=args.profile, fused=args.fused,
            device=args.device, viz_prefix=args.viz,
            viz_every=args.viz_every)
        gt = truth
        err = np.linalg.norm(results[-1].odom_t - truth[-1])
        print(f"frames: {len(results)}  final pose error: {err:.3f} m")
    else:
        out = run_kitti(args.dataset, args.sequence, args.result,
                        args.profile, args.frames, fused=args.fused,
                        chunk_size=args.chunk, device=args.device,
                        viz_prefix=args.viz, viz_every=args.viz_every)
        print(f"trajectory written to {args.result}")
        if args.chunk > 1:
            print(f"wall: {time.time() - t0:.2f}s  (chunked replay, "
                  f"{args.chunk} frames per host read)")
            return
        pipe = out
    print(f"wall: {time.time() - t0:.2f}s  dropped mapping frames: "
          f"{pipe.dropped_mapping_frames}")
    print(pipe.timers.report())
    if args.viz:
        out = viz.render_pipeline(pipe, args.viz, gt=gt)
        print("viz:", " ".join(sorted(out.values())))


if __name__ == "__main__":
    main()
