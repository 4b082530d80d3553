"""End-to-end SLAM pipeline: the host frame loop replacing the reference's
four ROS processes and pub/sub topics (SURVEY.md §1 dataflow).

Counterpart of ``light_loam_tpu/models/pipeline.py`` (staged path).  Per
frame:

    raw cloud ──▶ extract_features ──▶ odometry_step ──▶ mapping_step

all on the Pipeline's ``device``.  The reference's back-pressure — mapping
drops frames while it is busy (laserMapping.cpp:1571-1575) — is kept: a
mapping step is dispatched only when the previous one has retired (a CUDA
event recorded after the step has completed), otherwise the frame is
dropped for mapping while odometry goes on.  With ``sync_mapping`` (the
default) every step retires before its frame returns.
"""

from __future__ import annotations

import argparse
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
from light_loam_tpu_torch.models.mapping import (
    MappingState,
    check_mapping_config,
    mapping_step,
)
from light_loam_tpu_torch.models.odometry import (
    OdometryState,
    check_odometry_config,
    odometry_step,
)
from light_loam_tpu_torch.ops.features import check_scan_config, extract_features
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
        if self.cfg.fused_step:
            raise NotImplementedError(
                "PipelineConfig.fused_step=True is not ported to PyTorch yet")
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
        self.map_state = self._pending_map_state
        q = out.q_w.cpu().numpy()
        t = out.t_w.cpu().numpy()
        self._last_map_pose = (q, t)
        self._map_trajectory.append(t.copy())
        self._map_quats.append(q.copy())
        if self._pending_kf is not None:
            q_odo, t_odo, sx, sm = self._pending_kf
            self._keyframes.append((q, t, sx.cpu().numpy(), sm.cpu().numpy(),
                                    len(self._map_trajectory) - 1, q_odo, t_odo))
            if len(self._keyframes) > 16:
                self._keyframes.pop(0)
            self._pending_kf = None
        # saturation watch: the voxel-dedup store drops overflow silently
        m = self.cfg.mapping
        if (int(out.map_surf_points) >= m.map_surf_capacity
                or int(out.map_corner_points) >= m.map_corner_capacity):
            self.map_saturation_events += 1
        if int(out.local_overflow) > 0:
            self.local_overflow_events += 1
        self._pending_map_out = None
        self._pending_map_state = None
        self._pending_done = None

    # -- one frame ------------------------------------------------------
    def process_frame(self, xyz: np.ndarray, mask: np.ndarray) -> FrameResult:
        cfg = self.cfg
        dev = self.device
        with self.timers.stage("features"):
            feats = extract_features(
                torch.as_tensor(xyz, dtype=torch.float32).to(dev),
                torch.as_tensor(mask, dtype=torch.bool).to(dev), cfg.scan)
        with self.timers.stage("odometry"):
            self.odo_state, odo = odometry_step(
                self.odo_state, feats, cfg.odometry, cfg.scan.scan_period)

        # failure containment: a non-finite odometry pose must not poison
        # downstream state — keep the previous pose and count the frame
        odo_q = odo.q_w.cpu().numpy()
        odo_t = odo.t_w.cpu().numpy()
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
                    new_state, map_out = mapping_step(
                        self.map_state,
                        self.odo_state.corner_last,
                        self.odo_state.surf_last,
                        odo.q_w, odo.t_w, cfg.mapping,
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

    def _keyframe_stack(self, stack_points: int = 2048):
        """(stack_xyz, stack_mask) of the surf cloud a mapping step is about
        to consume — captured at dispatch, buffered at retirement."""
        surf = self.odo_state.surf_last
        sx, _, sm, _ = voxel_downsample(
            surf.xyz, surf.rel, surf.mask,
            self.cfg.mapping.plane_resolution, stack_points,
        )
        return sx, sm

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


def run_synthetic(
    n_frames: int = 20,
    profile: str = "hdl64",
    n_azimuth: int = 1800,
    speed: float = 1.0,
    seed: int = 0,
    device: str = "cuda",
):
    """Drive the pipeline over a simulated straight run; returns
    (pipeline, results, true positions)."""
    cfg = PROFILES[profile]
    pipe = Pipeline(cfg, device=device)
    results = []
    truth = []
    for pos, xyz, mask in synthetic_frames(n_frames, cfg, n_azimuth, speed,
                                           seed):
        results.append(pipe.process_frame(xyz, mask))
        truth.append(pos)
    pipe._retire_mapping(wait=True)
    return pipe, results, np.asarray(truth)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="light_loam_tpu_torch SLAM pipeline (PyTorch/CUDA)")
    ap.add_argument("--synthetic", action="store_true",
                    help="run on the synthetic world (the only input the "
                         "port reads so far)")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--profile", default="hdl64", choices=sorted(PROFILES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if not args.synthetic:
        ap.error("only --synthetic input is ported so far")
    t0 = time.time()
    pipe, results, truth = run_synthetic(
        n_frames=args.frames, profile=args.profile, device=args.device)
    err = np.linalg.norm(results[-1].odom_t - truth[-1])
    print(f"frames: {len(results)}  final pose error: {err:.3f} m")
    print(f"wall: {time.time() - t0:.2f}s  dropped mapping frames: "
          f"{pipe.dropped_mapping_frames}")
    print(pipe.timers.report())


if __name__ == "__main__":
    main()
