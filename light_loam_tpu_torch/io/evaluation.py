"""Trajectory evaluation: KITTI odometry devkit-style metrics.

A copy of ``light_loam_tpu/io/evaluation.py`` (NumPy only).  The
reference only WRITES the first-pose-relative trajectory file
(laserMapping.cpp:2284-2326) and leaves scoring to external tooling
(KITTI devkit / evo).  This module vendors the standard metrics so the
repo's test pyramid can gate accuracy (SURVEY.md §4):

  * ATE — RMSE of translation after first-pose alignment;
  * KITTI relative errors — translational drift (%) and rotational drift
    (deg/m) averaged over all subsequences of length 100..800 m.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def _to_homogeneous(poses: np.ndarray) -> np.ndarray:
    """(N, 3, 4) -> (N, 4, 4)."""
    n = len(poses)
    H = np.tile(np.eye(4), (n, 1, 1))
    H[:, :3, :] = poses
    return H


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length at each frame from (N, 3, 4) poses."""
    t = poses[:, :, 3]
    steps = np.linalg.norm(np.diff(t, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of translation; both (N, 3, 4), same (first-pose) frame."""
    n = min(len(est), len(gt))
    err = est[:n, :, 3] - gt[:n, :, 3]
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


@dataclass
class KittiErrors:
    t_err_percent: float    # translational drift, %
    r_err_deg_per_m: float  # rotational drift, deg/m
    n_segments: int


def kitti_relative_errors(
    est: np.ndarray,
    gt: np.ndarray,
    lengths: Tuple[float, ...] = KITTI_LENGTHS,
    step: int = 10,
) -> KittiErrors:
    """The KITTI odometry benchmark metric: for every start frame (every
    ``step`` frames) and segment length, compare relative motion of
    estimate vs ground truth over that segment."""
    n = min(len(est), len(gt))
    est_h = _to_homogeneous(est[:n])
    gt_h = _to_homogeneous(gt[:n])
    dist = trajectory_distances(gt[:n])

    t_errs: List[float] = []
    r_errs: List[float] = []
    for first in range(0, n, step):
        for length in lengths:
            # first frame at >= length metres further along the path
            target = dist[first] + length
            last = int(np.searchsorted(dist, target))
            if last >= n:
                continue
            gt_rel = np.linalg.inv(gt_h[first]) @ gt_h[last]
            est_rel = np.linalg.inv(est_h[first]) @ est_h[last]
            err = np.linalg.inv(est_rel) @ gt_rel
            t_err = np.linalg.norm(err[:3, 3])
            # rotation angle of the error
            c = (np.trace(err[:3, :3]) - 1.0) * 0.5
            r_err = np.arccos(np.clip(c, -1.0, 1.0))
            t_errs.append(t_err / length)
            r_errs.append(r_err / length)
    if not t_errs:
        return KittiErrors(float("nan"), float("nan"), 0)
    return KittiErrors(
        t_err_percent=100.0 * float(np.mean(t_errs)),
        r_err_deg_per_m=float(np.degrees(np.mean(r_errs))),
        n_segments=len(t_errs),
    )


def main(argv=None):
    """CLI: score a trajectory file against ground truth.

    usage: python -m light_loam_tpu_torch.io.evaluation EST.txt GT.txt
    Both files are KITTI 3×4 row-major pose-per-line (the reference's
    RESULT_PATH format).
    """
    import sys

    args = sys.argv[1:] if argv is None else list(argv)
    if len(args) != 2:
        print(__doc__ or "", file=sys.stderr)
        print("usage: python -m light_loam_tpu_torch.io.evaluation EST.txt "
              "GT.txt", file=sys.stderr)
        raise SystemExit(2)
    from light_loam_tpu_torch.io.kitti import read_gt_poses

    est = read_gt_poses(args[0])
    gt = read_gt_poses(args[1])
    ate = ate_rmse(est, gt)
    rel = kitti_relative_errors(est, gt)
    print(f"frames: {min(len(est), len(gt))}")
    print(f"ATE RMSE: {ate:.4f} m")
    if rel.n_segments:
        print(f"KITTI t_err: {rel.t_err_percent:.3f} %   "
              f"r_err: {rel.r_err_deg_per_m:.5f} deg/m   "
              f"({rel.n_segments} segments)")
    else:
        print("KITTI relative errors: trajectory shorter than 100 m")


def poses_from_quat_trans(qs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """(N,4) xyzw quaternions + (N,3) translations -> (N, 3, 4); the
    rotation is formed in the quaternions' own precision."""
    qs = np.asarray(qs)
    x, y, z, w = qs[:, 0], qs[:, 1], qs[:, 2], qs[:, 3]
    R = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(-1, 3, 3)
    out = np.zeros((len(qs), 3, 4))
    out[:, :, :3] = R
    out[:, :, 3] = ts
    return out


if __name__ == "__main__":
    main()
