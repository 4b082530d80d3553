"""Visualization exports — the rviz-equivalent observability surface.

A copy of ``light_loam_tpu/utils/export.py`` (NumPy only).  The
reference's dashboards are ROS topics rendered in rviz
(rviz_cfg/aloam_velodyne.rviz).  Here the same artifacts export to
standard files: point clouds to PLY (any viewer), trajectories to PLY
line sets or KITTI text.
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, xyz: np.ndarray, mask: np.ndarray | None = None,
              color: tuple | None = None) -> int:
    """Write an ASCII PLY point cloud; returns the number of points."""
    pts = np.asarray(xyz, dtype=np.float32)
    if mask is not None:
        pts = pts[np.asarray(mask)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if color is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in pts:
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if color is not None:
                line += f" {color[0]} {color[1]} {color[2]}"
            f.write(line + "\n")
    return len(pts)


def write_trajectory_ply(path: str, positions: np.ndarray) -> int:
    """Write a trajectory as a PLY polyline (vertices + edges)."""
    pos = np.asarray(positions, dtype=np.float32)
    n = len(pos)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {max(n - 1, 0)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p in pos:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        for i in range(n - 1):
            f.write(f"{i} {i + 1}\n")
    return n
