"""Quick-look visualization — the reference's rviz surface, headless.

Counterpart of ``light_loam_tpu/utils/viz.py``.  matplotlib is imported
only when a plot is drawn (``_require_agg``): the package itself runs
without it, and a render without it raises.

The reference ships an rviz config (`rviz_cfg/aloam_velodyne.rviz`) that
overlays GT / odometry / mapped paths and renders the cube-map clouds
(topics cited at rviz_cfg/aloam_velodyne.rviz:82,132,189,217,247,277).
This module is the headless equivalent: render trajectories and
a top-down map view to PNG with matplotlib (no ROS, no display needed).

Complements `utils/export.py`'s PLY writers (for real 3-D viewers).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _require_agg():
    try:
        import matplotlib
    except ImportError as e:
        raise ModuleNotFoundError(
            "utils/viz.py (the --viz dashboard) needs matplotlib, which is "
            "not installed here") from e

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_trajectories(
    path: str,
    trajectories: Sequence[Tuple[str, np.ndarray]],
    title: str = "trajectory (top-down)",
) -> str:
    """Overlay named (N,3) position tracks in the x-y plane.

    ``trajectories`` is ``[(label, positions), ...]`` — typically
    ``[("gt", gt), ("odometry", odo), ("mapped", mapped)]``, mirroring the
    reference's rviz path overlay of /path_gt, /laser_odom_path and the
    aft-mapped path.
    """
    plt = _require_agg()
    fig, ax = plt.subplots(figsize=(7, 7))
    for label, pos in trajectories:
        pos = np.asarray(pos)
        if len(pos) == 0:
            continue
        ax.plot(pos[:, 0], pos[:, 1], label=label, linewidth=1.2)
        ax.plot(pos[0, 0], pos[0, 1], "o", markersize=4, color="black")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_map_topdown(
    path: str,
    surf_xyz: np.ndarray,
    surf_mask: np.ndarray,
    corner_xyz: Optional[np.ndarray] = None,
    corner_mask: Optional[np.ndarray] = None,
    trajectory: Optional[np.ndarray] = None,
    max_points: int = 60000,
    title: str = "map (top-down)",
) -> str:
    """Scatter the map stores in the x-y plane, z as color, optional
    trajectory overlay — the /laser_cloud_map quick look."""
    plt = _require_agg()
    fig, ax = plt.subplots(figsize=(8, 8))

    def _scatter(xyz, mask, cmap, size, label):
        xyz = np.asarray(xyz)
        m = np.asarray(mask).astype(bool)
        pts = xyz[m]
        if len(pts) == 0:
            return
        if len(pts) > max_points:
            idx = np.random.default_rng(0).choice(
                len(pts), max_points, replace=False
            )
            pts = pts[idx]
        ax.scatter(pts[:, 0], pts[:, 1], c=pts[:, 2], cmap=cmap, s=size,
                   alpha=0.5, label=f"{label} ({int(m.sum())} pts)")

    _scatter(surf_xyz, surf_mask, "viridis", 1.0, "surf")
    if corner_xyz is not None:
        _scatter(corner_xyz, corner_mask, "autumn", 2.0, "corner")
    if trajectory is not None:
        t = np.asarray(trajectory)
        ax.plot(t[:, 0], t[:, 1], color="red", linewidth=1.5,
                label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def render_pipeline(pipe, path_prefix: str,
                    gt: Optional[np.ndarray] = None) -> dict:
    """One-call dashboard for a `models.pipeline.Pipeline`: trajectory
    overlay + top-down map PNGs. Returns {name: path}."""
    from light_loam_tpu_torch.models.mapping import full_map_cloud

    mapped = pipe.mapped_positions()  # waits for in-flight mapping
    (cx, cm), (sx, sm) = (tuple(a.cpu().numpy() for a in pair)
                          for pair in full_map_cloud(pipe.map_state))
    if len(mapped) < 2:
        mapped = None

    out = {}
    tracks = []
    if gt is not None:
        tracks.append(("gt", gt))
    if mapped is not None:
        tracks.append(("mapped", mapped))
    if tracks:
        out["trajectory"] = plot_trajectories(
            f"{path_prefix}_traj.png", tracks
        )
    out["map"] = plot_map_topdown(
        f"{path_prefix}_map.png",
        sx, sm, cx, cm,
        trajectory=mapped,
    )
    # interactive 3-D orbit/pan/zoom view (the rviz stand-in proper)
    from light_loam_tpu_torch.utils.html_viewer import export_pipeline_html

    out["html"] = export_pipeline_html(pipe, f"{path_prefix}_view.html",
                                       gt=gt)
    return out
