"""The scenes (a ring road, a room) and a spinning LiDAR ray-cast on the
card.

A frozen copy of the scene of ``light_loam_tpu_torch/utils/synthetic.py``
(``World.loop``: ground plane, box buildings and square posts on both sides
of a circular road) and of its ``simulate_scan``, rewritten to cast every
ray of a sweep at once with PyTorch on whatever device it is given.  The
benchmark owns this copy: a later change to the program's simulator does
not change the sweeps the benchmark feeds.

The room (``room``) is the benchmark's own: one box that holds the sensor,
whose inside faces are the floor, the walls and the ceiling, with furniture
standing on its floor; the caster finds a box's inside faces as it finds
its outside ones.

Geometry follows the KITTI velodyne convention (x forward, y left, z up,
the sensor 1.73 m above the ground).  Points are emitted azimuth-major (all
rings of one azimuth column, then the next), the head turning clockwise so
that ``-atan2(y, x)`` grows over the sweep, as a Velodyne does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

GROUND_Z = -1.73


@dataclass
class Boxes:
    """Oriented boxes as arrays: centre (n, 3), half sizes (n, 3), yaw (n,)."""

    center: np.ndarray
    half: np.ndarray
    yaw: np.ndarray


def ring_road(seed: int, radius: float = 25.0, corridor_half_width: float = 6.0,
              n_boxes: int = 28, n_posts: int = 24) -> Boxes:
    """``World.loop``'s layout: the road is the circle of ``radius`` about
    (0, radius); buildings and posts stand on both sides of the annulus
    [radius - cw, radius + cw] all the way round.  The same draws in the
    same order as the program's simulator, so one seed gives one world."""
    rng = np.random.default_rng(seed)
    centre = np.array([0.0, radius])
    cs, hs, ys = [], [], []
    for _ in range(n_boxes):
        hx = rng.uniform(2.0, 6.0)
        hy = rng.uniform(2.0, 6.0)
        hz = rng.uniform(3.0, 10.0)
        yaw = rng.uniform(-np.pi, np.pi)
        extent = float(np.hypot(hx, hy))
        inner = rng.random() < 0.4
        if inner:
            rr = radius - corridor_half_width - extent - rng.uniform(0.0, 6.0)
            if rr < extent + 1.0:
                inner = False
        if not inner:
            rr = radius + corridor_half_width + extent + rng.uniform(0.0, 12.0)
        th = rng.uniform(0, 2 * np.pi)
        cx, cy = centre + rr * np.array([np.sin(th), -np.cos(th)])
        cs.append([cx, cy, GROUND_Z + hz])
        hs.append([hx, hy, hz])
        ys.append(yaw)
    for _ in range(n_posts):
        side = rng.choice([-1.0, 1.0])
        rr = radius + side * rng.uniform(corridor_half_width * 0.6,
                                         corridor_half_width * 0.95)
        th = rng.uniform(0, 2 * np.pi)
        cx, cy = centre + rr * np.array([np.sin(th), -np.cos(th)])
        r = rng.uniform(0.08, 0.2)
        h = rng.uniform(4.0, 8.0)
        cs.append([cx, cy, GROUND_Z + h / 2])
        hs.append([r, r, h / 2])
        ys.append(0.0)
    return Boxes(np.asarray(cs), np.asarray(hs), np.asarray(ys))


def room(seed: int, centre, half_x: float, half_y: float, height: float,
         sensor_height: float, clear_radius: float, n_furniture: int) -> Boxes:
    """A room of ``2 half_x`` by ``2 half_y`` by ``height`` metres about
    ``centre`` (x, y), its floor ``sensor_height`` below the sensor, and
    ``n_furniture`` boxes (cabinets, tables, pillars) drawn from the seed
    on its floor, against the walls and clear of the circle of
    ``clear_radius`` about the centre that the sensor drives."""
    rng = np.random.default_rng(seed)
    floor = -sensor_height
    cs = [[centre[0], centre[1], floor + height / 2.0]]
    hs = [[half_x, half_y, height / 2.0]]
    ys = [0.0]
    while len(cs) < n_furniture + 1:
        hx = rng.uniform(0.15, 0.6)
        hy = rng.uniform(0.15, 0.6)
        hz = rng.uniform(0.2, 0.9)
        yaw = rng.uniform(-np.pi / 6, np.pi / 6)
        extent = float(np.hypot(hx, hy))
        x = rng.uniform(-half_x + extent, half_x - extent)
        y = rng.uniform(-half_y + extent, half_y - extent)
        if np.hypot(x, y) < clear_radius + extent + 0.6:
            continue
        cs.append([centre[0] + x, centre[1] + y, floor + hz])
        hs.append([hx, hy, hz])
        ys.append(yaw)
    return Boxes(np.asarray(cs), np.asarray(hs), np.asarray(ys))


def ray_directions(n_rings: int, n_azimuth: int, lower_deg: float,
                   upper_deg: float, phase: float, device,
                   dtype=torch.float64) -> torch.Tensor:
    """(n_azimuth * n_rings, 3) unit directions in the sensor frame,
    azimuth-major, the sweep turning clockwise from ``phase``."""
    vert = torch.deg2rad(torch.linspace(lower_deg, upper_deg, n_rings,
                                        dtype=dtype, device=device))
    azim = phase - torch.arange(n_azimuth, dtype=dtype, device=device) * (
        2.0 * math.pi / n_azimuth)
    ca, sa = torch.cos(azim), torch.sin(azim)
    cv, sv = torch.cos(vert), torch.sin(vert)
    dx = ca[:, None] * cv[None, :]
    dy = sa[:, None] * cv[None, :]
    dz = sv[None, :].expand_as(dx)
    return torch.stack([dx, dy, dz], dim=-1).reshape(-1, 3)


def cast(boxes: Boxes, origin: torch.Tensor, dirs_w: torch.Tensor,
         max_range: float, min_range: float) -> torch.Tensor:
    """Distance along each world-frame ray to the first surface (ground or
    box), ``inf`` where nothing is hit inside [min_range, max_range]."""
    dev, dt = dirs_w.device, dirs_w.dtype
    dz = dirs_w[:, 2]
    ok = dz.abs() > 1e-9
    t = torch.where(ok, (GROUND_Z - origin[2]) / torch.where(ok, dz, 1.0),
                    torch.full_like(dz, math.inf))
    t = torch.where(t > 0, t, torch.full_like(t, math.inf))

    c = torch.as_tensor(boxes.center, dtype=dt, device=dev)     # (B, 3)
    h = torch.as_tensor(boxes.half, dtype=dt, device=dev)
    yaw = torch.as_tensor(boxes.yaw, dtype=dt, device=dev)
    cy, sy = torch.cos(-yaw), torch.sin(-yaw)
    # the ray in each box's own frame: rotate by -yaw about the box centre
    rel = origin[None, :] - c                                    # (B, 3)
    o_b = torch.stack([c[:, 0] + cy * rel[:, 0] - sy * rel[:, 1],
                       c[:, 1] + sy * rel[:, 0] + cy * rel[:, 1],
                       origin[2].expand_as(c[:, 2])], dim=-1)    # (B, 3)
    dx, dy = dirs_w[:, 0:1], dirs_w[:, 1:2]                     # (N, 1)
    d_b = torch.stack([cy[None, :] * dx - sy[None, :] * dy,
                       sy[None, :] * dx + cy[None, :] * dy,
                       dirs_w[:, 2:3].expand(-1, c.shape[0])], dim=-1)  # (N, B, 3)
    inv = 1.0 / d_b
    t0 = ((c - h) - o_b)[None] * inv
    t1 = ((c + h) - o_b)[None] * inv
    lo = torch.minimum(t0, t1).nan_to_num(nan=-math.inf, posinf=math.inf,
                                          neginf=-math.inf)
    hi = torch.maximum(t0, t1).nan_to_num(nan=math.inf, posinf=math.inf,
                                          neginf=-math.inf)
    tmin = lo.amax(dim=-1)
    tmax = hi.amin(dim=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    tb = torch.where(tmin > 0, tmin, tmax)
    tb = torch.where(hit & (tb > 0), tb, torch.full_like(tb, math.inf))
    t = torch.minimum(t, tb.amin(dim=-1))
    return torch.where((t <= max_range) & (t >= min_range), t,
                       torch.full_like(t, math.inf))


def sweep(boxes: Boxes, position, yaw: float, sensor: dict, phase: float,
          noise: torch.Tensor, device) -> torch.Tensor:
    """One sweep's returns in the sensor frame, (n, 3) float32 in sweep
    order.  ``noise`` (n_azimuth * n_rings,) is the radial range noise of
    every ray, in metres."""
    dirs = ray_directions(sensor["n_rings"], sensor["n_azimuth"],
                          sensor["lower_deg"], sensor["upper_deg"], phase,
                          device)
    cz, sz = math.cos(yaw), math.sin(yaw)
    rz = torch.tensor([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]],
                      dtype=dirs.dtype, device=device)
    origin = torch.as_tensor(np.asarray(position, np.float64), device=device)
    t = cast(boxes, origin, dirs @ rz.T, sensor["max_range_m"],
             sensor["min_return_m"])
    hit = torch.isfinite(t)
    pts = dirs * (t + noise.to(dirs.dtype))[:, None]
    return pts[hit].to(torch.float32)
