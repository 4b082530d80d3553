"""Synthetic spinning-LiDAR scene simulator (host-side, NumPy).

Generates HDL-64-like sweeps of a procedurally built urban scene (ground
plane, box "buildings", cylindrical poles) from arbitrary sensor poses.
Used by tests and benchmarks in place of KITTI data (which is not vendored);
the geometry matches the KITTI velodyne convention: x forward, y left,
z up, sensor ~1.73 m above ground.

Points are emitted in azimuth-major sweep order (all rings per azimuth
column), matching a rotating head, which is what the reference's
start/end-orientation unwrap logic expects.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Box:
    center: np.ndarray  # (3,)
    half: np.ndarray    # (3,)
    yaw: float = 0.0    # rotation about z


@dataclass
class Pole:
    center: np.ndarray  # (2,) xy
    radius: float
    z0: float
    z1: float


@dataclass
class World:
    ground_z: float = -1.73
    boxes: list = field(default_factory=list)
    poles: list = field(default_factory=list)

    @staticmethod
    def urban(
        seed: int = 0,
        n_boxes: int = 14,
        n_poles: int = 12,
        cylinder_poles: bool = False,
    ) -> "World":
        """Ground + box buildings + vertical posts.

        Posts are thin square boxes by default: cylinder silhouettes are
        viewpoint-dependent (the visible arc's centroid moves with the
        sensor), which injects a parallax-proportional registration bias
        that is an artifact of ray-traced synthetic data, not of real
        scans — measured at ~9% of the inter-frame baseline on the
        mapping stage.  Pass ``cylinder_poles=True`` to get the harder
        (biased) variant for robustness probing.
        """
        rng = np.random.default_rng(seed)
        w = World()
        for _ in range(n_boxes):
            side = rng.choice([-1.0, 1.0])
            hx = rng.uniform(4.0, 15.0)
            hy = rng.uniform(2.0, 8.0)
            hz = rng.uniform(3.0, 12.0)
            # varied orientations give surfaces at all angles, like real
            # streets — axis-aligned-only worlds under-constrain the solve
            # and correlate sampling artifacts
            yaw = rng.uniform(-0.5, 0.5)
            # keep the driving corridor (|y| ≲ 6 m around the x axis) clear
            # of building footprints, whatever the rotation
            extent = float(np.hypot(hx, hy))
            cy = side * (6.0 + extent + rng.uniform(0.0, 15.0))
            cx = rng.uniform(-60.0, 120.0)
            w.boxes.append(
                Box(center=np.array([cx, cy, w.ground_z + hz]),
                    half=np.array([hx, hy, hz]), yaw=yaw)
            )
        for _ in range(n_poles):
            side = rng.choice([-1.0, 1.0])
            cy = side * rng.uniform(4.0, 7.0)
            cx = rng.uniform(-40.0, 100.0)
            r = rng.uniform(0.08, 0.2)
            h = rng.uniform(4.0, 8.0)
            if cylinder_poles:
                w.poles.append(
                    Pole(center=np.array([cx, cy]), radius=r,
                         z0=w.ground_z, z1=w.ground_z + h)
                )
            else:
                w.boxes.append(
                    Box(center=np.array([cx, cy, w.ground_z + h / 2]),
                        half=np.array([r, r, h / 2]))
                )
        return w

    @staticmethod
    def loop(
        seed: int = 0,
        radius: float = 25.0,
        corridor_half_width: float = 6.0,
        n_boxes: int = 28,
        n_posts: int = 24,
    ) -> "World":
        """Ring-road world for closed-loop trajectory gates.

        ``urban`` keeps only the straight |y| ≲ 6 m corridor clear, so a
        circular trajectory drives straight through building footprints
        (and the far side of the loop leaves the populated band entirely).
        Here the clear annulus follows the loop itself: the nominal path is
        the circle of ``radius`` centered at (0, radius); buildings and
        posts are scattered on both sides of the annulus
        [radius - cw, radius + cw], all the way around, so every heading
        sees structure at comparable range.
        """
        rng = np.random.default_rng(seed)
        center = np.array([0.0, radius])
        w = World()
        for _ in range(n_boxes):
            hx = rng.uniform(2.0, 6.0)
            hy = rng.uniform(2.0, 6.0)
            hz = rng.uniform(3.0, 10.0)
            yaw = rng.uniform(-np.pi, np.pi)
            extent = float(np.hypot(hx, hy))
            inner = rng.random() < 0.4
            if inner:
                rr = radius - corridor_half_width - extent - rng.uniform(0.0, 6.0)
                if rr < extent + 1.0:  # too big for the island: push outside
                    inner = False
            if not inner:
                rr = radius + corridor_half_width + extent + rng.uniform(0.0, 12.0)
            th = rng.uniform(0, 2 * np.pi)
            cx, cy = center + rr * np.array([np.sin(th), -np.cos(th)])
            w.boxes.append(
                Box(center=np.array([cx, cy, w.ground_z + hz]),
                    half=np.array([hx, hy, hz]), yaw=yaw)
            )
        for _ in range(n_posts):
            side = rng.choice([-1.0, 1.0])
            rr = radius + side * rng.uniform(
                corridor_half_width * 0.6, corridor_half_width * 0.95
            )
            th = rng.uniform(0, 2 * np.pi)
            cx, cy = center + rr * np.array([np.sin(th), -np.cos(th)])
            r = rng.uniform(0.08, 0.2)
            h = rng.uniform(4.0, 8.0)
            w.boxes.append(
                Box(center=np.array([cx, cy, w.ground_z + h / 2]),
                    half=np.array([r, r, h / 2]))
            )
        return w

    @staticmethod
    def corridor(
        seed: int = 0,
        length: float = 200.0,
        half_width: float = 4.0,
        n_clutter: int = 6,
        end_wall_x: float | None = None,
    ) -> "World":
        """Long straight corridor — near-degenerate geometry.

        Two parallel walls constrain lateral translation, roll, pitch and
        yaw but leave forward (x) translation unobservable from the wall
        planes; the classic LiDAR-SLAM failure mode.  Measured behavior
        (probes 2026-08-17): forward motion is under-tracked ~10x even
        with clutter AND a corridor end wall in sensor range
        (``end_wall_x``), because (a) the noise-jittered normals of the
        thousands of degenerate triangle-plane factors inflate H_xx
        without contributing signal to g_x, shrinking every Newton step
        along the weak axis, and (b) the correspondence vote REJECTS the
        few informative end-wall matches — under an along-axis slip the
        degenerate majority stays mutually distance-consistent while
        correct wall-end matches disagree with it.  Both mechanisms are
        inherent to the reference's algorithm (same factors, same vote
        mathematics): this world reproduces the textbook "LOAM drifts in
        corridors" degeneracy in its purest form.  Gate graceful
        degradation here (finite poses, off-axis pinned), not tracking.
        """
        rng = np.random.default_rng(seed)
        w = World()
        wall_h = 3.0
        for side in (-1.0, 1.0):
            w.boxes.append(
                Box(center=np.array([length / 2 - 20.0,
                                     side * (half_width + 0.2),
                                     w.ground_z + wall_h]),
                    half=np.array([length / 2, 0.2, wall_h]))
            )
        if end_wall_x is not None:
            w.boxes.append(
                Box(center=np.array([end_wall_x + 0.2, 0.0,
                                     w.ground_z + wall_h]),
                    half=np.array([0.2, half_width + 0.5, wall_h]))
            )
        for _ in range(n_clutter):
            side = rng.choice([-1.0, 1.0])
            cx = rng.uniform(-15.0, length - 30.0)
            d = rng.uniform(0.3, 0.8)
            hh = rng.uniform(0.6, 1.6)
            hw = rng.uniform(0.3, 0.9)
            w.boxes.append(
                Box(center=np.array([cx, side * (half_width - d), w.ground_z + hh]),
                    half=np.array([hw, d * 0.8, hh]))
            )
        return w


def _ray_ground(o, d, ground_z):
    dz = d[:, 2]
    t = np.where(np.abs(dz) > 1e-9, (ground_z - o[2]) / np.where(np.abs(dz) > 1e-9, dz, 1.0), np.inf)
    return np.where(t > 0, t, np.inf)


def _ray_box(o, d, box: Box):
    if box.yaw:
        c, s = np.cos(-box.yaw), np.sin(-box.yaw)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        o = box.center + Rz @ (o - box.center)
        d = d @ Rz.T
    lo = box.center - box.half
    hi = box.center + box.half
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        t0 = (lo[None, :] - o[None, :]) * inv
        t1 = (hi[None, :] - o[None, :]) * inv
    tmin = np.nanmax(np.minimum(t0, t1), axis=1)
    tmax = np.nanmin(np.maximum(t0, t1), axis=1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit & (t > 0), t, np.inf)


def _ray_pole(o, d, pole: Pole):
    ox, oy = o[0] - pole.center[0], o[1] - pole.center[1]
    dx, dy = d[:, 0], d[:, 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - pole.radius**2
    disc = b * b - 4 * a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = np.sqrt(np.maximum(disc, 0.0))
    t = (-b - sq) / np.where(a > 1e-12, 2 * a, 1.0)
    z = o[2] + t * d[:, 2]
    ok = ok & (t > 0) & (z >= pole.z0) & (z <= pole.z1)
    return np.where(ok, t, np.inf)


def simulate_scan(
    world: World,
    sensor_pos: np.ndarray,
    sensor_yaw: float = 0.0,
    n_rings: int = 64,
    n_azimuth: int = 1800,
    lower_deg: float = -24.9,
    upper_deg: float = 2.0,
    max_range: float = 80.0,
    noise: float = 0.0,
    seed: int = 0,
    azimuth_jitter: bool = True,
    sweep_motion: np.ndarray | None = None,
    motion_segments: int = 24,
) -> np.ndarray:
    """Return (N, 3) float32 points in the sensor frame, sweep-ordered.

    ``azimuth_jitter`` randomizes the sweep's starting phase per frame;
    without it every frame samples the world at identical ray angles,
    which creates correlated discretization bias that real spinning
    sensors do not have.

    ``sweep_motion``: world-frame displacement (3,) of the sensor over ONE
    full sweep — models the intra-sweep motion ("rolling shutter") that
    the reference's TransformToStart undistortion hook compensates
    (laserOdometry.cpp:77-95, DISTORTION flag at :23).  Each return is
    expressed relative to the sensor's *instantaneous* position, like a
    real spinning head; ``sensor_pos`` is the sweep-START position.  The
    motion is staircase-approximated over ``motion_segments`` azimuth
    blocks (exact per-column origins would loop Python over every column).
    """
    rng = np.random.default_rng(seed)
    vert = np.deg2rad(np.linspace(lower_deg, upper_deg, n_rings))
    phase = rng.uniform(0, 2 * np.pi / n_azimuth) if azimuth_jitter else 0.0
    # clockwise sweep (azimuth decreasing): a real Velodyne rotates so
    # that ori = -atan2(y, x) INCREASES over the sweep — the convention
    # the reference's start/end unwrap assumes (scanRegistration.cpp:
    # 114-126).  With the opposite direction the halfPassed logic
    # mis-unwraps and relTime (hence the undistortion fraction s) is
    # garbage; harmless at DISTORTION 0, fatal with the hook on.
    azim = phase - np.linspace(0.0, 2.0 * np.pi, n_azimuth, endpoint=False)

    ca, sa = np.cos(azim), np.sin(azim)
    cv, sv = np.cos(vert), np.sin(vert)
    # (A, R, 3) direction grid in sensor frame, azimuth-major.
    dx = ca[:, None] * cv[None, :]
    dy = sa[:, None] * cv[None, :]
    dz = np.broadcast_to(sv[None, :], dx.shape)
    dirs = np.stack([dx, dy, dz], axis=-1).reshape(-1, 3)

    cy, sy = np.cos(sensor_yaw), np.sin(sensor_yaw)
    Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    dirs_w = dirs @ Rz.T
    o0 = np.asarray(sensor_pos, dtype=np.float64)

    def trace(o, dw):
        t = _ray_ground(o, dw, world.ground_z)
        for box in world.boxes:
            t = np.minimum(t, _ray_box(o, dw, box))
        for pole in world.poles:
            t = np.minimum(t, _ray_pole(o, dw, pole))
        return t

    if sweep_motion is None:
        t = trace(o0, dirs_w)
    else:
        motion = np.asarray(sweep_motion, dtype=np.float64)
        per_ring = n_rings
        t = np.empty(len(dirs_w))
        bounds = np.linspace(0, n_azimuth, motion_segments + 1).astype(int)
        for si in range(motion_segments):
            a0, a1 = bounds[si], bounds[si + 1]
            if a1 <= a0:
                continue
            frac = (a0 + a1) / 2.0 / n_azimuth
            sl = slice(a0 * per_ring, a1 * per_ring)
            t[sl] = trace(o0 + frac * motion, dirs_w[sl])

    hit = np.isfinite(t) & (t <= max_range) & (t >= 0.5)
    t = np.where(hit, t, np.nan)
    if noise > 0:
        # radial (along-ray) range noise — how real lidar noise behaves.
        # Isotropic 3-D jitter would be unphysical: on smooth surfaces it
        # turns into curvature spikes that read as fake edge features and
        # bias any scan matcher (measured: 2 cm iid-3D noise shrinks
        # odometry increments by ~19%; radial noise does not).
        t = t + rng.normal(scale=noise, size=t.shape)
    pts = dirs * t[:, None]  # sensor-frame points
    pts = pts[hit]
    return pts.astype(np.float32)


def pad_cloud(pts: np.ndarray, capacity: int):
    """Pad an (N, 3) cloud to (capacity, 3) + mask."""
    n = min(len(pts), capacity)
    xyz = np.zeros((capacity, 3), np.float32)
    mask = np.zeros((capacity,), bool)
    xyz[:n] = pts[:n]
    mask[:n] = True
    return xyz, mask
