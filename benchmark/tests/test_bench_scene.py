"""The ray caster on the card's code path against a frozen NumPy copy of
the program's simulator (utils/synthetic.py simulate_scan, without sweep
motion), on the ring road, for both sensors; the room's sweeps against its
faces."""

import math

import numpy as np
import pytest
import torch

from harness import scene, traffic
from reference.features import ring_ids


def _np_ground(o, d, ground_z):
    dz = d[:, 2]
    t = np.where(np.abs(dz) > 1e-9,
                 (ground_z - o[2]) / np.where(np.abs(dz) > 1e-9, dz, 1.0), np.inf)
    return np.where(t > 0, t, np.inf)


def _np_box(o, d, center, half, yaw):
    if yaw:
        c, s = np.cos(-yaw), np.sin(-yaw)
        rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        o = center + rz @ (o - center)
        d = d @ rz.T
    lo, hi = center - half, center + half
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        t0 = (lo[None, :] - o[None, :]) * inv
        t1 = (hi[None, :] - o[None, :]) * inv
    tmin = np.nanmax(np.minimum(t0, t1), axis=1)
    tmax = np.nanmin(np.maximum(t0, t1), axis=1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit & (t > 0), t, np.inf)


def np_scan(boxes, pos, yaw, n_rings, n_azimuth, lower, upper, phase, noise):
    vert = np.deg2rad(np.linspace(lower, upper, n_rings))
    azim = phase - np.linspace(0.0, 2.0 * np.pi, n_azimuth, endpoint=False)
    ca, sa = np.cos(azim), np.sin(azim)
    cv, sv = np.cos(vert), np.sin(vert)
    dx = ca[:, None] * cv[None, :]
    dy = sa[:, None] * cv[None, :]
    dz = np.broadcast_to(sv[None, :], dx.shape)
    dirs = np.stack([dx, dy, dz], axis=-1).reshape(-1, 3)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    dw = dirs @ rz.T
    t = _np_ground(pos, dw, scene.GROUND_Z)
    for c, h, y in zip(boxes.center, boxes.half, boxes.yaw):
        t = np.minimum(t, _np_box(pos, dw, c, h, y))
    hit = np.isfinite(t) & (t <= 80.0) & (t >= 0.5)
    t = np.where(hit, t, np.nan) + noise
    return (dirs * t[:, None])[hit].astype(np.float32)


SENSORS = {
    "hdl64": dict(n_rings=64, lower_deg=-24.9, upper_deg=2.0, n_azimuth=360,
                  max_range_m=80.0, min_return_m=0.5, range_noise_m=0.01),
    "vlp16": dict(n_rings=16, lower_deg=-15.0, upper_deg=15.0, n_azimuth=360,
                  max_range_m=80.0, min_return_m=0.5, range_noise_m=0.01),
}


@pytest.mark.parametrize("sensor", sorted(SENSORS))
@pytest.mark.parametrize("frame", [0, 40, 100])
def test_cast_matches_numpy_simulator(sensor, frame):
    s = SENSORS[sensor]
    boxes = scene.ring_road(7)
    route = {"kind": "ring", "radius_m": 25.0, "step_m": 1.0}
    pos, yaw = traffic.route_pose(route, frame)
    phase = 0.3 * 2 * math.pi / s["n_azimuth"]
    rng = np.random.default_rng(frame)
    noise = rng.normal(scale=0.01, size=s["n_rings"] * s["n_azimuth"])
    want = np_scan(boxes, pos, yaw, s["n_rings"], s["n_azimuth"],
                   s["lower_deg"], s["upper_deg"], phase, noise)
    got = scene.sweep(boxes, pos, yaw, s, phase, torch.as_tensor(noise),
                      "cpu").numpy()
    assert got.shape == want.shape and len(got) > 1000
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_ring_road_route_closes_a_lap():
    route = {"kind": "ring", "radius_m": 25.0, "step_m": 1.0}
    assert traffic.lap_frames(route) == 157
    p0, _ = traffic.route_pose(route, 0)
    p1, _ = traffic.route_pose(route, 157)
    np.testing.assert_allclose(p1, p0, atol=1e-9)
    step = np.linalg.norm(traffic.route_pose(route, 1)[0] - p0)
    assert abs(step - 1.0) < 1e-3


def test_vlp16_rings_land_on_0_to_15():
    s = SENSORS["vlp16"]
    mix = {"route": {"kind": "ring", "radius_m": 25.0, "step_m": 1.0},
           "lanes": 1}
    pts = scene.sweep(scene.ring_road(3), *traffic.route_pose(mix["route"], 5),
                      s, 0.001, torch.zeros(16 * 360), "cpu")
    scan = {"n_scans": 16}
    ring = ring_ids(pts.double(), scan)
    assert ring.min() == 0 and ring.max() == 15
    assert len(torch.unique(ring)) == 16


def test_same_seed_same_sweeps():
    s = SENSORS["vlp16"]
    mix = {"route": {"kind": "ring", "radius_m": 25.0, "step_m": 6.0,
                     "layout_seed": 17}, "lanes": 1}
    a = traffic.make_lap(mix, s, 8192, 2**31 + 11, 0, "cpu")
    b = traffic.make_lap(mix, s, 8192, 2**31 + 11, 0, "cpu")
    c = traffic.make_lap(mix, s, 8192, 12, 0, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    # every seed drives the same sweep positions, from another start
    shift = int(np.argmin(np.linalg.norm(c[2] - a[2][0], axis=1)))
    np.testing.assert_allclose(np.roll(c[2], -shift, axis=0), a[2], atol=1e-9)


@pytest.mark.parametrize("mix_name", ["office.live"])
def test_room_sweep_lands_on_its_inside_faces(mix_name):
    """With no furniture every return lies on the floor, a wall or the
    ceiling of the room that holds the sensor, and all 16 rings return."""
    import json

    from harness import manifest

    mix = json.loads((manifest.BENCH / "traffic" / f"{mix_name}.json").read_text())
    sc = dict(mix["scene"], furniture=0)
    mix = dict(mix, scene=sc, route=dict(mix["route"], frames=2))
    s = dict(SENSORS["vlp16"], n_azimuth=720)
    xyz, mask, pos, yaw = traffic.make_lap(mix, s, 65536, 2**31 + 3, 0, "cpu")
    assert int(mask[0].sum()) == 16 * 720
    cz, sz = math.cos(yaw[0]), math.sin(yaw[0])
    rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    w = xyz[0][mask[0]].double().numpy() @ rz.T + pos[0]
    cx, cy = 0.0, mix["route"]["radius_m"]
    floor = -sc["sensor_height_m"]
    on = np.stack([np.abs(np.abs(w[:, 0] - cx) - sc["half_x_m"]),
                   np.abs(np.abs(w[:, 1] - cy) - sc["half_y_m"]),
                   np.abs(w[:, 2] - floor),
                   np.abs(w[:, 2] - floor - sc["height_m"])], axis=1).min(1)
    assert on.max() < 0.06
    assert (np.abs(w[:, 2] - floor) < 0.06).sum() > 1000
    ring = ring_ids(xyz[0][mask[0]].double(), {"n_scans": 16})
    assert ring.min() == 0 and ring.max() == 15
    assert len(torch.unique(ring)) == 16


def test_room_furniture_stays_clear_of_the_route():
    import json

    from harness import manifest

    for name in ("office.live",):
        mix = json.loads((manifest.BENCH / "traffic" / f"{name}.json").read_text())
        b = traffic.layout(mix, 0)
        r = mix["route"]["radius_m"]
        rel = b.center[1:, :2] - np.array([0.0, r])
        extent = np.hypot(b.half[1:, 0], b.half[1:, 1])
        assert len(rel) == mix["scene"]["furniture"]
        assert (np.hypot(rel[:, 0], rel[:, 1]) >= r + extent + 0.6).all()
        assert (np.abs(rel[:, 0]) + extent <= mix["scene"]["half_x_m"]).all()
