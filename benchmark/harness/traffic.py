"""The general sweep generator: a traffic mix's parameters to a lap of
padded sweeps.

A mix file (``benchmark/traffic/<mix>.json``) names its driver and gives
the route (a circle of a radius, driven at a step a frame), the scene (the
ring road round that circle, or with a ``scene`` of kind ``room`` a room
round it; laid out from the mix's ``layout_seed`` and the lane), the
number of independent lanes and the driver's counts.  ``--seed`` and the
lane set where on the lap the lane starts, and each sweep's azimuth phase
and range noise: every seed drives the same sweep positions through the
same world, in another order (a lap rotated), so a seed changes the order
and the noise of the work and not its amount.

The lap is made on the card, one sweep a call of the ray caster, and held
in pinned host memory as the padded ``xyz`` / ``mask`` arrays a LiDAR
driver hands over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import scene


def derived_seed(*parts: int) -> int:
    """A 63-bit seed from any whole numbers (``--seed`` may pass 2**31)."""
    ss = np.random.SeedSequence([int(p) % (2**64) for p in parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def route_pose(route: dict, frame: int):
    """(position (3,), yaw) of ``frame`` on the route: the circle of
    ``radius_m`` about (0, radius), driven anticlockwise from the origin
    heading +x, about ``step_m`` a frame: the lap is split into
    ``lap_frames`` equal steps, so that it closes on itself."""
    if route["kind"] != "ring":
        raise ValueError(f"unknown route kind {route['kind']!r}")
    r = route["radius_m"]
    th = 2.0 * math.pi * (frame % lap_frames(route)) / lap_frames(route)
    return np.array([r * math.sin(th), r - r * math.cos(th), 0.0]), th


def lap_frames(route: dict) -> int:
    """Sweeps in one lap: the circumference over the step, rounded."""
    return int(round(2.0 * math.pi * route["radius_m"] / route["step_m"]))


def layout(mix: dict, lane: int) -> scene.Boxes:
    """The world of lane ``lane``: the mix's ``scene`` (default: the ring
    road) about the route's circle, from the mix's ``layout_seed``."""
    route = mix["route"]
    seed = derived_seed(route["layout_seed"], lane)
    sc = mix.get("scene", {"kind": "ring_road"})
    if sc["kind"] == "ring_road":
        return scene.ring_road(seed, route["radius_m"])
    if sc["kind"] == "room":
        return scene.room(seed, (0.0, route["radius_m"]), sc["half_x_m"],
                          sc["half_y_m"], sc["height_m"],
                          sc["sensor_height_m"], route["radius_m"],
                          sc["furniture"])
    raise ValueError(f"unknown scene kind {sc['kind']!r}")


def make_lap(mix: dict, sensor: dict, capacity: int, seed: int, lane: int,
             device) -> tuple:
    """One lap of lane ``lane``: (xyz (L, capacity, 3) float32, mask (L,
    capacity) bool, positions (L, 3), yaws (L,)), on ``device``.  A sweep
    with more returns than ``capacity`` is cut at the capacity.  A route
    with ``frames`` makes only the lap's first ``frames`` sweeps (tests)."""
    route = mix["route"]
    n = route.get("frames") or lap_frames(route)
    boxes = layout(mix, lane)
    start = int(np.random.default_rng(derived_seed(seed, lane, 0)).integers(
        lap_frames(route)))
    xyz = torch.zeros((n, capacity, 3), dtype=torch.float32, device=device)
    mask = torch.zeros((n, capacity), dtype=torch.bool, device=device)
    rays = sensor["n_rings"] * sensor["n_azimuth"]
    gen = torch.Generator(device=device)
    pos, yaws = [], []
    for i in range(n):
        s = derived_seed(seed, lane, i + 1)
        gen.manual_seed(s)
        phase = float(np.random.default_rng(s).uniform(
            0.0, 2.0 * math.pi / sensor["n_azimuth"]))
        noise = torch.randn(rays, generator=gen, device=device,
                            dtype=torch.float64) * sensor["range_noise_m"]
        p, yaw = route_pose(route, start + i)
        pts = scene.sweep(boxes, p, yaw, sensor, phase, noise, device)
        k = min(pts.shape[0], capacity)
        xyz[i, :k] = pts[:k]
        mask[i, :k] = True
        pos.append(p)
        yaws.append(yaw)
    return xyz, mask, np.asarray(pos), np.asarray(yaws)


def host_laps(mix: dict, sensor: dict, capacity: int, seed: int,
              device) -> tuple:
    """Every lane's lap in pinned host memory: xyz (L, B, N, 3), mask (L, B,
    N) as NumPy views (B = the mix's lanes), frame-major so that one frame
    of all lanes is one contiguous block."""
    lanes = mix["lanes"]
    parts = [make_lap(mix, sensor, capacity, seed, b, device)
             for b in range(lanes)]
    xyz = torch.stack([p[0] for p in parts], dim=1)
    mask = torch.stack([p[1] for p in parts], dim=1)
    if xyz.is_cuda:
        hx = torch.empty(xyz.shape, dtype=xyz.dtype, pin_memory=True)
        hm = torch.empty(mask.shape, dtype=mask.dtype, pin_memory=True)
        hx.copy_(xyz)
        hm.copy_(mask)
        del xyz, mask
        torch.cuda.empty_cache()
        # the peak the result reports is the program's, not the ray caster's
        torch.cuda.reset_peak_memory_stats(device)
    else:
        hx, hm = xyz, mask
    return hx.numpy(), hm.numpy()
