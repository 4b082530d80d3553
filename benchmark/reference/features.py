"""Feature extraction of one sweep, plain PyTorch (scanRegistration.cpp).

The semantics of Light-LOAM's scan registration as the configuration
states them: points under the minimum range are dropped; each point's ring
comes from its vertical angle by the sensor's formula; each ring keeps its
points in arrival order (at most ``h_max``); curvature is the squared norm
of the 11-point second difference along the ring; in each of 6 equal
sectors of a ring, the points of largest curvature above 0.1 are corners
(the first 2 sharp, up to 20 less sharp) and the 4 of smallest curvature
below 0.1 are flat, each pick marking its neighbours within 5 points as
picked while consecutive gaps stay within sqrt(0.05) m (the fourth flat
pick marks none).  Everything not labelled a corner inside the sectors is
less flat, downsampled per ring on a 0.2 m voxel grid.

Clouds come out in the order the reference pushes them: ring by ring,
sector by sector, pick by pick; the less-flat cloud ring by ring in voxel
order, ``ring_capacity`` slots a ring (a ring with more voxels keeps every
(n / capacity)-th).
"""

from __future__ import annotations

import math

import torch

from reference.numerics import Numerics, voxel_centroids


def ring_ids(xyz: torch.Tensor, scan: dict) -> torch.Tensor:
    x, y, z = xyz.unbind(-1)
    angle = torch.rad2deg(torch.atan(z / torch.sqrt(x * x + y * y)))
    n = scan["n_scans"]
    if scan.get("ring_formula", "auto") == "bounds" or n == 64:
        lo, hi = scan["lower_bound_deg"], scan["upper_bound_deg"]
        ring = torch.trunc((angle - lo) * ((n - 1) / (hi - lo)) + 0.5)
    elif n == 16:
        ring = torch.trunc((angle + 15.0) / 2.0 + 0.5)
    elif n == 32:
        ring = torch.trunc((angle + 92.0 / 3.0) * 3.0 / 4.0)
    else:
        raise ValueError(f"no ring formula for {n} rings")
    return ring.to(torch.int64)


def range_image(xyz: torch.Tensor, scan: dict):
    """(grid (R, H, 3), valid (R, H), counts (R,)) of one sweep's points."""
    R, H = scan["n_scans"], scan["h_max"]
    dev = xyz.device
    keep = torch.isfinite(xyz).all(-1) & (
        (xyz * xyz).sum(-1) >= scan["minimum_range"] ** 2)
    ring = ring_ids(xyz, scan)
    keep &= (ring >= 0) & (ring < R)
    idx = torch.nonzero(keep)[:, 0]
    ring = ring[idx]
    order = torch.sort(ring, stable=True)[1]
    idx, ring = idx[order], ring[order]
    first = torch.searchsorted(ring, torch.arange(R, device=dev))
    col = torch.arange(ring.shape[0], device=dev) - first[ring]
    ok = col < H
    grid = torch.zeros((R, H, 3), dtype=xyz.dtype, device=dev)
    valid = torch.zeros((R, H), dtype=torch.bool, device=dev)
    grid[ring[ok], col[ok]] = xyz[idx[ok]]
    valid[ring[ok], col[ok]] = True
    return grid, valid, valid.sum(1)


def curvature(grid: torch.Tensor) -> torch.Tensor:
    H = grid.shape[1]
    pad = torch.nn.functional.pad(grid, (0, 0, 5, 5))
    acc = -10.0 * grid
    for off in range(11):
        if off != 5:
            acc = acc + pad[:, off:off + H]
    return (acc * acc).sum(-1)


def _suppress(picked, cand, do, gaps_ok, radius):
    """Mark each active ring's pick and, on each side, the next neighbours
    while every gap up to them is small."""
    R, H = picked.shape
    rows = torch.arange(R, device=picked.device)
    picked[rows[do], cand[do]] = True
    for sign in (1, -1):
        run = do.clone()
        for step in range(1, radius + 1):
            j = cand + sign * step
            gap_at = cand + sign * step - (1 if sign > 0 else 0)
            inside = (j >= 0) & (j < H)
            g = gaps_ok[rows, gap_at.clamp(0, H - 1)]
            run = run & inside & g
            picked[rows[run], j[run]] = True


def extract(xyz: torch.Tensor, scan: dict, nm: Numerics) -> dict:
    """Features of one sweep's (n, 3) points (the padded rows removed)."""
    xyz = xyz.to(nm.dtype)
    grid, valid, counts = range_image(xyz, scan)
    R, H = valid.shape
    dev = xyz.device
    curv = curvature(grid)
    step = grid[:, 1:] - grid[:, :-1]
    gaps_ok = torch.cat([(step * step).sum(-1), grid.new_zeros((R, 1))], 1
                        ) <= scan["suppression_gap_sq"]
    col = torch.arange(H, device=dev)[None, :]
    seg = counts - 11
    active = seg >= scan["n_sectors"]
    picked = ~valid
    label = torch.zeros((R, H), dtype=torch.int64, device=dev)
    rank_of = torch.full((R, H), 1 << 30, dtype=torch.int64, device=dev)
    rows = torch.arange(R, device=dev)
    thr = scan["curvature_threshold"]
    n_corner, n_flat = scan["max_less_sharp_per_sector"], scan["max_flat_per_sector"]
    for j in range(scan["n_sectors"]):
        sp = 5 + (seg * j) // scan["n_sectors"]
        ep = 5 + (seg * (j + 1)) // scan["n_sectors"] - 1
        sector = active[:, None] & (col >= sp[:, None]) & (col <= ep[:, None])
        for rank in range(n_corner):
            elig = sector & ~picked & (curv > thr)
            do = elig.any(1)
            cand = torch.where(elig, curv, -math.inf).argmax(1)
            label[rows[do], cand[do]] = 2 if rank < scan["max_sharp_per_sector"] else 1
            rank_of[rows[do], cand[do]] = j * 1000 + rank
            _suppress(picked, cand, do, gaps_ok, scan["suppression_radius"])
        for rank in range(n_flat):
            elig = sector & ~picked & (curv < thr)
            do = elig.any(1)
            cand = torch.where(elig, curv, math.inf).argmin(1)
            label[rows[do], cand[do]] = -1
            rank_of[rows[do], cand[do]] = j * 1000 + 500 + rank
            if rank < n_flat - 1:
                _suppress(picked, cand, do, gaps_ok, scan["suppression_radius"])
            else:
                picked[rows[do], cand[do]] = True

    def cloud(sel):
        key = rows[:, None] * (1 << 32) + rank_of
        flat_idx = torch.nonzero(sel.reshape(-1))[:, 0]
        order = torch.sort(key.reshape(-1)[flat_idx], stable=True)[1]
        flat_idx = flat_idx[order]
        return (grid.reshape(-1, 3)[flat_idx], flat_idx // H,
                torch.ones_like(flat_idx, dtype=torch.bool))

    sharp = cloud(label == 2)
    less_sharp = cloud(label >= 1)
    flat = cloud(label == -1)

    band = active[:, None] & (col >= 5) & (col <= (counts - 7)[:, None])
    lf = band & (label <= 0) & valid
    cap = scan["max_less_flat"] // R
    lf_xyz = grid.new_zeros((R, cap, 3))
    lf_mask = torch.zeros((R, cap), dtype=torch.bool, device=dev)
    for r in range(R):
        cent, _ = voxel_centroids(grid[r][lf[r]], scan["less_flat_leaf"])
        n = cent.shape[0]
        if n > cap:
            cent = cent[(torch.arange(cap, device=dev) * n) // cap]
        lf_xyz[r, :cent.shape[0]] = cent
        lf_mask[r, :cent.shape[0]] = True
    ring = torch.arange(R, device=dev).repeat_interleave(cap)
    less_flat = (lf_xyz.reshape(-1, 3), ring, lf_mask.reshape(-1))
    return {"sharp": sharp, "less_sharp": less_sharp, "flat": flat,
            "less_flat": less_flat}
