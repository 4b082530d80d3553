"""Nearest-neighbour correspondence search without KD-trees.

Counterpart of ``light_loam_tpu/ops/knn.py``.  The reference rebuilds
pcl::KdTreeFLANN per frame and scans the ring-sorted arrays
(src/laserOdometry.cpp:491-737); here the same queries are masked argmins
over squared-distance blocks ‖q‖² + ‖r‖² − 2·q·rᵀ.

Ring-window semantics (the reference's array scans reduce to ring-set
membership on a ring-sorted array):

  * corner 2nd point (laserOdometry.cpp:504-553): nearest point whose ring
    differs from the 1-NN's ring by 1..NEARBY_SCAN;
  * surf 2nd point (laserOdometry.cpp:668-721): nearest point on the SAME
    ring as the 1-NN (excluding it);
  * surf 3rd point: nearest point on a different ring within NEARBY_SCAN.

All gated by DISTANCE_SQ_THRESHOLD = 25 (laserOdometry.cpp:29).  The
surf search comes in two forms: ``surf_correspondences_grid`` for the
ring-slotted less-flat layout (one pass), and the layout-agnostic
two-pass ``surf_correspondences`` over reference tiles.  The mapping
stage's 5-NN lives in ``ops/cuda_knn.py`` beside its kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from light_loam_tpu_torch.core.frame import PointCloud

BIG = 1e30


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q,3),(N,3) -> (Q,N) squared distances, clamped at 0.  Exact float32
    matmul (TF32 is off package-wide): the cross term reaches ~1e4 m² at
    100 m coordinates, so TF32 rounding would exceed the 25 m² gate."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    # a2 + b2ᵀ − 2·(a·bᵀ), op for op, but in place: two (Q, N) buffers
    cross = (a @ b.T).mul_(2.0)
    return (a2 + b2.T).sub_(cross).clamp_(min=0.0)


def _masked_min(d: torch.Tensor, mask: torch.Tensor):
    """Row-wise (min, argmin) of d with invalid columns masked out; ties go
    to the first column."""
    dm = torch.where(mask, d, torch.full((), BIG, device=d.device))
    return torch.min(dm, dim=-1)


class CornerMatches(NamedTuple):
    a_idx: torch.Tensor  # (Q,) index of 1-NN in ref (int64)
    b_idx: torch.Tensor  # (Q,) index of cross-ring 2nd point
    valid: torch.Tensor  # (Q,) bool


class SurfMatches(NamedTuple):
    a_idx: torch.Tensor  # (Q,) 1-NN
    b_idx: torch.Tensor  # (Q,) same-ring 2nd point
    c_idx: torch.Tensor  # (Q,) cross-ring 3rd point
    valid: torch.Tensor  # (Q,) bool


def corner_correspondences(
    query_xyz: torch.Tensor,
    query_mask: torch.Tensor,
    ref: PointCloud,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
) -> CornerMatches:
    """Edge-line correspondences (laserOdometry.cpp:491-554) against the
    whole (small) corner reference cloud in one distance block."""
    d = pairwise_sq_dist(query_xyz, ref.xyz)
    ring = ref.ring()
    d1, a_idx = _masked_min(d, ref.mask[None, :])
    ring_diff = ring[None, :] - ring[a_idx][:, None]
    window = (
        ref.mask[None, :]
        & (ring_diff != 0)
        & (ring_diff.abs().to(torch.float32) <= nearby_scan)
    )
    d2, b_idx = _masked_min(d, window)
    valid = query_mask & (d1 < dist_sq_threshold) & (d2 < dist_sq_threshold)
    return CornerMatches(a_idx=a_idx, b_idx=b_idx, valid=valid)


def surf_correspondences(
    query_xyz: torch.Tensor,
    query_mask: torch.Tensor,
    ref: PointCloud,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
    tile: int = 8192,
    ref_count: Optional[int] = None,
) -> SurfMatches:
    """Planar-triangle correspondences (laserOdometry.cpp:653-737) over
    the surf reference in ``tile``-row chunks: a 1-NN pass, then a pass for
    the same-ring 2nd and the cross-ring 3rd point (pass 2's ring classes
    depend on pass 1's argmin).  Ties go to the first index.

    ``ref_count`` (a host int) asserts that every live reference row lies
    in the prefix [0, ref_count) (a compacted cloud, ``ops.voxel.
    compact_rows``); both passes then visit only ceil(ref_count / tile)
    tiles.  Exact: a skipped tile is all masked and can never win a min.
    The trip count is a host int, so the loops never wait on the device."""
    Q = query_xyz.shape[0]
    N = ref.capacity
    dev = query_xyz.device
    ring = ref.ring()
    n_tiles = -(-N // tile)
    n_live = n_tiles if ref_count is None else min(-(-ref_count // tile),
                                                   n_tiles)
    bounds = [(i * tile, min((i + 1) * tile, N)) for i in range(n_live)]

    # ---- pass 1: plain 1-NN over tiles ----
    d1 = torch.full((Q,), BIG, device=dev)
    a_idx = torch.zeros(Q, dtype=torch.int64, device=dev)
    for lo, hi in bounds:
        d = pairwise_sq_dist(query_xyz, ref.xyz[lo:hi])
        dv, di = _masked_min(d, ref.mask[None, lo:hi])
        upd = dv < d1
        a_idx = torch.where(upd, di + lo, a_idx)
        d1 = torch.where(upd, dv, d1)
    ring_a = ring[a_idx]

    # ---- pass 2: same-ring 2nd and cross-ring 3rd points ----
    d2 = torch.full((Q,), BIG, device=dev)
    d3 = torch.full((Q,), BIG, device=dev)
    b_idx = torch.zeros(Q, dtype=torch.int64, device=dev)
    c_idx = torch.zeros(Q, dtype=torch.int64, device=dev)
    for lo, hi in bounds:
        d = pairwise_sq_dist(query_xyz, ref.xyz[lo:hi])
        cmask = ref.mask[None, lo:hi]
        ring_diff = ring[None, lo:hi] - ring_a[:, None]
        not_self = (torch.arange(lo, hi, device=dev)[None, :]
                    != a_idx[:, None])
        same = cmask & not_self & (ring_diff == 0)
        adj = (cmask & (ring_diff != 0)
               & (ring_diff.abs().to(torch.float32) <= nearby_scan))
        dv2, di2 = _masked_min(d, same)
        dv3, di3 = _masked_min(d, adj)
        u2 = dv2 < d2
        u3 = dv3 < d3
        d2 = torch.where(u2, dv2, d2)
        b_idx = torch.where(u2, di2 + lo, b_idx)
        d3 = torch.where(u3, dv3, d3)
        c_idx = torch.where(u3, di3 + lo, c_idx)

    valid = (
        query_mask
        & (d1 < dist_sq_threshold)
        & (d2 < dist_sq_threshold)
        & (d3 < dist_sq_threshold)
    )
    return SurfMatches(a_idx=a_idx, b_idx=b_idx, c_idx=c_idx, valid=valid)


def surf_correspondences_grid(
    query_xyz: torch.Tensor,
    query_mask: torch.Tensor,
    ref: PointCloud,
    n_rings: int,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
    rings_per_tile: int = 8,
) -> SurfMatches:
    """Single-pass surf correspondences over a ring-slotted reference (ring
    r owns rows [r*C, r*C + C), ``ops.voxel.voxel_downsample_rings``).

    The same-ring 2nd and nearby-ring 3rd points (laserOdometry.cpp:
    668-721) fall out of per-ring top-2 reductions over one distance block
    per tile of rings.  Ties go to the first column within a ring and the
    first ring across rings, which is global index order."""
    Q = query_xyz.shape[0]
    R = n_rings
    C = ref.capacity // R
    if R * C != ref.capacity:
        raise ValueError(
            f"grid layout requires capacity {ref.capacity} divisible by "
            f"n_rings {R}"
        )
    rpt = min(rings_per_tile, R)
    if R % rpt != 0:
        rpt = 1
    dev = query_xyz.device
    rd1, ri1, rd2, ri2 = [], [], [], []
    for r0 in range(0, R, rpt):
        chunk = ref.xyz[r0 * C:(r0 + rpt) * C]
        cmask = ref.mask[r0 * C:(r0 + rpt) * C]
        d = pairwise_sq_dist(query_xyz, chunk)
        d = d.masked_fill_(~cmask[None, :], BIG).view(Q, rpt, C)
        d1, i1 = torch.min(d, dim=-1)                           # (Q, rpt)
        d2, i2 = torch.min(d.scatter_(-1, i1[..., None], BIG), dim=-1)
        rd1.append(d1)
        ri1.append(i1)
        rd2.append(d2)
        ri2.append(i2)
    rd1, ri1 = torch.cat(rd1, 1), torch.cat(ri1, 1)             # (Q, R)
    rd2, ri2 = torch.cat(rd2, 1), torch.cat(ri2, 1)

    ring_a = torch.argmin(rd1, dim=1)                           # (Q,)

    def take(arr, ring_idx):
        return torch.gather(arr, 1, ring_idx[:, None])[:, 0]

    d1 = take(rd1, ring_a)
    a_idx = ring_a * C + take(ri1, ring_a)
    d2 = take(rd2, ring_a)
    b_idx = ring_a * C + take(ri2, ring_a)

    ring_diff = torch.arange(R, device=dev)[None, :] - ring_a[:, None]
    win = (ring_diff != 0) & (ring_diff.abs().to(torch.float32) <= nearby_scan)
    d3m = torch.where(win, rd1, torch.full((), BIG, device=dev))
    d3, ring_c = torch.min(d3m, dim=1)
    c_idx = ring_c * C + take(ri1, ring_c)

    valid = (
        query_mask
        & (d1 < dist_sq_threshold)
        & (d2 < dist_sq_threshold)
        & (d3 < dist_sq_threshold)
    )
    return SurfMatches(a_idx=a_idx, b_idx=b_idx, c_idx=c_idx, valid=valid)
