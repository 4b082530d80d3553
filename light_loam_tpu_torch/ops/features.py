"""Feature extraction: ring split, curvature, edge/planar classification.

Counterpart of ``light_loam_tpu/ops/features.py`` (the reference's scan
registration stage, src/scanRegistration.cpp:87-428), over an (n_scans,
h_max) padded range image:

  * range/NaN filtering is masking, not compaction (ref:58-85,105-110);
  * ring id and sweep-relative time are elementwise math (ref:133-210);
  * the ring-ordered concatenation (ref:216-221) is a stable sort into the
    (ring, column) grid;
  * the 11-tap curvature along each ring (ref:225-235) and the greedy
    per-sector selection with neighbour suppression (ref:246-368) are one
    custom operator, ``feature_picks`` (ops/cuda_features.py): one launch
    of ``csrc/features.cu`` on the card, the plain masked argmax/argmin
    picks on the CPU.
"""

from __future__ import annotations

import math

import torch

from light_loam_tpu_torch.config import ScanConfig
from light_loam_tpu_torch.core.frame import PointCloud, RangeImage, ScanFeatures
from light_loam_tpu_torch.ops.cuda_features import pick_features
from light_loam_tpu_torch.ops.voxel import (
    voxel_downsample_rings,
    voxel_downsample_rings_runs,
)

_INT32_MAX = 2**31 - 1


def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    """C-style int() truncation toward zero."""
    return torch.trunc(x).to(torch.int32)


def compute_ring_ids(xyz: torch.Tensor, mask: torch.Tensor, cfg: ScanConfig):
    """Vertical angle -> ring id with the reference's three per-sensor
    formulas (src/scanRegistration.cpp:142-169) and C truncation."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    angle = torch.arctan(z / torch.sqrt(x * x + y * y)) * (180.0 / math.pi)
    if cfg.ring_formula == "bounds" or cfg.n_scans == 64:
        factor = (cfg.n_scans - 1) / (cfg.upper_bound_deg - cfg.lower_bound_deg)
        ring = _trunc_int((angle - cfg.lower_bound_deg) * factor + 0.5)
    elif cfg.n_scans == 16:
        ring = _trunc_int((angle + 15.0) / 2.0 + 0.5)
    elif cfg.n_scans == 32:
        ring = _trunc_int((angle + 92.0 / 3.0) * 3.0 / 4.0)
    else:
        raise ValueError(f"unsupported n_scans={cfg.n_scans}")
    ok = mask & (ring >= 0) & (ring < cfg.n_scans)
    return ring, ok


def compute_rel_time(
    xyz: torch.Tensor, in_mask: torch.Tensor, ring_ok: torch.Tensor
) -> torch.Tensor:
    """Sweep-relative time in [0, 1]: the start/end azimuth unwrap with the
    sequential ``halfPassed`` flip (src/scanRegistration.cpp:114-207) as an
    exclusive prefix-OR of the flip trigger."""
    n = xyz.shape[0]
    ori_raw = -torch.arctan2(xyz[:, 1], xyz[:, 0])

    m = in_mask.to(torch.int32)
    first = torch.argmax(m)
    last = n - 1 - torch.argmax(torch.flip(m, (0,)))
    # gather, not ori_raw[first]: indexing with a 0-d tensor reads it to
    # the host
    start_ori = ori_raw.gather(0, first[None])[0]
    end_ori = ori_raw.gather(0, last[None])[0] + 2.0 * math.pi
    span = end_ori - start_ori
    end_ori = torch.where(
        span > 3.0 * math.pi,
        end_ori - 2.0 * math.pi,
        torch.where(span < math.pi, end_ori + 2.0 * math.pi, end_ori),
    )

    o1 = ori_raw
    o1 = torch.where(o1 < start_ori - math.pi / 2, o1 + 2.0 * math.pi, o1)
    o1 = torch.where(o1 > start_ori + math.pi * 1.5, o1 - 2.0 * math.pi, o1)
    trigger = ((o1 - start_ori > math.pi) & ring_ok).to(torch.int32)
    half_passed = (torch.cumsum(trigger, 0) - trigger) > 0

    o2 = ori_raw + 2.0 * math.pi
    o2 = torch.where(o2 < end_ori - math.pi * 1.5, o2 + 2.0 * math.pi, o2)
    o2 = torch.where(o2 > end_ori + math.pi / 2, o2 - 2.0 * math.pi, o2)

    ori = torch.where(half_passed, o2, o1)
    return (ori - start_ori) / (end_ori - start_ori)


def build_range_image(
    xyz: torch.Tensor,
    rel: torch.Tensor,
    ring: torch.Tensor,
    ok: torch.Tensor,
    cfg: ScanConfig,
) -> RangeImage:
    """Stable-sort points into the (ring, column) grid, keeping the
    within-ring arrival order of the reference's per-ring push_back
    (src/scanRegistration.cpp:209,216-221)."""
    n = xyz.shape[0]
    dev = xyz.device
    R, H = cfg.n_scans, cfg.h_max
    sort_key = torch.where(ok, ring.to(torch.int64), torch.full_like(
        ring, R, dtype=torch.int64))
    ring_s, order = torch.sort(sort_key, stable=True)
    ok_s = ok[order]

    pos = torch.arange(n, device=dev)
    ring_start = torch.full((R + 1,), n, dtype=torch.int64, device=dev
                            ).scatter_reduce(0, ring_s, pos, "amin",
                                             include_self=True)
    col = pos - ring_start[ring_s]
    keep = ok_s & (col < H)
    flat_idx = torch.where(keep, ring_s * H + col,
                           torch.full_like(col, R * H))

    grid_xyz = xyz.new_zeros((R * H + 1, 3)).index_put((flat_idx,),
                                                       xyz[order])
    grid_rel = rel.new_zeros((R * H + 1,)).index_put((flat_idx,), rel[order])
    grid_mask = torch.zeros(R * H + 1, dtype=torch.bool, device=dev
                            ).index_put((flat_idx,), keep)
    counts = torch.zeros(R + 1, dtype=torch.int32, device=dev).index_add(
        0, ring_s, keep.to(torch.int32))[:R]
    return RangeImage(
        xyz=grid_xyz[: R * H].reshape(R, H, 3),
        rel=grid_rel[: R * H].reshape(R, H),
        mask=grid_mask[: R * H].reshape(R, H),
        counts=counts,
    )


def occlusion_mask(grid: RangeImage, cfg: ScanConfig) -> torch.Tensor:
    """Unreliable-point mask: shadow boundaries and parallel beams
    (original LOAM §V-A; an accuracy extension over the reference, see
    ScanConfig.occlusion_filter).

    Returns (R, H) bool, True = suppress.  Across a range discontinuity
    between columns i and i+1 the FARTHER side's window is suppressed (its
    points sit on an occlusion boundary that moves with parallax); beams
    grazing a surface (both neighbour gaps large relative to the range)
    are suppressed as unstable."""
    r = torch.sqrt(torch.sum(grid.xyz * grid.xyz, dim=-1))
    r = torch.where(grid.mask, r, torch.zeros((), device=r.device))
    R, H = r.shape
    nxt = torch.cat([r[:, 1:], r[:, -1:]], dim=1)
    both = grid.mask & torch.cat(
        [grid.mask[:, 1:], torch.zeros_like(grid.mask[:, :1])], dim=1)
    # trigger at column i about the (i, i+1) pair
    far_here = both & (r - nxt > cfg.occlusion_gap)   # i is farther
    far_next = both & (nxt - r > cfg.occlusion_gap)   # i+1 is farther

    pad = cfg.occlusion_radius
    fh = torch.nn.functional.pad(far_here, (0, pad))
    fn = torch.nn.functional.pad(far_next, (pad + 1, 0))
    sup = torch.zeros_like(grid.mask)
    for l in range(pad + 1):
        # far_here at i suppresses i-l; far_next at i suppresses i+1+l
        sup = sup | fh[:, l:l + H] | fn[:, pad - l:pad - l + H]

    prv = torch.cat([r[:, :1], r[:, :-1]], dim=1)
    parallel = (
        grid.mask
        & ((r - prv).abs() > cfg.parallel_beam_ratio * r)
        & ((nxt - r).abs() > cfg.parallel_beam_ratio * r)
    )
    return sup | parallel


def _compact_selected(grid: RangeImage, sel, okey, capacity: int) -> PointCloud:
    """Gather selected grid cells into a fixed-capacity cloud in reference
    push order (ring-major, then order key)."""
    R, H = sel.shape
    dev = sel.device
    flat_sel = sel.reshape(-1)
    row_ids = torch.arange(R, device=dev).repeat_interleave(H)
    stride = 1 << 12
    keys = row_ids * stride + torch.clamp(okey.reshape(-1).to(torch.int64),
                                          max=stride - 1)
    sort_key = torch.where(flat_sel, keys, torch.full_like(keys, _INT32_MAX))
    order = torch.sort(sort_key, stable=True)[1][:capacity]
    out_mask = torch.arange(capacity, device=dev) < flat_sel.sum()
    xyz = grid.xyz.reshape(-1, 3)[order]
    rel = grid.rel.reshape(-1)[order]
    zero = torch.zeros((), device=dev)
    return PointCloud(
        xyz=torch.where(out_mask[:, None], xyz, zero),
        rel=torch.where(out_mask, rel, zero),
        mask=out_mask,
    )


def check_scan_config(cfg: ScanConfig) -> None:
    """Raise for an unknown less-flat mode."""
    if cfg.lessflat_mode not in ("exact", "runs"):
        raise ValueError(
            f"unknown ScanConfig.lessflat_mode={cfg.lessflat_mode!r}")


def extract_features(
    xyz: torch.Tensor, mask: torch.Tensor, cfg: ScanConfig
) -> ScanFeatures:
    """Full feature-extraction stage for one frame.

    xyz: (max_points, 3) raw sensor points; mask: validity of each slot.
    The less-flat cloud is downsampled per ring by ``cfg.lessflat_mode``:
    "exact" (voxel_downsample_rings) or "runs"
    (voxel_downsample_rings_runs)."""
    check_scan_config(cfg)
    finite = torch.isfinite(xyz).all(dim=-1)
    r2 = xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1] + xyz[:, 2] * xyz[:, 2]
    in_mask = mask & finite & (r2 >= cfg.minimum_range ** 2)

    ring, ring_ok = compute_ring_ids(xyz, in_mask, cfg)
    rel_time = compute_rel_time(xyz, in_mask, ring_ok)
    rel = ring.to(xyz.dtype) + cfg.scan_period * rel_time

    grid = build_range_image(xyz, rel, ring, ring_ok, cfg)
    occluded = occlusion_mask(grid, cfg) if cfg.occlusion_filter else None
    label, okey = pick_features(grid, cfg, pre_suppressed=occluded)

    sharp = _compact_selected(grid, label == 2, okey, cfg.max_sharp)
    less_sharp = _compact_selected(grid, label >= 1, okey, cfg.max_less_sharp)
    flat = _compact_selected(grid, label == -1, okey, cfg.max_flat)

    # Less-flat: everything not corner-labeled inside the selection band,
    # voxel-filtered per ring at 0.2 m (ref:361-376) into the ring-slotted
    # layout the grid surf search needs.
    R, H = label.shape
    col_ids = torch.arange(H, device=xyz.device)[None, :]
    counts = grid.counts.to(torch.int64)
    band = (
        ((counts - 11) >= cfg.n_sectors)[:, None]
        & (col_ids >= 5)
        & (col_ids <= (counts - 7)[:, None])
    )
    lf_sel = band & (label <= 0) & grid.mask
    if occluded is not None:
        lf_sel = lf_sel & ~occluded
    downsample = (voxel_downsample_rings_runs if cfg.lessflat_mode == "runs"
                  else voxel_downsample_rings)
    lf_xyz, lf_rel, lf_mask = downsample(
        grid.xyz, grid.rel, lf_sel, cfg.less_flat_leaf,
        cfg.max_less_flat // cfg.n_scans,
    )
    less_flat = PointCloud(
        xyz=lf_xyz.reshape(-1, 3),
        rel=lf_rel.reshape(-1),
        mask=lf_mask.reshape(-1),
    )
    return ScanFeatures(
        full=grid, sharp=sharp, less_sharp=less_sharp, flat=flat,
        less_flat=less_flat,
    )
