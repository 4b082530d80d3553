"""Feature extraction: ring split, curvature, edge/planar classification.

Counterpart of ``light_loam_tpu/ops/features.py`` (the reference's scan
registration stage, src/scanRegistration.cpp:87-428), over an (n_scans,
h_max) padded range image:

  * range/NaN filtering is masking, not compaction (ref:58-85,105-110);
  * ring id and sweep-relative time are elementwise math (ref:133-210);
  * the ring-ordered concatenation (ref:216-221) is a stable sort into the
    (ring, column) grid;
  * curvature is an 11-tap stencil along each ring (ref:225-235);
  * the greedy per-sector selection with neighbour suppression
    (ref:246-368) is a fixed sequence of masked argmax/argmin picks:
    taking the extremal *eligible* candidate again and again equals the
    reference's walk down a sorted list, because suppression only ever
    removes candidates.

Sectors run in order (suppression leaks across sector boundaries), corner
picks come before flat picks, and the 4th flat pick skips suppression like
the reference's post-increment break (ref:327-331).  The picks are
6 sectors x (20 corner + 4 flat) = 144 sequential whole-grid steps, each a
handful of small kernels: on a GPU this stage is bound by launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from light_loam_tpu_torch.config import ScanConfig
from light_loam_tpu_torch.core.frame import PointCloud, RangeImage, ScanFeatures
from light_loam_tpu_torch.ops.voxel import voxel_downsample_rings

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


def compute_curvature(grid_xyz: torch.Tensor) -> torch.Tensor:
    """11-tap second-difference curvature per ring
    (src/scanRegistration.cpp:225-235); the taps are added in the JAX
    package's order so the sums round alike."""
    H = grid_xyz.shape[1]
    pad = torch.nn.functional.pad(grid_xyz, (0, 0, 5, 5))
    acc = -10.0 * grid_xyz
    for off in range(11):
        if off == 5:
            continue
        acc = acc + pad[:, off:off + H]
    sq = acc * acc
    return sq[..., 0] + sq[..., 1] + sq[..., 2]


def _gap_ok(d2: torch.Tensor, cand: torch.Tensor, cfg: ScanConfig):
    """Cumulative suppression-continue flags on both sides of each pick:
    ok_plus[:, l] suppresses cand+1+l, ok_minus[:, l] cand-1-l
    (src/scanRegistration.cpp:288-311)."""
    rad = cfg.suppression_radius
    H = d2.shape[1]
    offs = torch.arange(rad, device=d2.device)
    ip = torch.clamp(cand[:, None] + offs[None, :], 0, H - 1)
    im = torch.clamp(cand[:, None] - 1 - offs[None, :], 0, H - 1)
    gp = torch.gather(d2, 1, ip) <= cfg.suppression_gap_sq
    gm = torch.gather(d2, 1, im) <= cfg.suppression_gap_sq
    ok_plus = torch.cumprod(gp.to(torch.int32), 1).bool()
    ok_minus = torch.cumprod(gm.to(torch.int32), 1).bool()
    return ok_plus, ok_minus


def _suppression_mask(col_ids, cand, ok_plus, ok_minus, cfg: ScanConfig):
    delta = col_ids - cand[:, None]
    m = delta == 0
    for l in range(cfg.suppression_radius):
        m = m | ((delta == l + 1) & ok_plus[:, l:l + 1])
        m = m | ((delta == -(l + 1)) & ok_minus[:, l:l + 1])
    return m


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


def select_features(grid: RangeImage, curv: torch.Tensor, cfg: ScanConfig,
                    pre_suppressed: Optional[torch.Tensor] = None):
    """Greedy per-sector classification (src/scanRegistration.cpp:246-368).

    ``pre_suppressed`` (R, H) marks points excluded before any pick (the
    occlusion filter); they behave like already-picked neighbours.

    Returns (label, order_key) over the grid:
      label: 2 sharp, 1 less-sharp, -1 flat, 0 untouched (int8)
      order_key: reference push order within the frame (ring-major,
      sector-major, pick-rank-minor) for selected points, else INT32_MAX.
    """
    R, H = curv.shape
    dev = curv.device
    col_ids = torch.arange(H, device=dev)[None, :].expand(R, H)

    nxt = torch.cat([grid.xyz[:, 1:], grid.xyz[:, -1:]], dim=1)
    dd = (nxt - grid.xyz) ** 2
    d2 = dd[..., 0] + dd[..., 1] + dd[..., 2]

    seg_len = grid.counts.to(torch.int64) - 11
    ring_active = seg_len >= cfg.n_sectors

    picked = ~grid.mask
    if pre_suppressed is not None:
        picked = picked | pre_suppressed
    label = torch.zeros((R, H), dtype=torch.int8, device=dev)
    okey = torch.full((R, H), _INT32_MAX, dtype=torch.int32, device=dev)

    n_corner = cfg.max_less_sharp_per_sector
    n_flat = cfg.max_flat_per_sector
    sector_stride = n_corner + n_flat + 8
    neg_inf = torch.full((), -math.inf, device=dev)
    pos_inf = torch.full((), math.inf, device=dev)
    sharp_curv = curv > cfg.curvature_threshold
    flat_curv = curv < cfg.curvature_threshold

    for j in range(cfg.n_sectors):
        sp = 5 + (seg_len * j) // cfg.n_sectors
        ep = 5 + (seg_len * (j + 1)) // cfg.n_sectors - 1
        sector_mask = (
            ring_active[:, None]
            & (col_ids >= sp[:, None])
            & (col_ids <= ep[:, None])
        )
        for rank in range(n_corner):
            eligible = sector_mask & ~picked & sharp_curv
            do = eligible.any(dim=1)
            cand = torch.argmax(torch.where(eligible, curv, neg_inf), dim=1)
            ok_p, ok_m = _gap_ok(d2, cand, cfg)
            sup = _suppression_mask(col_ids, cand, ok_p, ok_m, cfg) & do[:, None]
            center = (col_ids == cand[:, None]) & do[:, None]
            lab_val = 2 if rank < cfg.max_sharp_per_sector else 1
            picked = picked | sup
            label = torch.where(center, lab_val, label)
            okey = torch.where(center, j * sector_stride + rank, okey)
        for rank in range(n_flat):
            eligible = sector_mask & ~picked & flat_curv
            do = eligible.any(dim=1)
            cand = torch.argmin(torch.where(eligible, curv, pos_inf), dim=1)
            center = (col_ids == cand[:, None]) & do[:, None]
            label = torch.where(center, -1, label)
            okey = torch.where(center, j * sector_stride + n_corner + rank,
                               okey)
            if rank < n_flat - 1:
                ok_p, ok_m = _gap_ok(d2, cand, cfg)
                sup = _suppression_mask(col_ids, cand, ok_p, ok_m, cfg)
                picked = picked | (sup & do[:, None])
            else:
                # the final flat pick breaks before suppressing (ref:327-331)
                picked = picked | center
    return label, okey


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
    """Raise for the less-flat mode this port does not implement ("runs",
    a TPU workaround) and for an unknown one."""
    if cfg.lessflat_mode == "runs":
        raise NotImplementedError(
            "ScanConfig.lessflat_mode='runs' is not ported; use 'exact'")
    if cfg.lessflat_mode != "exact":
        raise ValueError(
            f"unknown ScanConfig.lessflat_mode={cfg.lessflat_mode!r}")


def extract_features(
    xyz: torch.Tensor, mask: torch.Tensor, cfg: ScanConfig
) -> ScanFeatures:
    """Full feature-extraction stage for one frame.

    xyz: (max_points, 3) raw sensor points; mask: validity of each slot.
    The "runs" less-flat mode (a TPU workaround) raises
    NotImplementedError."""
    check_scan_config(cfg)
    finite = torch.isfinite(xyz).all(dim=-1)
    r2 = xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1] + xyz[:, 2] * xyz[:, 2]
    in_mask = mask & finite & (r2 >= cfg.minimum_range ** 2)

    ring, ring_ok = compute_ring_ids(xyz, in_mask, cfg)
    rel_time = compute_rel_time(xyz, in_mask, ring_ok)
    rel = ring.to(xyz.dtype) + cfg.scan_period * rel_time

    grid = build_range_image(xyz, rel, ring, ring_ok, cfg)
    curv = compute_curvature(grid.xyz)
    occluded = occlusion_mask(grid, cfg) if cfg.occlusion_filter else None
    label, okey = select_features(grid, curv, cfg, pre_suppressed=occluded)

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
    lf_xyz, lf_rel, lf_mask = voxel_downsample_rings(
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
