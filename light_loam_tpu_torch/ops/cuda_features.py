"""The feature picks: CUDA kernel wrapper and plain version.

The greedy per-sector classification of the feature stage
(src/scanRegistration.cpp:225-368) over an (R, H) padded range image: the
11-tap curvature along each ring, then per ring and sector the corner and
flat picks with neighbour suppression.  The plain version is a fixed
sequence of masked argmax/argmin picks over the whole grid: taking the
extremal *eligible* candidate again and again equals the reference's walk
down a sorted list, because suppression only ever removes candidates.
Sectors run in order (suppression leaks across sector boundaries), corner
picks come before flat picks, and the 4th flat pick skips suppression like
the reference's post-increment break (ref:327-331).  The picks are
6 sectors x (20 corner + 4 flat) = 144 sequential whole-grid steps, each a
handful of small kernels: on a GPU that sequence is bound by launches.

``feature_picks`` is a custom operator
(``torch.ops.light_loam_tpu_torch.feature_picks``): its CUDA kernel
launches ``csrc/features.cu``, which makes one ring's picks in one thread
block, and its CPU kernel runs the plain version (``compute_curvature``,
then ``select_features``); it never falls back from one to the other.
The rings are independent, so under ``torch.vmap`` its vmap rule folds the
lane axis into the rings: B lanes of R rings are one call of B·R rings, on
the card one launch.  ``FEATURES.launches`` counts one launch per call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from light_loam_tpu_torch.config import ScanConfig
from light_loam_tpu_torch.core.frame import RangeImage
from light_loam_tpu_torch.ops.cuda_build import CudaKernel
from light_loam_tpu_torch.ops.cuda_knn import lanes_first

FEATURES = CudaKernel(
    "features.cu", "feature_picks_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
)

_INT32_MAX = 2**31 - 1


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


@torch.library.custom_op("light_loam_tpu_torch::feature_picks",
                         mutates_args=(), device_types="cpu")
def feature_picks(xyz: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor,
                  pre_suppressed: Optional[torch.Tensor], n_sectors: int,
                  max_sharp: int, n_corner: int, n_flat: int, radius: int,
                  curvature_threshold: float, gap_sq: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``select_features`` over ``compute_curvature`` of the range image
    xyz (R, H, 3) f32, mask (R, H) bool, counts (R,) i32, with
    ``pre_suppressed`` (R, H) bool or None, under the ``ScanConfig``
    numbers named here -> (label (R, H) int8, order_key (R, H) i32).  CUDA
    tensors launch ``csrc/features.cu``; CPU tensors run the plain
    version."""
    cfg = ScanConfig(
        n_sectors=n_sectors, max_sharp_per_sector=max_sharp,
        max_less_sharp_per_sector=n_corner, max_flat_per_sector=n_flat,
        suppression_radius=radius, curvature_threshold=curvature_threshold,
        suppression_gap_sq=gap_sq)
    # select_features reads no sweep times
    grid = RangeImage(xyz=xyz, rel=None, mask=mask, counts=counts)
    return select_features(grid, compute_curvature(xyz), cfg,
                           pre_suppressed=pre_suppressed)


def pick_features(grid: RangeImage, cfg: ScanConfig,
                  pre_suppressed: Optional[torch.Tensor] = None):
    """``feature_picks`` of ``grid`` under ``cfg``: (label, order_key)."""
    return feature_picks(
        grid.xyz, grid.mask, grid.counts, pre_suppressed, cfg.n_sectors,
        cfg.max_sharp_per_sector, cfg.max_less_sharp_per_sector,
        cfg.max_flat_per_sector, cfg.suppression_radius,
        cfg.curvature_threshold, cfg.suppression_gap_sq)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"feature_picks: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"feature_picks: {name} has dtype {t.dtype}, "
                         f"expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"feature_picks: {name} has shape "
                         f"{tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"feature_picks: {name} must be contiguous")


@feature_picks.register_kernel("cuda")
def _feature_picks_cuda(xyz, mask, counts, pre_suppressed, n_sectors,
                        max_sharp, n_corner, n_flat, radius,
                        curvature_threshold, gap_sq):
    if mask.dim() != 2:
        raise ValueError(f"feature_picks: mask has shape "
                         f"{tuple(mask.shape)}, expected (R, H)")
    R, H = mask.shape
    dev = xyz.device
    _check("xyz", xyz, torch.float32, (R, H, 3), dev)
    _check("mask", mask, torch.bool, (R, H), dev)
    _check("counts", counts, torch.int32, (R,), dev)
    if pre_suppressed is not None:
        _check("pre_suppressed", pre_suppressed, torch.bool, (R, H), dev)
    label = torch.empty((R, H), dtype=torch.int8, device=dev)
    okey = torch.empty((R, H), dtype=torch.int32, device=dev)
    FEATURES.launch(
        xyz.data_ptr(), mask.data_ptr(), counts.data_ptr(),
        None if pre_suppressed is None else pre_suppressed.data_ptr(),
        R, H, n_sectors, max_sharp, n_corner, n_flat, radius,
        float(curvature_threshold), float(gap_sq), label.data_ptr(),
        okey.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return label, okey


@feature_picks.register_vmap
def _feature_picks_lanes(info, in_dims, xyz, mask, counts, pre_suppressed,
                         *numbers):
    B = info.batch_size
    xyz, mask, counts = (lanes_first(x, d, B)
                         for x, d in zip((xyz, mask, counts), in_dims))
    R, H = mask.shape[1:]
    if pre_suppressed is not None:
        pre_suppressed = lanes_first(pre_suppressed, in_dims[3],
                                     B).reshape(B * R, H)
    label, okey = feature_picks(xyz.reshape(B * R, H, 3),
                                mask.reshape(B * R, H),
                                counts.reshape(B * R), pre_suppressed,
                                *numbers)
    return (label.reshape(B, R, H), okey.reshape(B, R, H)), (0, 0)
