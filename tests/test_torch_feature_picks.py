"""The feature picks (ops/cuda_features.py ``feature_picks``) on the CPU.

csrc/features.cu cannot run here, so ``kernel_picks`` models what its
blocks do, step for step, in NumPy: per ring the curvature and the steps
with each float32 operation rounded on its own, the corner and flat
candidate arrays with their sentinels, and per pick the 32 lanes' strided
scans (lane l: columns sp + l, sp + l + 32, ...), their butterfly with the
lowest column on ties, the suppression's ballot runs on both sides and the
last flat pick's break.  It is held bit for bit to the plain version
(``select_features`` over ``compute_curvature``) on ring-road sweeps of
the HDL-64E and the VLP-16 (utils/synthetic.py, as the benchmark cells),
on grids built for exact curvature ties, with the occlusion filter's
pre-suppressed points, on rings too short to pick from, of exactly 17
points and full, and on an empty scan.  The operator's CPU kernel is the
plain version, and its vmap rule folds lanes into rings.  The card tests
(tests/test_torch_cuda.py) hold the kernel itself to the plain version.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    FEATURE_LANE_CASES,
    feature_grids,
    pad_rings,
    plain_picks,
)
from light_loam_tpu_torch.ops.cuda_features import (
    FEATURES,
    compute_curvature,
    feature_picks,
    pick_features,
)
from light_loam_tpu_torch.ops.features import occlusion_mask

torch.set_num_threads(2)

LANES = 32
KEY_NONE = 2**31 - 1
F32 = np.float32
INF = F32(np.inf)


def curvature_and_steps(xyz: np.ndarray):
    """A block's first pass over one ring, xyz (H, 3) float32: the
    curvature (-10 x, then the taps at -5..-1, 1..5, zero past the ends)
    and the squared step to the next column, each operation rounded."""
    H = xyz.shape[0]
    acc = F32(-10.0) * xyz
    for off in (-5, -4, -3, -2, -1, 1, 2, 3, 4, 5):
        tap = np.zeros_like(xyz)
        lo, hi = max(0, -off), min(H, H - off)
        tap[lo:hi] = xyz[lo + off:hi + off]
        acc = acc + tap
    sq = acc * acc
    step = xyz[np.minimum(np.arange(H) + 1, H - 1)] - xyz
    dd = step * step
    return (sq[:, 0] + sq[:, 1]) + sq[:, 2], (dd[:, 0] + dd[:, 1]) + dd[:, 2]


def warp_extreme(values: np.ndarray, sp: int, ep: int, largest: bool):
    """Every lane's (best, at) after the scan of columns sp..ep and the
    butterfly: the extreme, the lowest column on ties; (sentinel,
    KEY_NONE) when nothing is left."""
    sentinel = -INF if largest else INF
    n = -(-(ep - sp + 1) // LANES) * LANES
    strip = np.full(n, sentinel, F32)
    strip[:ep - sp + 1] = values[sp:ep + 1]
    per_lane = strip.reshape(-1, LANES)            # row k: columns of step k
    first = (np.argmax if largest else np.argmin)(per_lane, axis=0)
    best = per_lane[first, np.arange(LANES)]
    at = np.where(best == sentinel, KEY_NONE,
                  sp + first * LANES + np.arange(LANES))
    for o in (16, 8, 4, 2, 1):
        v, c = best[np.arange(LANES) ^ o], at[np.arange(LANES) ^ o]
        take = ((v > best) if largest else (v < best)) | ((v == best)
                                                          & (c < at))
        best, at = np.where(take, v, best), np.where(take, c, at)
    assert len(set(zip(best.tolist(), at.tolist()))) == 1
    return best[0], int(at[0])


def run_length(ballot: np.ndarray) -> int:
    """The run of passing lanes from lane 0."""
    fails = np.flatnonzero(~ballot)
    return int(fails[0]) if fails.size else LANES


def suppress_window(corner, flat, d2, at, radius, gap_sq):
    """Lane l tests the step to the (l + 1)-th column out on each side;
    the run of passing lanes from lane 0 suppresses its columns."""
    H = d2.shape[0]
    corner[at], flat[at] = -INF, INF
    lane = np.arange(LANES)
    cu, cd = at + 1 + lane, at - 1 - lane
    live = lane < radius
    pass_u = live & (cu < H) & (d2[np.clip(cu - 1, 0, H - 1)] <= gap_sq)
    pass_d = live & (cd >= 0) & (d2[np.clip(cd, 0, H - 1)] <= gap_sq)
    for ballot, cols in ((pass_u, cu), (pass_d, cd)):
        hit = cols[:run_length(ballot)]
        corner[hit], flat[hit] = -INF, INF


def kernel_picks(xyz, mask, counts, pre, scan):
    """(label, order key) of every ring as csrc/features.cu computes them,
    and the curvature of its first pass."""
    R, H = mask.shape
    label = np.zeros((R, H), np.int8)
    okey = np.full((R, H), KEY_NONE, np.int32)
    curvs = np.zeros((R, H), F32)
    thr, gap = F32(scan.curvature_threshold), F32(scan.suppression_gap_sq)
    n_corner, n_flat = scan.max_less_sharp_per_sector, scan.max_flat_per_sector
    stride = n_corner + n_flat + 8
    for r in range(R):
        curv, d2 = curvature_and_steps(xyz[r])
        curvs[r] = curv
        open_ = mask[r] if pre is None else mask[r] & ~pre[r]
        corner = np.where(open_ & (curv > thr), curv, -INF).astype(F32)
        flat = np.where(open_ & (curv < thr), curv, INF).astype(F32)
        seg = int(counts[r]) - 11
        if seg < scan.n_sectors:
            continue
        for j in range(scan.n_sectors):
            sp = 5 + seg * j // scan.n_sectors
            ep = min(5 + seg * (j + 1) // scan.n_sectors - 1, H - 1)
            if sp > ep:
                continue
            for rank in range(n_corner):
                best, at = warp_extreme(corner, sp, ep, largest=True)
                if not best > -INF:
                    break
                label[r, at] = 2 if rank < scan.max_sharp_per_sector else 1
                okey[r, at] = j * stride + rank
                suppress_window(corner, flat, d2, at,
                                scan.suppression_radius, gap)
            for rank in range(n_flat):
                best, at = warp_extreme(flat, sp, ep, largest=False)
                if not best < INF:
                    break
                label[r, at] = -1
                okey[r, at] = j * stride + n_corner + rank
                if rank < n_flat - 1:
                    suppress_window(corner, flat, d2, at,
                                    scan.suppression_radius, gap)
                else:
                    corner[at], flat[at] = -INF, INF
    return label, okey, curvs


@pytest.fixture(scope="module")
def grids():
    return feature_grids()


CASES = ["hdl64_sweep", "vlp16_sweep", "ties", "occluded", "short_rings",
         "dense", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_kernel_model_equals_plain_picks(grids, case):
    """The model of csrc/features.cu gives the plain version's curvature,
    labels and order keys bit for bit; each case exercises what it is
    named for."""
    grid, scan, pre = grids[case]
    label, okey, curv = kernel_picks(
        grid.xyz.numpy(), grid.mask.numpy(), grid.counts.numpy(),
        None if pre is None else pre.numpy(), scan)
    np.testing.assert_array_equal(curv, compute_curvature(grid.xyz).numpy())
    want_label, want_okey = plain_picks(grid, scan, pre)
    np.testing.assert_array_equal(label, want_label.numpy())
    np.testing.assert_array_equal(okey, want_okey.numpy())

    picked = label != 0
    counts = grid.counts.numpy()
    if case == "empty":
        assert not picked.any()
        return
    assert (label == 2).sum() > 0 and (label == -1).sum() > 0
    if case == "ties":
        # many picks share their curvature with another pick of the ring
        ties = sum(picked[r].sum() - np.unique(curv[r][picked[r]]).size
                   for r in range(len(counts)))
        assert ties > 100
    if case == "occluded":
        assert pre.sum() > 1000 and not (picked & pre.numpy()).any()
    if case in ("short_rings", "vlp16_sweep"):
        # rings of < 17 points pick nothing, of 17 and of h_max they do
        active = counts - 11 >= scan.n_sectors
        assert (picked.any(axis=1) == active).all()
        assert (counts == grid.mask.shape[1]).any()
    if case == "short_rings":
        assert picked[counts == 17].any() and (counts < 17).sum() >= 4


@pytest.mark.parametrize("case", ["hdl64_sweep", "occluded", "short_rings",
                                  "vlp16_sweep"])
def test_operator_cpu_kernel_is_the_plain_version(grids, case):
    """``feature_picks`` (through ``pick_features``, as extract_features
    calls it) on CPU tensors returns ``select_features`` over
    ``compute_curvature`` and launches nothing."""
    grid, scan, pre = grids[case]
    FEATURES.launches = 0
    label, okey = pick_features(grid, scan, pre_suppressed=pre)
    assert FEATURES.launches == 0
    want_label, want_okey = plain_picks(grid, scan, pre)
    assert label.dtype == torch.int8 and okey.dtype == torch.int32
    assert torch.equal(label, want_label) and torch.equal(okey, want_okey)


@pytest.mark.parametrize("occluded", [False, True])
def test_vmap_of_the_operator_is_single_calls(grids, occluded):
    """Three lanes (the HDL-64E sweep, the tie grid and the dense grid, 64
    rings of 2304 columns each) under ``torch.vmap``: each lane bit for
    bit its own call, with and without pre-suppressed points (the
    occlusion filter's of each lane)."""
    scan = grids["occluded" if occluded else "hdl64_sweep"][1]
    lanes = [pad_rings(grids[c][0], 64) for c in FEATURE_LANE_CASES[:3]]
    pres = [occlusion_mask(g, scan) if occluded else None for g in lanes]
    numbers = (scan.n_sectors, scan.max_sharp_per_sector,
               scan.max_less_sharp_per_sector, scan.max_flat_per_sector,
               scan.suppression_radius, scan.curvature_threshold,
               scan.suppression_gap_sq)
    stacked = [torch.stack(x) for x in zip(*((g.xyz, g.mask, g.counts)
                                             for g in lanes))]
    if occluded:
        label, okey = torch.vmap(
            lambda x, m, c, p: feature_picks(x, m, c, p, *numbers))(
                *stacked, torch.stack(pres))
        assert all(p.any() for p in pres)
    else:
        label, okey = torch.vmap(
            lambda x, m, c: feature_picks(x, m, c, None, *numbers))(*stacked)
    for b, (g, p) in enumerate(zip(lanes, pres)):
        single = feature_picks(g.xyz, g.mask, g.counts, p, *numbers)
        assert torch.equal(label[b], single[0])
        assert torch.equal(okey[b], single[1])
    assert all((label[b] == -1).any() for b in range(3))

