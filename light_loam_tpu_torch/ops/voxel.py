"""Voxel-grid centroid downsampling with static shapes.

Counterpart of ``light_loam_tpu/ops/voxel.py``: the replacement for
``pcl::VoxelGrid`` (less-flat cloud at 0.2 m, src/scanRegistration.cpp:
370-376; mapping stacks and cube cells, src/laserMapping.cpp:1814-1822,
2154-2168).  Voxel keys -> stable sort -> segment mean; the lattice is
anchored at the world origin and the output is ordered by voxel key.

The JAX package sorts a (major, minor) int32 key pair because JAX runs
without 64-bit integers.  Here the pair is one int64 key, ``major << 32 |
minor``, whose order is the lexicographic order of the pair, and the
per-ring downsample folds the ring id into the same key so every ring
shares one sort.

The float sums per voxel are ``ops/cuda_segsum.py`` ``segment_sum`` over
the key-sorted rows: each voxel's points are added in sorted order, on the
card by ``csrc/segsum.cu`` and on the CPU by ``index_add``, so a centroid
has the same bits on every run, and the same on both devices given the
same rows.  The integer sums and maxima stay ``index_add`` /
``scatter_reduce``: exact in any order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from light_loam_tpu_torch.ops.cuda_segsum import segment_sum

# Voxel indices are biased into [0, 2**15) per axis; supports |coord| up to
# ~3200 m at a 0.2 m leaf.
_BIAS = 1 << 14
_AXIS_RANGE = 1 << 15
# Key of a masked point: the JAX package's (2**31-1, 2**31-1) sentinel pair.
SENTINEL_KEY = ((2**31 - 1) << 32) | (2**31 - 1)
# Per-ring keys carry the ring id above bit 47 (major < 2**15 there).
_RING_SHIFT = 47
_INT64_MAX = 2**63 - 1


def voxel_keys(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    leaf: float,
    extra_key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """int64 voxel key per point, ``major << 32 | minor`` with the JAX
    package's (major, minor) pair; masked points get ``SENTINEL_KEY``.

    ``extra_key`` (e.g. a cube-cell id) separates otherwise-identical
    lattices so multiple cells can be filtered in one call."""
    ijk = torch.floor(xyz / leaf).to(torch.int64) + _BIAS
    ijk = torch.clamp(ijk, 0, _AXIS_RANGE - 1)
    minor = ijk[..., 0] * _AXIS_RANGE + ijk[..., 1]
    major = ijk[..., 2]
    if extra_key is not None:
        major = major + extra_key.to(torch.int64) * _AXIS_RANGE
    key = (major << 32) | minor
    return torch.where(mask, key, torch.full_like(key, SENTINEL_KEY))


def _segments(key_sorted: torch.Tensor, valid_sorted: torch.Tensor,
              capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(head, seg): segment heads of a sorted key array and each row's
    segment slot, ``capacity`` for dead or overflowing rows."""
    prev = torch.cat([key_sorted.new_full((1,), -1), key_sorted[:-1]])
    head = (key_sorted != prev) & valid_sorted
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    seg = torch.where(valid_sorted, torch.clamp(seg, 0, capacity),
                      torch.full_like(seg, capacity))
    return head, seg


def _masked_payload(xyz, rel, valid):
    """Rows [xyz, rel, 1] of live points and zeros for dead ones."""
    cols = torch.cat([xyz, rel[:, None], torch.ones_like(rel)[:, None]], 1)
    return torch.where(valid[:, None], cols, torch.zeros((), device=xyz.device))


def voxel_downsample(
    xyz: torch.Tensor,
    rel: torch.Tensor,
    mask: torch.Tensor,
    leaf: float,
    capacity: int,
    extra_key: Optional[torch.Tensor] = None,
    with_count: bool = False,
):
    """Centroid-downsample a masked cloud.

    Returns (xyz_out (capacity, 3), rel_out, mask_out, extra_out) in voxel
    key order; ``extra_out`` carries each voxel's ``extra_key`` (zeros
    when not supplied).  Voxels beyond ``capacity`` are dropped;
    ``with_count=True`` adds a fifth return, the number of distinct live
    voxels before that clip (int32), so that a caller can report the
    drop."""
    key = voxel_keys(xyz, mask, leaf, extra_key)
    key_s, order = torch.sort(key, stable=True)
    valid_s = mask[order]
    head, seg = _segments(key_s, valid_s, capacity)

    payload = _masked_payload(xyz[order], rel[order], valid_s)
    acc = segment_sum(payload, seg, capacity)
    if extra_key is not None:
        ex = torch.where(valid_s, extra_key[order].to(torch.int32),
                         torch.zeros((), dtype=torch.int32, device=xyz.device))
        extra_out = torch.zeros(capacity + 1, dtype=torch.int32,
                                device=xyz.device).scatter_reduce(
            0, seg, ex, "amax", include_self=True)[:capacity]
    else:
        extra_out = torch.zeros(capacity, dtype=torch.int32, device=xyz.device)

    cnt = acc[:, 4]
    denom = torch.clamp(cnt, min=1.0)
    out = (acc[:, :3] / denom[:, None], acc[:, 3] / denom, cnt > 0, extra_out)
    if with_count:
        return out + (head.sum(dtype=torch.int32),)
    return out


def voxel_downsample_rings(
    xyz: torch.Tensor,
    rel: torch.Tensor,
    mask: torch.Tensor,
    leaf: float,
    ring_capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ring voxel downsample into a ring-slotted grid.

    Inputs are range-image grids (R, H, 3)/(R, H); output is
    (R, ring_capacity, ...) where ring r's voxels occupy the row-r prefix
    in key order — the layout ``ops.knn.surf_correspondences_grid`` needs.
    A ring with more than ``ring_capacity`` voxels is decimated by a
    uniform stride over its key-sorted voxel list, as in the JAX package.
    All rings share one sort: the ring id sits above the voxel key."""
    R, H = mask.shape
    C = ring_capacity
    dev = xyz.device
    flat_mask = mask.reshape(-1)
    ring = torch.arange(R, device=dev).repeat_interleave(H)
    key = voxel_keys(xyz.reshape(-1, 3), flat_mask, leaf)
    key = torch.where(flat_mask, (ring << _RING_SHIFT) | key,
                      torch.full_like(key, _INT64_MAX))
    key_s, order = torch.sort(key, stable=True)
    valid_s = flat_mask[order]
    head, seg = _segments(key_s, valid_s, R * H)

    payload = _masked_payload(xyz.reshape(-1, 3)[order],
                              rel.reshape(-1)[order], valid_s)
    acc = segment_sum(payload, seg, R * H)
    denom = torch.clamp(acc[:, 4], min=1.0)
    cent = torch.cat([acc[:, :3] / denom[:, None], (acc[:, 3] / denom)[:, None]],
                     dim=1)

    # voxels per ring and each ring's first voxel slot
    n = torch.zeros(R, dtype=torch.int64, device=dev).index_add(
        0, order // H, head.to(torch.int64))
    first = torch.cumsum(n, 0) - n
    j = torch.arange(C, dtype=torch.int64, device=dev)[None, :]
    nr = n[:, None]
    src = torch.where(nr > C, (j * nr) // C, j)
    keep = j < torch.clamp(nr, max=C)
    gid = torch.clamp(first[:, None] + src, max=R * H - 1)
    out = torch.where(keep[..., None], cent[gid], torch.zeros((), device=dev))
    return out[..., :3], out[..., 3], keep


def voxel_downsample_rings_runs(
    xyz: torch.Tensor,
    rel: torch.Tensor,
    mask: torch.Tensor,
    leaf: float,
    ring_capacity: int,
    max_run: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free per-ring voxel downsample: run-length merge along the
    azimuth axis (``ScanConfig.lessflat_mode="runs"``).

    A laser ring is a 1-D space curve, so points sharing a voxel are almost
    always azimuth-consecutive; merging maximal same-voxel runs reproduces
    the per-ring voxel grid up to (a) voxels the ring re-enters later (one
    centroid per visit: a few % denser cloud) and (b) runs longer than
    ``max_run`` slots, masked gaps included (the tail points leave the
    centroid).  Masked slots are transparent: a run continues across them.

    The layout of ``voxel_downsample_rings`` — (R, ring_capacity)
    ring-slotted, decimated by a uniform stride when a ring overflows — but
    with rows in azimuth order.  Cumulative sums and maxima, a per-row
    binary search and gathers: no sort and no scatter, and no host read."""
    R, H = mask.shape
    C = ring_capacity
    dev = xyz.device
    key = voxel_keys(xyz, mask, leaf)

    # the previous live slot of each slot (an exclusive running max of the
    # live slots' indices), -1 before the first
    iota = torch.arange(H, device=dev).expand(R, H)
    live = torch.where(mask, iota, torch.full_like(iota, -1))
    prev = torch.cat([torch.full((R, 1), -1, dtype=torch.int64, device=dev),
                      torch.cummax(live, dim=1).values[:, :-1]], dim=1)
    new_key = key != key.gather(1, torch.clamp(prev, min=0))
    head = mask & ((prev < 0) | new_key)

    # run ids, nondecreasing along the ring: a masked slot carries the run
    # before it, so the first slot whose id is >= j is run j's head
    seg = torch.cumsum(head.to(torch.int64), dim=1) - 1
    n = (seg[:, -1] + 1)[:, None]
    j = torch.arange(C, device=dev).expand(R, C)
    src_run = torch.where(n > C, (j * n) // C, j)
    keep = j < torch.clamp(n, max=C)
    start = torch.searchsorted(seg, src_run)
    end = torch.searchsorted(seg, src_run + 1)

    # the mean over each run's window, one slot of every run per pass
    payload = torch.cat([xyz, rel[..., None], mask[..., None].to(xyz.dtype)],
                        dim=-1)
    sum_xyz = xyz.new_zeros((R, C, 3))
    sum_rel = rel.new_zeros((R, C))
    cnt = xyz.new_zeros((R, C))
    for k in range(max_run):
        idx = torch.clamp(start + k, max=H - 1)
        g = payload.gather(1, idx[..., None].expand(R, C, 5))
        w = ((start + k) < end).to(xyz.dtype) * g[..., 4]
        sum_xyz = sum_xyz + w[..., None] * g[..., :3]
        sum_rel = sum_rel + w * g[..., 3]
        cnt = cnt + w
    denom = torch.clamp(cnt, min=1.0)
    zero = torch.zeros((), device=dev)
    out_xyz = torch.where(keep[..., None], sum_xyz / denom[..., None], zero)
    out_rel = torch.where(keep, sum_rel / denom, zero)
    return out_xyz, out_rel, keep & (cnt > 0)


def compact(
    values: torch.Tensor,
    mask: torch.Tensor,
    capacity: int,
    keys: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather masked rows to the front, optionally ordered by ``keys``.

    Returns (gather_indices (capacity,), out_mask (capacity,), order) where
    ``values[gather_indices]`` is the compacted array: a stable argsort of
    the keys (the row index by default) with masked-out rows keyed past
    every live one (2**31 - 1, the JAX package's int32 sentinel).
    ``values`` is only used for its leading dimension."""
    n = values.shape[0]
    dev = mask.device
    if keys is None:
        keys = torch.arange(n, dtype=torch.int32, device=dev)
    sort_key = torch.where(mask, keys, torch.full_like(keys, 2**31 - 1))
    order = torch.argsort(sort_key, stable=True)
    count = mask.to(torch.int64).sum()
    out_mask = torch.arange(capacity, device=dev) < count
    return order[:capacity], out_mask, order


def compact_rows(
    mask: torch.Tensor,
    capacity: int,
    *arrays: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Stable mask compaction by prefix sum + index scatter, no sort.

    Moves rows where ``mask`` is True to the output prefix in input order;
    rows past ``capacity`` are dropped from the high end and dead output
    rows are zero.  Returns ``(out_mask, *compacted_arrays)``."""
    n = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (pos < capacity), pos,
                      torch.full_like(pos, capacity))
    src = torch.zeros(capacity + 1, dtype=torch.int64, device=dev).scatter(
        0, tgt, torch.arange(n, device=dev))[:capacity]
    out_mask = torch.arange(capacity, device=dev) < pos[-1] + 1
    outs = []
    for a in arrays:
        mm = out_mask.reshape((capacity,) + (1,) * (a.dim() - 1))
        outs.append(torch.where(mm, a[src], torch.zeros((), dtype=a.dtype,
                                                        device=dev)))
    return (out_mask, *outs)
