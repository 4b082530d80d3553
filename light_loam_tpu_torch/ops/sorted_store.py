"""Sorted-store merge: map-store insertion without re-sorting the store.

Counterpart of ``light_loam_tpu/ops/sorted_store.py``.  The map stores
(models/mapping.py MapStore) hold ~131k/262k points and take ~2k/8k new
stack points per frame.  Between grid recenters every store is sorted by
voxel key with dead rows at the tail — what ``voxel_downsample`` emits —
so a frame's points merge in with dense passes:

  1. voxel-key and sort the NEW points only, and reduce them to per-voxel
     (sum, count);
  2. binary-search each new voxel in the store (``torch.searchsorted`` on
     the one int64 key; the JAX package's two-key ``searchsorted2`` exists
     only because JAX runs without 64-bit integers);
  3. matched voxels: running centroid (c_old·w + Σnew)/(w + n), the
     reference's per-cell re-filter (laserMapping.cpp:2154-2168) up to
     float association;
  4. fresh voxels: insertion position + rank among the fresh gives each
     row's final slot and the store shifts right by a cumulative insert
     count — a gather, not a sort.  Overflow drops the highest keys.

Output keys, cells and masks equal the full re-sort merge exactly;
centroids equal it up to float reassociation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from light_loam_tpu_torch.ops.cuda_segsum import segment_sum
from light_loam_tpu_torch.ops.voxel import SENTINEL_KEY, voxel_keys


def voxel_segment_reduce(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    leaf: float,
    cell: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort a small cloud by voxel key and reduce to per-voxel sums.

    Returns (key (M,) int64, sum_xyz (M,3), cnt (M,), cell (M,) int32):
    the unique voxels occupy a key-sorted dense prefix (cnt > 0)."""
    m = xyz.shape[0]
    key = voxel_keys(xyz, mask, leaf, extra_key=cell)
    key_s, order = torch.sort(key, stable=True)
    valid_s = key_s != SENTINEL_KEY
    prev = torch.cat([key_s.new_full((1,), -1), key_s[:-1]])
    head = (key_s != prev) & valid_s
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    seg = torch.where(valid_s, torch.clamp(seg, 0, m), torch.full_like(seg, m))

    zero = torch.zeros((), device=xyz.device)
    # count and coordinate sums as one ordered segment sum
    sums = segment_sum(
        torch.cat([valid_s[:, None].to(xyz.dtype),
                   torch.where(valid_s[:, None], xyz[order], zero)], 1),
        seg, m)
    # exactly one head per segment: these adds write each key/cell once
    ukey = torch.zeros(m + 1, dtype=torch.int64, device=xyz.device).index_add(
        0, seg, torch.where(head, key_s, torch.zeros_like(key_s)))
    cell_s = cell[order].to(torch.int32)
    ucell = torch.zeros(m + 1, dtype=torch.int32, device=xyz.device).index_add(
        0, seg, torch.where(head, cell_s, torch.zeros_like(cell_s)))
    return ukey[:m], sums[:, 1:], sums[:, 0], ucell[:m]


def merge_sorted(
    store_xyz: torch.Tensor,
    store_cell: torch.Tensor,
    store_mask: torch.Tensor,
    new_xyz: torch.Tensor,
    new_cell: torch.Tensor,
    new_mask: torch.Tensor,
    leaf: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge new points into a key-sorted store (module docstring).

    The store MUST be sorted by voxel_keys(xyz, mask, leaf, cell) with dead
    rows at the tail; the output keeps that invariant.  Returns (xyz, cell,
    mask) with the store's shape."""
    n = store_xyz.shape[0]
    m = new_xyz.shape[0]
    dev = store_xyz.device
    skey = voxel_keys(store_xyz, store_mask, leaf, extra_key=store_cell)
    ukey, usum, ucnt, ucell = voxel_segment_reduce(new_xyz, new_mask, leaf,
                                                   new_cell)
    umask = ucnt > 0

    p = torch.searchsorted(skey, ukey, side="left")
    pm = torch.clamp(p, max=n - 1)
    match = umask & (p < n) & (skey[pm] == ukey)

    # matched voxels: running centroid; untouched live rows divide by
    # exactly 1 and stay bitwise intact.  Each live row receives at most one
    # voxel (store keys are unique) and the dump row is thrown away, so
    # these float index_adds add to 0 once: exact in any order
    tgt = torch.where(match, pm, torch.full_like(pm, n))
    add_cnt = store_xyz.new_zeros(n + 1).index_add(0, tgt, ucnt)[:n]
    add_sum = store_xyz.new_zeros((n + 1, 3)).index_add(0, tgt, usum)[:n]
    w = store_mask.to(store_xyz.dtype)
    denom = torch.clamp(w + add_cnt, min=1.0)
    sxyz = (store_xyz * w[:, None] + add_sum) / denom[:, None]
    smask = store_mask | (add_cnt > 0)

    # fresh voxels: final slot = insertion position + rank among fresh;
    # the store shifts right by the cumulative insert count
    fresh = umask & ~match
    frank = torch.cumsum(fresh.to(torch.int64), 0) - 1
    fpos = p + frank
    fp = torch.where(fresh & (fpos < n), fpos, torch.full_like(fpos, n))
    iota_m = torch.arange(m, device=dev)
    ind = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add(
        0, fp, torch.ones_like(fp))[:n]
    fidx = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add(
        0, fp, torch.where(fresh, iota_m, torch.zeros_like(iota_m)))[:n]
    is_f = ind > 0
    src = torch.clamp(torch.arange(n, device=dev) - torch.cumsum(ind, 0),
                      0, n - 1)

    ucent = usum / torch.clamp(ucnt, min=1.0)[:, None]
    out_xyz = torch.where(is_f[:, None], ucent[torch.clamp(fidx, max=m - 1)],
                          sxyz[src])
    out_cell = torch.where(is_f, ucell[torch.clamp(fidx, max=m - 1)],
                           store_cell.to(torch.int32)[src])
    out_mask = is_f | smask[src]
    return out_xyz, out_cell, out_mask


def is_key_sorted(xyz, cell, mask, leaf) -> torch.Tensor:
    """Invariant check (tests): sorted keys, dead rows at the tail."""
    key = voxel_keys(xyz, mask, leaf, extra_key=cell)
    return torch.all(key[:-1] <= key[1:])
