"""Scan-to-map back end with the sliding voxel-cube world map
(reference: src/laserMapping.cpp).

Counterpart of ``light_loam_tpu/models/mapping.py``.  The reference's
21×21×11 array of per-cell clouds (ref:45-75) is two flat fixed-capacity
stores (corner/surf), each point tagged with its linear cube-cell index.
Recentering (ref:1595-1779) is index arithmetic: shifting the grid adds a
constant to every cell index and drops points that roll out.  The per-cell
voxel re-filter (ref:2154-2168) is a voxel dedup over the whole store with
the cell id folded into the key.

Per frame (``mapping_step``, ref:1502-2354):
  1. odom→map association (ref:113-117,1581);
  2. grid recentering with a ≥3-cell margin (ref:1584-1779);
  3. 5×5×3 local-map gather (ref:1784-1809) + stack downsample
     (ref:1814-1822);
  4. if the local map is big enough (ref:1826): outer iterations of
     5-NN (``ops/cuda_knn.py``) → line/plane fit → LM (ref:1834-2094);
  5. transformUpdate (ref:119-123,2101);
  6. register the stacks into the map + voxel dedup (ref:2104-2168).

Whether the grid recentered decides, on the host, between the sorted
merge and the full re-sort: one device-to-host read per mapped frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from light_loam_tpu_torch.config import MappingConfig
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.ops import graphvote
from light_loam_tpu_torch.ops.cuda_knn import knn5
from light_loam_tpu_torch.ops.eig3 import eigh3x3
from light_loam_tpu_torch.ops.sorted_store import merge_sorted
from light_loam_tpu_torch.ops.voxel import compact_rows, voxel_downsample
from light_loam_tpu_torch.solver import (
    EdgeFactors,
    FactorSet,
    PlaneNormFactors,
    lm_solve,
)


class MapStore(NamedTuple):
    """Flat point store for one feature type over the whole cube grid."""

    xyz: torch.Tensor   # (N, 3) world coordinates
    cell: torch.Tensor  # (N,) int32 linear cube index i + W*j + W*H*k
    mask: torch.Tensor  # (N,) bool

    @staticmethod
    def zeros(capacity: int, device=None) -> "MapStore":
        return MapStore(
            xyz=torch.zeros((capacity, 3), device=device),
            cell=torch.zeros((capacity,), dtype=torch.int32, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


class MappingState(NamedTuple):
    corner: MapStore
    surf: MapStore
    cen: torch.Tensor   # (3,) int32 — laserCloudCenWidth/Height/Depth
    q_wm: torch.Tensor  # (4,) map←odom rotation (q_wmap_wodom)
    t_wm: torch.Tensor  # (3,)
    frame: torch.Tensor  # int32 mapped-frame counter (gates the map vote)

    @staticmethod
    def init(cfg: MappingConfig, device=None) -> "MappingState":
        return MappingState(
            corner=MapStore.zeros(cfg.map_corner_capacity, device),
            surf=MapStore.zeros(cfg.map_surf_capacity, device),
            # initial grid center (laserMapping.cpp:45-47)
            cen=torch.tensor([10, 10, 5], dtype=torch.int32, device=device),
            q_wm=quat.quat_identity(device=device),
            t_wm=torch.zeros(3, device=device),
            frame=torch.zeros((), dtype=torch.int32, device=device),
        )


class MappingOutput(NamedTuple):
    q_w: torch.Tensor
    t_w: torch.Tensor
    corner_factors: torch.Tensor
    surf_factors: torch.Tensor
    map_corner_points: torch.Tensor
    map_surf_points: torch.Tensor
    # neighbourhood points that did not fit the local-map capacities this
    # step (0 = healthy; >0 means whole cells were dropped)
    local_overflow: torch.Tensor


def check_mapping_config(cfg: MappingConfig) -> None:
    """Raise for the options this port does not implement."""
    if cfg.knn_k != 5:
        raise ValueError(
            f"MappingConfig.knn_k={cfg.knn_k}: the 5-NN kernel takes k=5")
    if cfg.knn_backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown MappingConfig.knn_backend="
                         f"{cfg.knn_backend!r}")
    if cfg.map_store_mode not in ("sorted", "resort"):
        raise ValueError(f"unknown MappingConfig.map_store_mode="
                         f"{cfg.map_store_mode!r}")
    if cfg.vote_mode not in graphvote.VOTE_MODES:
        raise ValueError(f"unknown MappingConfig.vote_mode={cfg.vote_mode!r}")


def _dims(cfg: MappingConfig):
    return (cfg.cube_width, cfg.cube_height, cfg.cube_depth)


def _inside(ijk: torch.Tensor, cfg: MappingConfig) -> torch.Tensor:
    """(N, 3) cube coordinates -> (N,) inside the grid."""
    inside = (ijk >= 0).all(dim=-1)
    for axis, size in enumerate(_dims(cfg)):
        inside = inside & (ijk[..., axis] < size)
    return inside


def _cube_of(xyz: torch.Tensor, cen: torch.Tensor, cfg: MappingConfig):
    """World position -> (i, j, k) cube coordinate (laserMapping.cpp:
    1584-1593: int((x+25)/50)+cen with a −1 correction for negatives ==
    floor)."""
    half = cfg.cube_size / 2.0
    return (torch.floor((xyz + half) / cfg.cube_size).to(torch.int32)
            + cen[None, :])


def _cell_linear(ijk: torch.Tensor, cfg: MappingConfig):
    return (
        ijk[..., 0]
        + cfg.cube_width * ijk[..., 1]
        + cfg.cube_width * cfg.cube_height * ijk[..., 2]
    )


def _cell_split(cell: torch.Tensor, cfg: MappingConfig):
    i = cell % cfg.cube_width
    j = (cell // cfg.cube_width) % cfg.cube_height
    k = cell // (cfg.cube_width * cfg.cube_height)
    return torch.stack([i, j, k], dim=-1)


def _recenter(state: MappingState, t_w: torch.Tensor, cfg: MappingConfig):
    """Shift the grid so the pose cube keeps a ≥3-cell margin
    (ref:1595-1779); returns (corner, surf, cen, center cube ijk)."""
    center = _cube_of(t_w[None, :], state.cen, cfg)[0]
    m = cfg.recenter_margin
    over = torch.stack([torch.clamp(center[a] - (size - m - 1), min=0)
                        for a, size in enumerate(_dims(cfg))])
    shift = torch.clamp(m - center, min=0) - over
    center = center + shift
    cen = state.cen + shift

    def apply(store: MapStore) -> MapStore:
        ijk = _cell_split(store.cell, cfg) + shift[None, :]
        inside = _inside(ijk, cfg)
        cell = torch.where(inside, _cell_linear(ijk, cfg),
                           torch.zeros_like(ijk[:, 0]))
        return MapStore(xyz=store.xyz, cell=cell.to(torch.int32),
                        mask=store.mask & inside)

    return apply(state.corner), apply(state.surf), cen, center


def _gather_local(store: MapStore, center: torch.Tensor, cfg: MappingConfig,
                  capacity: int):
    """Compact the points of the 5×5×3 neighbourhood (ref:1784-1809) into a
    fixed-capacity buffer ordered by cell id.

    Every store here is cell-nondecreasing on its live rows (voxel-key
    order embeds the cell, and recentering adds one constant to every live
    cell id), so a stable mask compaction in store order is the sort by
    cell id.  Returns (xyz, mask, overflow): overflow counts the
    neighbourhood points that did not fit (whole high-index cells)."""
    d = (_cell_split(store.cell, cfg) - center[None, :]).abs()
    local = (
        store.mask
        & (d[:, 0] <= cfg.local_half_i)
        & (d[:, 1] <= cfg.local_half_j)
        & (d[:, 2] <= cfg.local_half_k)
    )
    overflow = torch.clamp(local.sum(dtype=torch.int32) - capacity, min=0)
    out_mask, xyz = compact_rows(local, capacity, store.xyz)
    return xyz, out_mask, overflow


def _solve3x3(A: torch.Tensor, b: torch.Tensor):
    """Batched 3×3 solve via the adjugate (A (...,3,3), b (...,3))."""
    a = A
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adjT = torch.stack(
        [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    ok = det.abs() > 1e-20
    safe_det = torch.where(ok, det, torch.ones_like(det))
    x = torch.einsum("...ij,...j->...i", adjT, b) / safe_det[..., None]
    return x, ok


def line_fit_factors(stack_xyz, stack_mask, d, near, cfg: MappingConfig):
    """Line factors from 5-NN covariance eigen-analysis (ref:1886-1921),
    given the neighbour sets (d (Q,k) ascending, near (Q,k,3))."""
    center = near.mean(dim=1)
    diff = near - center[:, None, :]
    cov = torch.einsum("qni,qnj->qij", diff, diff)
    vals, vmax = eigh3x3(cov)
    is_line = vals[:, 2] > cfg.line_eig_ratio * vals[:, 1]
    ok = stack_mask & (d[:, cfg.knn_k - 1] < cfg.knn_sq_gate) & is_line
    n = stack_xyz.shape[0]
    ones = torch.ones(n, device=stack_xyz.device)
    return EdgeFactors(
        cp=stack_xyz,
        a=center + cfg.line_point_offset * vmax,
        b=center - cfg.line_point_offset * vmax,
        s=ones, weight=ones, mask=ok,
    )


def plane_fit_factors(stack_xyz, stack_mask, d, near, cfg: MappingConfig):
    """Plane factors from the 5-NN least-squares fit A·n = −1
    (ref:1948-2036), given the neighbour sets."""
    AtA = torch.einsum("qni,qnj->qij", near, near)
    Atb = -near.sum(dim=1)
    nvec, solv_ok = _solve3x3(AtA, Atb)
    norm = torch.sqrt(torch.clamp(torch.sum(nvec * nvec, dim=-1), min=1e-20))
    neg_d = 1.0 / norm
    n_hat = nvec / norm[:, None]
    resid = (torch.einsum("qni,qi->qn", near, n_hat) + neg_d[:, None]).abs()
    plane_ok = torch.all(resid <= cfg.plane_fit_gate, dim=1)
    ok = (
        stack_mask
        & (d[:, cfg.knn_k - 1] < cfg.knn_sq_gate)
        & plane_ok
        & solv_ok
    )
    return PlaneNormFactors(
        cp=stack_xyz, n=n_hat, d=neg_d,
        weight=torch.ones(stack_xyz.shape[0], device=stack_xyz.device),
        mask=ok,
    )


def _merge_full(store: MapStore, new_xyz, new_cell, new_mask,
                leaf: float, capacity: int) -> MapStore:
    """Append registered points and voxel-dedup the whole store by a full
    re-sort (ref:2104-2168).  The output is sorted by voxel key with dead
    rows at the tail — the invariant the sorted merge relies on."""
    all_xyz = torch.cat([store.xyz, new_xyz], dim=0)
    xyz, _, mask, cell = voxel_downsample(
        all_xyz, torch.zeros(all_xyz.shape[0], device=all_xyz.device),
        torch.cat([store.mask, new_mask], dim=0), leaf, capacity,
        extra_key=torch.cat([store.cell, new_cell], dim=0),
    )
    return MapStore(xyz=xyz, cell=cell, mask=mask)


def _merge_into_store(store: MapStore, new_xyz, new_mask, cen, cfg,
                      leaf: float, capacity: int,
                      recentered: bool) -> MapStore:
    """Register a frame's stack into the map store (ref:2104-2168); points
    outside the grid are dropped (ref:2119-2121).  Between recenters
    (rows are only evicted there) the sorted merge applies; recenter
    frames, and map_store_mode="resort", re-sort the whole store."""
    ijk = _cube_of(new_xyz, cen, cfg)
    inside = _inside(ijk, cfg)
    new_cell = torch.where(inside, _cell_linear(ijk, cfg),
                           torch.zeros_like(ijk[:, 0])).to(torch.int32)
    new_mask = new_mask & inside
    if recentered or cfg.map_store_mode == "resort":
        return _merge_full(store, new_xyz, new_cell, new_mask, leaf, capacity)
    xyz, cell, mask = merge_sorted(store.xyz, store.cell, store.mask,
                                   new_xyz, new_cell, new_mask, leaf)
    return MapStore(xyz=xyz, cell=cell, mask=mask)


def _neighbours(stack_xyz, n_stack, local_xyz, local_mask, n_local, q_w, t_w,
                cfg: MappingConfig):
    """5-NN of the stack (moved by the current pose) in the local map; both
    are live-prefix buffers, so the kernel visits only their live rows."""
    if cfg.knn_backend == "xla" and local_xyz.is_cuda:
        raise ValueError(
            "MappingConfig.knn_backend='xla' selects the plain PyTorch "
            "5-NN, which the port runs only on CPU tensors; use 'auto' on "
            "CUDA")
    p_sel = quat.quat_rotate(q_w[None, :], stack_xyz) + t_w[None, :]
    counts = torch.stack([n_stack, n_local]).to(torch.int32)
    d, idx = knn5(p_sel, local_xyz, local_mask, counts)
    return d, local_xyz[idx.to(torch.int64)]


def mapping_step(
    state: MappingState,
    corner_last: PointCloud,
    surf_last: PointCloud,
    q_odom: torch.Tensor,
    t_odom: torch.Tensor,
    cfg: MappingConfig,
) -> Tuple[MappingState, MappingOutput]:
    check_mapping_config(cfg)
    # 1. initial guess from odometry (ref:113-117)
    q_w = quat.quat_normalize(quat.quat_multiply(state.q_wm, q_odom))
    t_w = quat.quat_rotate(state.q_wm, t_odom) + state.t_wm

    # 2. recenter grid
    corner_store, surf_store, cen, center = _recenter(state, t_w, cfg)

    # 3. local map + stacks
    local_c_xyz, local_c_mask, ovf_c = _gather_local(
        corner_store, center, cfg, cfg.local_corner_capacity)
    local_s_xyz, local_s_mask, ovf_s = _gather_local(
        surf_store, center, cfg, cfg.local_surf_capacity)
    stack_c_xyz, _, stack_c_mask, _ = voxel_downsample(
        corner_last.xyz, corner_last.rel, corner_last.mask,
        cfg.line_resolution, cfg.stack_corner_capacity,
    )
    stack_s_xyz, _, stack_s_mask, _ = voxel_downsample(
        surf_last.xyz, surf_last.rel, surf_last.mask,
        cfg.plane_resolution, cfg.stack_surf_capacity,
    )
    n_local_c = local_c_mask.sum(dtype=torch.int32)
    n_local_s = local_s_mask.sum(dtype=torch.int32)
    n_stack_c = stack_c_mask.sum(dtype=torch.int32)
    n_stack_s = stack_s_mask.sum(dtype=torch.int32)
    big_enough = (n_local_c > cfg.min_corner_map_points) & (
        n_local_s > cfg.min_surf_map_points)
    use_vote = cfg.vote_mode != "off" and state.frame > cfg.vote_start_frame

    # 4. scan-to-map refinement (outer × LM)
    n_cf = torch.zeros((), dtype=torch.int32, device=t_w.device)
    n_sf = torch.zeros((), dtype=torch.int32, device=t_w.device)
    for _ in range(cfg.outer_iterations):
        d_c, near_c = _neighbours(stack_c_xyz, n_stack_c, local_c_xyz,
                                  local_c_mask, n_local_c, q_w, t_w, cfg)
        ef = line_fit_factors(stack_c_xyz, stack_c_mask & big_enough,
                              d_c, near_c, cfg)
        d_s, near_s = _neighbours(stack_s_xyz, n_stack_s, local_s_xyz,
                                  local_s_mask, n_local_s, q_w, t_w, cfg)
        pf = plane_fit_factors(stack_s_xyz, stack_s_mask & big_enough,
                               d_s, near_s, cfg)
        if cfg.vote_mode != "off":
            # latent mapping-stage vote, "simple" or "full"
            # (laserMapping.cpp:2057-2072): src = stack point, tgt = 5-NN
            # centroid; survivors keep their plane factor, the rest are
            # dropped
            sel, w = graphvote.run_vote(
                cfg.vote_mode, stack_s_xyz, near_s.mean(dim=1), pf.mask,
                n_regions=cfg.vote_regions,
                chunk_capacity=(cfg.stack_surf_capacity // cfg.vote_regions
                                + cfg.vote_regions),
                score_threshold=cfg.vote_score_threshold,
                resolution=cfg.vote_resolution,
                selected_ratio=cfg.vote_selected_ratio,
                low_vote_count=cfg.vote_low_vote_count,
                low_vote_weight=cfg.vote_low_vote_weight,
                high_vote_weight=cfg.vote_high_vote_weight,
                backend=cfg.vote_backend,
            )
            pf = pf._replace(
                mask=pf.mask & (sel | ~use_vote),
                weight=torch.where(use_vote & cfg.vote_apply_weights, w,
                                   pf.weight),
            )
        q_w, t_w, _cost = lm_solve(
            q_w, t_w, FactorSet(edge=ef, plane_norm=pf),
            n_iterations=cfg.inner_iterations,
            huber_delta=cfg.huber_delta,
        )
        n_cf = ef.mask.sum(dtype=torch.int32)
        n_sf = pf.mask.sum(dtype=torch.int32)

    # 5. refresh odom→map correction (ref:119-123)
    q_wm = quat.quat_normalize(quat.quat_multiply(q_w, quat.quat_inverse(q_odom)))
    t_wm = t_w - quat.quat_rotate(q_wm, t_odom)

    # 6. register the stacks into the map (host branch: one sync)
    recentered = bool(torch.any(cen != state.cen))
    reg_c = quat.quat_rotate(q_w[None, :], stack_c_xyz) + t_w[None, :]
    reg_s = quat.quat_rotate(q_w[None, :], stack_s_xyz) + t_w[None, :]
    corner_store = _merge_into_store(
        corner_store, reg_c, stack_c_mask, cen, cfg,
        cfg.line_resolution, cfg.map_corner_capacity, recentered)
    surf_store = _merge_into_store(
        surf_store, reg_s, stack_s_mask, cen, cfg,
        cfg.plane_resolution, cfg.map_surf_capacity, recentered)

    new_state = MappingState(
        corner=corner_store, surf=surf_store, cen=cen, q_wm=q_wm, t_wm=t_wm,
        frame=state.frame + 1,
    )
    out = MappingOutput(
        q_w=q_w, t_w=t_w,
        corner_factors=n_cf, surf_factors=n_sf,
        map_corner_points=corner_store.mask.sum(dtype=torch.int32),
        map_surf_points=surf_store.mask.sum(dtype=torch.int32),
        local_overflow=ovf_c + ovf_s,
    )
    return new_state, out
