"""Scan-to-scan odometry front end (reference: src/laserOdometry.cpp).

Counterpart of ``light_loam_tpu/models/odometry.py``.  One step per frame
with the live-path schedule:

  * ``outer_iterations`` re-association passes, each rebuilding
    correspondences with the current incremental pose and running
    ``inner_iterations`` LM steps (Ceres max_num_iterations, ref:822);
  * corner features → LidarEdgeFactor for every valid match, unweighted
    (ref:615-617);
  * planar features → frames ≤ 5: all valid matches at weight 1
    (ref:781-787); later frames: only graph-vote-selected matches at the
    vote weight (ref:794-810).  The vote runs on every pass of every frame
    and its result is used once the frame counter passes the gate, so the
    step never waits on the device to decide;
  * world-pose integration t_w += q_w·t_lc, q_w *= q_lc (ref:830-831);
  * the feature clouds become the "last" clouds of the next frame
    (ref:882-896); the incremental pose warm-starts the next solve.

The first frame solves nothing: the empty "last" clouds yield no valid
factors and the LM leaves the pose alone.

Options off the live path, all ported: the corner vote ("simple" or
"full"; vote-selected corners become weighted scalar edge factors once
the frame counter passes the gate, laserOdometry.cpp:628-643), the full
graph vote for planes, the distortion hook (per-point sweep fraction and
the undistorted hand-off, laserOdometry.cpp:77-114,861-880) and the tiled
surf search.  With ``surf_knn="tiled"`` the stored less-flat cloud is
compacted to a live prefix at the hand-off, and the step reads that
cloud's live count to the host once, before the outer loop, so each pass
visits only the live tiles: one device-to-host read per frame, none per
outer iteration.  With ``read_live_count=False`` (the fused frame, which a
CUDA graph replays and which therefore cannot read to the host) the sweep
covers every tile instead; masked rows cannot win, so the matches are the
same.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from light_loam_tpu_torch.config import OdometryConfig
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.core.frame import PointCloud, ScanFeatures
from light_loam_tpu_torch.ops import graphvote, knn
from light_loam_tpu_torch.ops.voxel import compact_rows
from light_loam_tpu_torch.solver import (
    EdgeFactors,
    EdgeScalarFactors,
    FactorSet,
    lm_solve,
    make_plane_factors,
)


class OdometryState(NamedTuple):
    corner_last: PointCloud  # previous less-sharp cloud
    surf_last: PointCloud    # previous less-flat cloud
    q_w: torch.Tensor        # (4,) world←current rotation
    t_w: torch.Tensor        # (3,)
    q_lc: torch.Tensor       # (4,) last←current increment (warm start)
    t_lc: torch.Tensor       # (3,)
    frame: torch.Tensor      # int32 — `now_frame` counter

    @staticmethod
    def init(corner_capacity: int, surf_capacity: int,
             device=None) -> "OdometryState":
        return OdometryState(
            corner_last=PointCloud.zeros(corner_capacity, device),
            surf_last=PointCloud.zeros(surf_capacity, device),
            q_w=quat.quat_identity(device=device),
            t_w=torch.zeros(3, device=device),
            q_lc=quat.quat_identity(device=device),
            t_lc=torch.zeros(3, device=device),
            frame=torch.zeros((), dtype=torch.int32, device=device),
        )


class OdometryOutput(NamedTuple):
    q_w: torch.Tensor
    t_w: torch.Tensor
    corner_count: torch.Tensor
    plane_count: torch.Tensor


def check_odometry_config(cfg: OdometryConfig) -> None:
    """Raise ValueError for an option string this port does not know."""
    if cfg.surf_knn not in ("auto", "grid", "tiled"):
        raise ValueError(f"unknown OdometryConfig.surf_knn={cfg.surf_knn!r}")
    for name in ("plane_vote_mode", "corner_vote_mode"):
        if getattr(cfg, name) not in graphvote.VOTE_MODES:
            raise ValueError(
                f"unknown OdometryConfig.{name}={getattr(cfg, name)!r}")


def _run_vote(mode: str, src, tgt, valid, n_regions: int, chunk_cap: int,
              cfg: OdometryConfig):
    """The configured vote on (src, tgt) pairs; returns (selected, weight)."""
    return graphvote.run_vote(
        mode, src, tgt, valid,
        n_regions=n_regions, chunk_capacity=chunk_cap,
        score_threshold=cfg.vote_score_threshold,
        resolution=cfg.vote_resolution,
        selected_ratio=cfg.vote_selected_ratio,
        low_vote_count=cfg.vote_low_vote_count,
        low_vote_weight=cfg.vote_low_vote_weight,
        high_vote_weight=cfg.vote_high_vote_weight,
        backend=cfg.vote_backend,
    )


def _transform_to_start(q, t, pc: PointCloud, distortion: bool,
                        scan_period: float):
    """TransformToStart (laserOdometry.cpp:77-95): s ≡ 1 unless the
    distortion hook is on, then the point's fraction of the sweep."""
    if distortion:
        s = (pc.rel - torch.floor(pc.rel)) / scan_period
    else:
        s = torch.ones_like(pc.rel)
    qs = quat.quat_slerp_identity(q.expand(pc.xyz.shape[:1] + (4,)), s)
    return quat.quat_rotate(qs, pc.xyz) + s[:, None] * t[None, :], s


def transform_to_end(q, t, pc: PointCloud, distortion: bool = False,
                     scan_period: float = 0.1) -> PointCloud:
    """TransformToEnd (laserOdometry.cpp:99-114): undistort to the sweep
    start, re-express in the end-of-sweep frame and strip the time
    fraction from ``rel``."""
    start_xyz, _s = _transform_to_start(q, t, pc, distortion, scan_period)
    qi = quat.quat_inverse(q).expand(pc.xyz.shape[:1] + (4,))
    end_xyz = quat.quat_rotate(qi, start_xyz - t[None, :])
    return PointCloud(xyz=end_xyz, rel=torch.floor(pc.rel), mask=pc.mask)


def odometry_step(
    state: OdometryState,
    feats: ScanFeatures,
    cfg: OdometryConfig,
    scan_period: float = 0.1,
    read_live_count: bool = True,
) -> Tuple[OdometryState, OdometryOutput]:
    check_odometry_config(cfg)
    sharp, flat = feats.sharp, feats.flat
    q, t = state.q_lc, state.t_lc
    chunk_cap = flat.capacity // cfg.plane_vote_regions + cfg.plane_vote_regions
    c_chunk_cap = (sharp.capacity // cfg.corner_vote_regions
                   + cfg.corner_vote_regions)
    n_rings = feats.full.xyz.shape[0]
    use_vote = state.frame > cfg.vote_start_frame
    corner_last, surf_last = state.corner_last, state.surf_last
    # "auto" is the grid search; the card's default is an open measurement
    # (PERF.md §7)
    tiled = cfg.surf_knn == "tiled"
    # the one device-to-host read of the tiled path: the live prefix of
    # the cloud compacted at the last hand-off
    surf_ref_count = (int(surf_last.count())
                      if tiled and read_live_count else None)

    corner_valid = torch.zeros_like(sharp.mask)
    plane_valid = torch.zeros_like(flat.mask)
    for _ in range(cfg.outer_iterations):
        sharp_sel, s_sharp = _transform_to_start(q, t, sharp, cfg.distortion,
                                                 scan_period)
        flat_sel, s_flat = _transform_to_start(q, t, flat, cfg.distortion,
                                               scan_period)

        cm = knn.corner_correspondences(
            sharp_sel, sharp.mask, corner_last,
            cfg.distance_sq_threshold, cfg.nearby_scan,
        )
        if tiled:
            sm = knn.surf_correspondences(
                flat_sel, flat.mask, surf_last,
                cfg.distance_sq_threshold, cfg.nearby_scan,
                ref_count=surf_ref_count,
            )
        else:
            sm = knn.surf_correspondences_grid(
                flat_sel, flat.mask, surf_last, n_rings,
                cfg.distance_sq_threshold, cfg.nearby_scan,
            )
        corner_a = corner_last.xyz[cm.a_idx]
        corner_b = corner_last.xyz[cm.b_idx]
        ones = torch.ones_like(s_sharp)
        edge_scalar = None
        if cfg.corner_vote_mode == "off":
            # live path: every valid match, never vote-gated
            # (laserOdometry.cpp:615-617)
            edge = EdgeFactors(cp=sharp.xyz, a=corner_a, b=corner_b,
                               s=s_sharp, weight=ones, mask=cm.valid)
        else:
            # latent path (laserOdometry.cpp:628-643): vote-selected
            # corners as weighted scalar edge factors once the gate opens
            c_sel, c_w = _run_vote(cfg.corner_vote_mode, sharp.xyz, corner_a,
                                   cm.valid, cfg.corner_vote_regions,
                                   c_chunk_cap, cfg)
            edge = EdgeFactors(cp=sharp.xyz, a=corner_a, b=corner_b,
                               s=s_sharp, weight=ones,
                               mask=cm.valid & ~use_vote)
            edge_scalar = EdgeScalarFactors(
                cp=sharp.xyz, a=corner_a, b=corner_b, s=s_sharp, weight=c_w,
                mask=cm.valid & c_sel & use_vote)
        # graph vote on plane correspondences: src is the RAW current
        # point, tgt the matched 1-NN (laserOdometry.cpp:751-757)
        p_sel_mask, p_weight = _run_vote(
            cfg.plane_vote_mode, flat.xyz, surf_last.xyz[sm.a_idx], sm.valid,
            cfg.plane_vote_regions, chunk_cap, cfg)
        plane_weight = torch.where(use_vote, p_weight, torch.ones_like(p_weight))
        plane_mask = sm.valid & (p_sel_mask | ~use_vote)
        plane = make_plane_factors(
            cp=flat.xyz,
            a=surf_last.xyz[sm.a_idx],
            b=surf_last.xyz[sm.b_idx],
            c=surf_last.xyz[sm.c_idx],
            s=s_flat,
            weight=plane_weight,
            mask=plane_mask,
        )
        q, t, _cost = lm_solve(
            q, t, FactorSet(edge=edge, plane=plane, edge_scalar=edge_scalar),
            n_iterations=cfg.inner_iterations,
            huber_delta=cfg.huber_delta,
        )
        corner_valid, plane_valid = cm.valid, plane_mask

    # world pose integration (laserOdometry.cpp:830-831)
    t_w = state.t_w + quat.quat_rotate(state.q_w, t)
    q_w = quat.quat_normalize(quat.quat_multiply(state.q_w, q))

    corner_keep, surf_keep = feats.less_sharp, feats.less_flat
    if cfg.distortion:
        # undistorted hand-off (the reference's dormant TransformToEnd
        # block, laserOdometry.cpp:861-880): with motion compensation on,
        # the stored clouds must live in the end-of-sweep frame
        corner_keep = transform_to_end(q, t, corner_keep, True, scan_period)
        surf_keep = transform_to_end(q, t, surf_keep, True, scan_period)
    if tiled:
        # live-prefix compaction for the next frame's tile sweeps; the ring
        # travels in `rel`, so nothing of the layout is lost
        km, kx, kr = compact_rows(surf_keep.mask, surf_keep.capacity,
                                  surf_keep.xyz, surf_keep.rel)
        surf_keep = PointCloud(xyz=kx, rel=kr, mask=km)

    new_state = OdometryState(
        corner_last=corner_keep,
        surf_last=surf_keep,
        q_w=q_w,
        t_w=t_w,
        q_lc=q,
        t_lc=t,
        frame=state.frame + 1,
    )
    out = OdometryOutput(
        q_w=q_w,
        t_w=t_w,
        corner_count=corner_valid.sum(dtype=torch.int32),
        plane_count=plane_valid.sum(dtype=torch.int32),
    )
    return new_state, out
