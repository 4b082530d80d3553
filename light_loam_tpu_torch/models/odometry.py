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
factors and the LM leaves the pose alone.  Ported for the grid surf search
with the distortion hook off (every profile's setting); the tiled search,
the corner vote and the distortion hook raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from light_loam_tpu_torch.config import OdometryConfig
from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.core.frame import PointCloud, ScanFeatures
from light_loam_tpu_torch.ops import graphvote, knn
from light_loam_tpu_torch.solver import (
    EdgeFactors,
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
    """Raise for the options this port does not implement yet."""
    if cfg.surf_knn == "tiled":
        raise NotImplementedError(
            "OdometryConfig.surf_knn='tiled' is not ported to PyTorch yet; "
            "use 'auto' or 'grid'")
    if cfg.surf_knn not in ("auto", "grid"):
        raise ValueError(f"unknown OdometryConfig.surf_knn={cfg.surf_knn!r}")
    if cfg.corner_vote_mode != "off":
        raise NotImplementedError(
            "OdometryConfig.corner_vote_mode other than 'off' is not ported "
            "to PyTorch yet")
    if cfg.distortion:
        raise NotImplementedError(
            "OdometryConfig.distortion=True is not ported to PyTorch yet")


def _transform_to_start(q, t, pc: PointCloud):
    """TransformToStart (laserOdometry.cpp:77-95) with s ≡ 1 (the
    distortion hook off)."""
    s = torch.ones_like(pc.rel)
    qs = quat.quat_slerp_identity(q.expand(pc.xyz.shape[:1] + (4,)), s)
    return quat.quat_rotate(qs, pc.xyz) + s[:, None] * t[None, :], s


def odometry_step(
    state: OdometryState,
    feats: ScanFeatures,
    cfg: OdometryConfig,
    scan_period: float = 0.1,
) -> Tuple[OdometryState, OdometryOutput]:
    check_odometry_config(cfg)
    sharp, flat = feats.sharp, feats.flat
    q, t = state.q_lc, state.t_lc
    chunk_cap = flat.capacity // cfg.plane_vote_regions + cfg.plane_vote_regions
    n_rings = feats.full.xyz.shape[0]
    use_vote = state.frame > cfg.vote_start_frame
    corner_last, surf_last = state.corner_last, state.surf_last

    corner_valid = torch.zeros_like(sharp.mask)
    plane_valid = torch.zeros_like(flat.mask)
    for _ in range(cfg.outer_iterations):
        sharp_sel, s_sharp = _transform_to_start(q, t, sharp)
        flat_sel, s_flat = _transform_to_start(q, t, flat)

        cm = knn.corner_correspondences(
            sharp_sel, sharp.mask, corner_last,
            cfg.distance_sq_threshold, cfg.nearby_scan,
        )
        sm = knn.surf_correspondences_grid(
            flat_sel, flat.mask, surf_last, n_rings,
            cfg.distance_sq_threshold, cfg.nearby_scan,
        )
        edge = EdgeFactors(
            cp=sharp.xyz,
            a=corner_last.xyz[cm.a_idx],
            b=corner_last.xyz[cm.b_idx],
            s=s_sharp,
            weight=torch.ones_like(s_sharp),
            mask=cm.valid,
        )
        # graph vote on plane correspondences: src is the RAW current
        # point, tgt the matched 1-NN (laserOdometry.cpp:751-757)
        p_sel_mask, p_weight = graphvote.run_vote(
            cfg.plane_vote_mode, flat.xyz, surf_last.xyz[sm.a_idx], sm.valid,
            n_regions=cfg.plane_vote_regions, chunk_capacity=chunk_cap,
            score_threshold=cfg.vote_score_threshold,
            resolution=cfg.vote_resolution,
            selected_ratio=cfg.vote_selected_ratio,
            low_vote_count=cfg.vote_low_vote_count,
            low_vote_weight=cfg.vote_low_vote_weight,
            high_vote_weight=cfg.vote_high_vote_weight,
            backend=cfg.vote_backend,
        )
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
            q, t, FactorSet(edge=edge, plane=plane),
            n_iterations=cfg.inner_iterations,
            huber_delta=cfg.huber_delta,
        )
        corner_valid, plane_valid = cm.valid, plane_mask

    # world pose integration (laserOdometry.cpp:830-831)
    t_w = state.t_w + quat.quat_rotate(state.q_w, t)
    q_w = quat.quat_normalize(quat.quat_multiply(state.q_w, q))

    new_state = OdometryState(
        corner_last=feats.less_sharp,
        surf_last=feats.less_flat,
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
