"""Batched multi-sequence SLAM: B independent sequences per step.

Counterpart of ``light_loam_tpu/models/batch.py``.  Evaluating the engine
on many recorded sequences (KITTI 00-10) means running it once per
sequence; here B sequences advance together, one frame each per step, so
every kernel of the frame does B frames' work at about one frame's launch
count.  The per-lane body is the single-stream one (features → odometry →
mapping) under ``torch.vmap``; lanes never interact.  As in the JAX
package there is no divergence containment in the batched body.

The two hand-written kernels are custom operators whose vmap rules fold
the lane axis into one launch (ops/cuda_knn.py, ops/cuda_vote.py).  On CUDA
tensors a batched frame is one replay of a CUDA graph of all B lanes
(models/fused.py ``FrameGraph`` with ``lanes=B``), and a chunk of K frames
is K replays; on CPU tensors the vmapped body runs eagerly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from light_loam_tpu_torch.config import PipelineConfig
from light_loam_tpu_torch.models.fused import _clone, frame_graph, stack_lanes
from light_loam_tpu_torch.models.mapping import (
    MappingOutput,
    MappingState,
    mapping_step,
)
from light_loam_tpu_torch.models.odometry import (
    OdometryOutput,
    OdometryState,
    odometry_step,
)
from light_loam_tpu_torch.ops.features import extract_features


class BatchState(NamedTuple):
    odometry: OdometryState  # leaves have a leading lane axis
    mapping: MappingState


def init_batch_state(cfg: PipelineConfig, batch: int,
                     device="cuda") -> BatchState:
    odo = OdometryState.init(cfg.scan.max_less_sharp, cfg.scan.max_less_flat,
                             device)
    mp = MappingState.init(cfg.mapping, device)
    return BatchState(odometry=stack_lanes(odo, batch),
                      mapping=stack_lanes(mp, batch))


def _batched_body(
    state: BatchState,
    xyz: torch.Tensor,   # (B, max_points, 3)
    mask: torch.Tensor,  # (B, max_points)
    cfg: PipelineConfig,
) -> Tuple[BatchState, OdometryOutput, MappingOutput]:
    """One SLAM frame for B independent sequences (the body of both entry
    points and of their graphs)."""

    def one(odo_state, map_state, xyz, mask):
        feats = extract_features(xyz, mask, cfg.scan)
        # no host read: it could run neither under vmap nor in a graph
        odo_state, odo = odometry_step(
            odo_state, feats, cfg.odometry, cfg.scan.scan_period,
            read_live_count=False,
        )
        map_state, mout = mapping_step(
            map_state,
            odo_state.corner_last,
            odo_state.surf_last,
            odo.q_w,
            odo.t_w,
            cfg.mapping,
        )
        return odo_state, map_state, odo, mout

    odo_state, map_state, odo, mout = torch.vmap(one)(
        state.odometry, state.mapping, xyz, mask)
    return BatchState(odometry=odo_state, mapping=map_state), odo, mout


def batched_frame_step(state: BatchState, xyz: torch.Tensor,
                       mask: torch.Tensor, cfg: PipelineConfig):
    """One frame of each of B sequences: xyz (B, N, 3), mask (B, N) ->
    (state, odometry output, mapping output), each with a lane axis.  The
    state names the device; on a card the frames may come from the host
    and the step is one graph replay."""
    device = state.odometry.q_w.device
    if device.type != "cuda":
        return _batched_body(state, xyz, mask, cfg)
    graph = frame_graph(cfg, device, lanes=xyz.shape[0])
    odo_state, map_state, _ = graph.run(state.odometry, state.mapping,
                                        xyz[None], mask[None])
    odo, mout, _ = (_clone(part) for part in graph.last)
    return BatchState(odometry=odo_state, mapping=map_state), odo, mout


def batched_chunk_step(
    state: BatchState,
    xyz: torch.Tensor,   # (K, B, max_points, 3)
    mask: torch.Tensor,  # (K, B, max_points)
    cfg: PipelineConfig,
) -> Tuple[BatchState, Tuple[torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]]:
    """K frames × B sequences per call with no host read between frames:
    returns (state, (odom_q, odom_t, map_q, map_t)), each (K, B, …).  On a
    card that is K replays of the batched frame's graph."""
    device = state.odometry.q_w.device
    if device.type == "cuda":
        odo_state, map_state, rows = frame_graph(
            cfg, device, chunk=xyz.shape[0], lanes=xyz.shape[1]).run(
                state.odometry, state.mapping, xyz, mask)
        return (BatchState(odometry=odo_state, mapping=map_state),
                (rows.odom_q, rows.odom_t, rows.map_q, rows.map_t))
    rows = []
    for x, m in zip(xyz, mask):
        state, odo, mout = _batched_body(state, x, m, cfg)
        rows.append((odo.q_w, odo.t_w, mout.q_w, mout.t_w))
    return state, tuple(torch.stack(col) for col in zip(*rows))
