"""Batched lanes split over a group of processes, one device each.

Counterpart of ``light_loam_tpu/parallel/batch_sharded.py``.  Rank r of n
holds lanes [r·B/n, (r+1)·B/n) of the batched multi-sequence mode
(models/batch.py) on its own device and steps them with the same
``batched_frame_step`` / ``batched_chunk_step``: on a card one graph replay
per batched frame.  Lanes never interact, so the step runs no collective;
``gather_lanes`` assembles every lane's output for the caller, which is
what reading a global array does in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch

from light_loam_tpu_torch.config import PipelineConfig
from light_loam_tpu_torch.models.batch import (
    BatchState,
    batched_chunk_step,
    batched_frame_step,
    init_batch_state,
)
from light_loam_tpu_torch.parallel.sharded import ShardGroup, make_group

# a process group has no named axes: the map group and the lane group are
# built alike
make_data_group = make_group


def _check_lanes(batch: int, group: ShardGroup) -> None:
    if batch % group.size:
        raise ValueError(
            f"batch {batch} must divide evenly over {group.size} ranks")


def init_sharded_batch_state(cfg: PipelineConfig, batch: int,
                             group: ShardGroup) -> BatchState:
    """This rank's lanes of a fresh ``batch``-lane state, on its device."""
    _check_lanes(batch, group)
    return init_batch_state(cfg, batch // group.size, device=group.device)


def _local_lanes(x, group: ShardGroup, dim: int) -> torch.Tensor:
    x = torch.as_tensor(x)
    _check_lanes(x.shape[dim], group)
    lanes = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * lanes, lanes).to(group.device)


def put_frames(xyz, mask, group: ShardGroup
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's lanes of (B, P, 3) / (B, P) frames, on its device."""
    return _local_lanes(xyz, group, 0), _local_lanes(mask, group, 0)


def sharded_batched_frame_step(state: BatchState, xyz: torch.Tensor,
                               mask: torch.Tensor, cfg: PipelineConfig):
    """One frame of this rank's lanes: ``batched_frame_step`` itself."""
    return batched_frame_step(state, xyz, mask, cfg)


def put_chunk_frames(xyz, mask, group: ShardGroup
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's lanes of (K, B, P, 3) / (K, B, P) chunks (the lane axis
    is dim 1; the K frames stay whole), on its device."""
    return _local_lanes(xyz, group, 1), _local_lanes(mask, group, 1)


def sharded_batched_chunk_step(state: BatchState, xyz: torch.Tensor,
                               mask: torch.Tensor, cfg: PipelineConfig):
    """K frames of this rank's lanes: ``batched_chunk_step`` itself."""
    return batched_chunk_step(state, xyz, mask, cfg)


def gather_lanes(tree, group: ShardGroup, dim: int = 0):
    """Every rank's lanes of ``tree`` (a tensor or nested tuples of them,
    the lane axis at ``dim``) concatenated in rank order, on every rank."""
    if isinstance(tree, torch.Tensor):
        return group.all_gather(tree.movedim(dim, 0)).movedim(0, dim)
    return type(tree)(*(gather_lanes(x, group, dim) for x in tree))
