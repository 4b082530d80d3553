"""Ranks started by a launcher, on one host or several.

Counterpart of ``light_loam_tpu/parallel/multihost.py``.  In PyTorch ranks
on several hosts run the same program as ranks on one host; what this
module adds is joining the group from the launcher's environment and
building each rank's part from host data that every process holds
identically, as the JAX module assembles global arrays.

    torchrun --nproc-per-node N program.py

sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` for every rank it starts.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from light_loam_tpu_torch.config import MappingConfig
from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.models.mapping import MappingState
from light_loam_tpu_torch.parallel.sharded import (
    ShardGroup,
    make_group,
    shard_mapping_state,
)


def _device(device):
    if device is None:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device(device)


def init_from_env(backend: str, device=None) -> ShardGroup:
    """Join the group that the launcher's environment describes; this
    rank's device is ``cuda:LOCAL_RANK`` unless ``device`` names another
    (``"cpu"``)."""
    world = int(os.environ["WORLD_SIZE"])
    return make_group(
        world, int(os.environ["RANK"]), backend, "env://",
        device=_device(device),
        local_world_size=int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def global_group(device=None) -> ShardGroup:
    """This rank's ``ShardGroup`` over every rank of the joined group."""
    return ShardGroup(dist.get_rank(), dist.get_world_size(), _device(device))


def place_state_global(state: MappingState, group: ShardGroup,
                       cfg: MappingConfig) -> MappingState:
    """This rank's part of a mapping state that every process holds whole:
    the voxel-hash redistribution (the same on every rank), then the rank's
    slice (``sharded.shard_mapping_state``)."""
    return shard_mapping_state(state, group, cfg)


def place_cloud_global(pc: PointCloud, group: ShardGroup) -> PointCloud:
    """A cloud every process holds whole, on this rank's device."""
    return PointCloud(*(torch.as_tensor(x).to(group.device) for x in pc))
