from light_loam_tpu_torch.parallel.sharded import (
    make_group,
    shard_mapping_state,
    sharded_mapping_step,
)

__all__ = ["make_group", "shard_mapping_state", "sharded_mapping_step"]
