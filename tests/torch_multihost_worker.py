"""One rank of the port's multi-process sharded-mapping test, started as
its own ``python`` process with a launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), as ``torchrun`` would start it:

    RANK=0 WORLD_SIZE=2 ... python tests/torch_multihost_worker.py

The inputs and the two steps are tests/multihost_worker.py's: every process
builds the same host data, places its part with ``place_state_global`` /
``place_cloud_global`` and runs two sharded mapping steps on the CPU over
gloo; rank 0 prints the (replicated) results as one ``RESULT`` JSON line.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from light_loam_tpu_torch.config import MappingConfig  # noqa: E402
from light_loam_tpu_torch.core.frame import PointCloud  # noqa: E402
from light_loam_tpu_torch.models.mapping import MappingState  # noqa: E402
from light_loam_tpu_torch.parallel.multihost import (  # noqa: E402
    global_group,
    init_from_env,
    place_cloud_global,
    place_state_global,
)
from light_loam_tpu_torch.parallel.sharded import (  # noqa: E402
    sharded_mapping_step,
)
from light_loam_tpu_torch.utils.synthetic import World, simulate_scan  # noqa: E402


def cloud(world, n_pts, cap, seed):
    rng = np.random.default_rng(seed)
    pts = simulate_scan(world, np.zeros(3), n_rings=16, lower_deg=-15.0,
                        upper_deg=15.0, n_azimuth=400, noise=0.01, seed=seed)
    idx = rng.permutation(len(pts))[:n_pts]
    xyz = np.zeros((cap, 3), np.float32)
    m = np.zeros(cap, bool)
    xyz[: len(idx)] = pts[idx]
    m[: len(idx)] = True
    return PointCloud(xyz=xyz, rel=np.zeros(cap, np.float32), mask=m)


def main():
    torch.set_num_threads(1)
    init_from_env("gloo", device="cpu")
    try:
        group = global_group(device="cpu")
        n = group.size
        cfg = MappingConfig(
            map_corner_capacity=512 * n,
            map_surf_capacity=1024 * n,
            local_corner_capacity=512 * n,
            local_surf_capacity=1024 * n,
            stack_corner_capacity=256 * n,
            stack_surf_capacity=512 * n,
            knn_tile=256,
            knn_sq_gate=4.0,
        )
        world = World.urban(seed=6, n_boxes=6, n_poles=4)
        corner = place_cloud_global(cloud(world, 800, 1024, 11), group)
        surf = place_cloud_global(cloud(world, 1800, 2048, 12), group)
        state = place_state_global(MappingState.init(cfg, "cpu"), group, cfg)
        q0 = torch.tensor([0, 0, 0, 1], dtype=torch.float32)
        state, _ = sharded_mapping_step(state, corner, surf, q0,
                                        torch.zeros(3), cfg, group)
        t1 = torch.tensor([0.3, 0.05, 0.0])
        state, out = sharded_mapping_step(state, corner, surf, q0, t1, cfg,
                                          group)
        poses = group.all_gather(torch.cat([out.q_w, out.t_w])[None])
        result = {
            "world_size": n,
            "q_w": out.q_w.tolist(),
            "t_w": out.t_w.tolist(),
            "ranks_equal": bool((poses == poses[0]).all()),
            "corner_factors": int(out.corner_factors),
            "surf_factors": int(out.surf_factors),
            "map_surf_points": int(out.map_surf_points),
        }
        if group.rank == 0:
            print("RESULT " + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
