"""Mapped positions of the JAX package's sharded mapping step on the flagship
run, on the CPU: the reference ``chip_smoke.py`` phase 15 holds the port's
sharded runs to (``JAX_SHARDED_POSITIONS``).

    JAX_PLATFORMS=cpu python scripts/jax_sharded_positions.py [--frames 12]

The JAX pipeline runs the flagship frames of ``run_synthetic`` (HDL64_KITTI,
1800 azimuth steps, 1 m/frame, seed 0) once, and its mapping inputs
(the odometry's corner and surf clouds and pose of every frame) are recorded.
Then ``sharded_mapping_step`` maps those inputs from an empty map on a mesh
of n virtual CPU devices, for each n.  Prints one JSON object: n -> the
mapped positions (frames, 3).
"""

from __future__ import annotations

import argparse
import json
import os

DEVICES = (1, 2, 4)

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={max(DEVICES)}").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from light_loam_tpu.models import pipeline as pl  # noqa: E402
from light_loam_tpu.models.mapping import MappingState  # noqa: E402
from light_loam_tpu.parallel import (  # noqa: E402
    make_mesh,
    shard_mapping_state,
    sharded_mapping_step,
)


def mapping_inputs(n_frames: int):
    """The JAX pipeline's (corner_last, surf_last, q_odom, t_odom) of every
    mapped frame of the flagship run."""
    recorded = []
    real = pl.mapping_step

    def record(state, corner_last, surf_last, q_odom, t_odom, cfg):
        recorded.append((corner_last, surf_last, q_odom, t_odom))
        return real(state, corner_last, surf_last, q_odom, t_odom, cfg)

    pl.mapping_step = record
    try:
        pipe, _, _ = pl.run_synthetic(n_frames=n_frames, profile="hdl64",
                                      n_azimuth=1800, speed=1.0, seed=0)
    finally:
        pl.mapping_step = real
    return recorded, pipe.mapped_positions()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()
    cfg = pl.PROFILES["hdl64"].mapping
    inputs, single = mapping_inputs(args.frames)
    out = {"single": single.tolist()}
    for n in DEVICES:
        mesh = make_mesh(n)
        state = shard_mapping_state(MappingState.init(cfg), mesh, cfg)
        rows = []
        for corner, surf, q, t in inputs:
            state, res = sharded_mapping_step(state, corner, surf, q, t, cfg,
                                              mesh)
            rows.append(np.asarray(res.t_w).tolist())
        out[n] = rows
    print(json.dumps(out))


if __name__ == "__main__":
    main()
