"""Mapped positions of the JAX package's staged pipeline on the CPU: the
references ``chip_smoke.py`` phases 17 and 18 hold the port's captured
stages to (``JAX_SKIP2_MAPPED_POSITIONS``, ``JAX_VLP16_MAPPED_POSITIONS``).

    JAX_PLATFORMS=cpu python scripts/jax_staged_positions.py [--case skip2|vlp16]

Runs ``run_synthetic`` (1800 azimuth steps, 1 m/frame, seed 0: the smoke
run's frames) with its default staged path:

  * ``skip2``: the flagship profile (HDL64_KITTI) over 12 frames with
    ``skip_frame_num=2``, so frames 0, 2, ..., 10 map;
  * ``vlp16``: the VLP16 profile at full width (16 rings, h_max 2304,
    65536-point frames) over 8 frames.

Prints one JSON object: case -> the mapped positions (rows, 3).  ~2 min and
~1 GB on the CPU for both.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from light_loam_tpu.models import pipeline as pl  # noqa: E402

CASES = {"skip2": ("hdl64", 12), "vlp16": ("vlp16", 8)}


def positions(case: str) -> list:
    profile, n_frames = CASES[case]
    cfg = pl.PROFILES[profile]
    if case == "skip2":
        pl.PROFILES[profile] = dataclasses.replace(
            cfg, odometry=dataclasses.replace(cfg.odometry, skip_frame_num=2))
    try:
        pipe, _, _ = pl.run_synthetic(n_frames=n_frames, profile=profile,
                                      n_azimuth=1800, speed=1.0, seed=0)
    finally:
        pl.PROFILES[profile] = cfg
    return pipe.mapped_positions().tolist()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=sorted(CASES), action="append")
    cases = ap.parse_args().case or sorted(CASES)
    print(json.dumps({case: positions(case) for case in cases}))


if __name__ == "__main__":
    main()
