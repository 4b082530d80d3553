"""Cells at a size the CPU runs in seconds a sweep, for the tests.

* ``small_cell()``: the benchmark's odometry cell on the HDL64_SMALL preset
  (64 rings, the reference's 3 x 4 odometry schedule, small stores), sweeps
  of 400 azimuth steps, under the cell's own limits.
* ``office_cell(lanes)``: the drivers no cell of ``BENCHMARK.json`` runs
  now (the full frame, live or as batched lanes), on the office mix at 600
  azimuth steps of a VLP-16, where the map stays within a few metres of its
  origin and the program's plane fit holds at this size (PERF.md), under
  limits for these tests alone.
"""

from __future__ import annotations

import copy
import dataclasses
import json

from harness import manifest

WORKLOAD = "hdl64_kitti.ring.odometry"
# the office cell's limits at this size: sound runs read <= 0.3 mm and 0 %,
# the control >= 9 mm and >= 3 % (PERF.md)
OFFICE_LIMITS = {"odom_gap_mm": 3.0, "map_gap_mm": 4.0, "store_mismatch_pct": 2.0}


def _shrink(cell: dict, runs: int, frames_per_run: int) -> dict:
    mix = copy.deepcopy(cell["mix"])
    mix["warmup_units"] = 1
    mix["profile"] = {"skip": 1, "units": 1}
    mix["compare"] = dict(mix["compare"], runs=runs, units=frames_per_run,
                          start_units=frames_per_run, spread=[0.0, 0.0])
    mix["route"] = dict(mix["route"], frames=10)
    cell["mix"] = mix
    return cell


def small_config() -> dict:
    from light_loam_tpu_torch.config import HDL64_SMALL

    base = json.loads((manifest.BENCH / "configs" / "hdl64_kitti.json").read_text())
    cfg = HDL64_SMALL
    for group in ("scan", "odometry", "mapping"):
        base[group] = dataclasses.asdict(getattr(cfg, group))
    base["scan"]["max_less_flat"] = cfg.scan.max_less_flat
    base["preset"] = "HDL64_SMALL"
    base["sensor"] = dict(base["sensor"], n_azimuth=400)
    return base


def small_cell(frames_per_run: int = 2) -> dict:
    cell = manifest.cell(manifest.manifest(), WORKLOAD)
    cell["config"] = small_config()
    return _shrink(cell, 2, frames_per_run)


def office_cell(lanes: int = 0, frames_per_run: int = 2) -> dict:
    config = manifest.load_json(manifest.BENCH / "configs" / "vlp16.json")
    config["sensor"] = dict(config["sensor"], n_azimuth=600)
    mix = manifest.load_json(manifest.BENCH / "traffic" / "office.live.json")
    if lanes:
        mix = dict(mix, driver="lanes", lanes=lanes)
    cell = {"workload": {"name": "vlp16.office.test", "chips": 1},
            "config": config, "mix": mix,
            "limits": {"limits": dict(OFFICE_LIMITS)},
            "end_to_end": [], "per_layer": []}
    return _shrink(cell, 1 if lanes else 2, frames_per_run)
