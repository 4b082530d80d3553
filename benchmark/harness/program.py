"""The system under test: the PyTorch port, reached only through here.

A configuration file names a preset of ``light_loam_tpu_torch.config`` and
writes out every size and option of it.  The run uses the preset, and only
if the preset still says what the file says: a program change that moves a
size or an option stops the cell instead of changing the yardstick.  The
reference reads its parameters from the file, never from the program.
"""

from __future__ import annotations

import dataclasses

from harness.manifest import BenchError


def pipeline_config(config: dict):
    """The preset the configuration names, checked key by key."""
    from light_loam_tpu_torch import config as llt_config

    cfg = getattr(llt_config, config["preset"], None)
    if cfg is None:
        raise BenchError(f"no preset {config['preset']!r} in the program")
    diffs = []
    for group in ("scan", "odometry", "mapping"):
        have = dataclasses.asdict(getattr(cfg, group))
        have_all = dict(have, max_less_flat=cfg.scan.max_less_flat) \
            if group == "scan" else have
        for key, want in config[group].items():
            if have_all.get(key, "<missing>") != want:
                diffs.append(f"{group}.{key}: file {want!r}, program "
                             f"{have_all.get(key, '<missing>')!r}")
    for key, want in config["pipeline"].items():
        if getattr(cfg, key, "<missing>") != want:
            diffs.append(f"pipeline.{key}: file {want!r}, program "
                         f"{getattr(cfg, key, '<missing>')!r}")
    if diffs:
        raise BenchError("the program's preset differs from "
                         f"configs/{config['name']}.json: " + "; ".join(diffs))
    return cfg
