"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names the cells (workloads), the
configurations and the metrics.  Everything else belongs to one of them
and lives in a file of its own under ``benchmark/``, found by that name:

* ``configs/<config>.json``: the configuration (its program preset, its
  sensor and every size, checked against the preset it names);
* ``traffic/<mix>.json``: a traffic mix's parameters and the driver that
  runs it (``harness/drivers/<driver>.py``);
* ``cells/<workload>.json``: the limits of the comparison that decides
  ``correct`` in that cell;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

A new cell, mix, configuration or metric is new files and new entries in
``BENCHMARK.json``, never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class BenchError(Exception):
    """A cell that cannot be resolved or run as its files say."""


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise BenchError(f"missing file {path.relative_to(ROOT)}") from e


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def check_names(m: dict) -> list:
    """Every name, config, traffic, reduced key and unit that breaks the
    manifest's character rules, as messages."""
    bad = []
    for c in m.get("configs", []):
        names = [c.get("name", "")] + list(c.get("reduced", []))
        bad += [f"config name {n!r}" for n in names if not NAME_RE.match(n)]
    for w in m.get("workloads", []):
        for key in ("name", "config", "traffic"):
            if not NAME_RE.match(str(w.get(key, ""))):
                bad.append(f"workload {key} {w.get(key)!r}")
    for group in ("end_to_end", "per_layer"):
        for metric in m.get(group, []):
            if not NAME_RE.match(metric.get("name", "")):
                bad.append(f"metric name {metric.get('name')!r}")
            if not UNIT_RE.match(metric.get("unit", "")):
                bad.append(f"unit {metric.get('unit')!r}")
    return bad


def cell(m: dict, workload: str, bench: Path = BENCH) -> dict:
    """The resolved cell: its workload entry, config file, mix, limits and
    the metrics it reports with ``--trace`` 0 and 1."""
    ws = {w["name"]: w for w in m["workloads"]}
    if workload not in ws:
        raise BenchError(f"unknown workload {workload!r}; "
                         f"known: {sorted(ws)}")
    w = ws[workload]
    confs = {c["name"]: c for c in m["configs"]}
    if w["config"] not in confs:
        raise BenchError(f"workload {workload} names unknown config "
                         f"{w['config']!r}")
    conf_entry = confs[w["config"]]
    config = load_json(bench.parent / conf_entry["file"])
    mix = load_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench / "cells" / f"{workload}.json")

    def reported(group):
        return [x for x in m[group]
                if workload in x.get("workloads", [workload])]

    return {"workload": w, "config": config, "mix": mix, "limits": limits,
            "end_to_end": reported("end_to_end"),
            "per_layer": reported("per_layer")}


def load_module(path: Path, name: str):
    """Import a file by its path (metric readers and drivers have dots or
    dashes in their names)."""
    if not path.is_file():
        raise BenchError(f"missing file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(mix: dict, bench: Path = BENCH):
    return load_module(bench / "harness" / "drivers" / f"{mix['driver']}.py",
                       f"bench_driver_{mix['driver']}")


def reader(metric: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{metric}.py",
                       f"bench_metric_{metric.replace('.', '_')}")
