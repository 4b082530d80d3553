"""BENCHMARK.json's names and units, and a cell, mix, configuration and
metric found by name from files dropped in, with no file edited."""

import json
import shutil

import pytest

from harness import manifest


def test_manifest_names_and_units():
    m = manifest.manifest()
    assert manifest.check_names(m) == []
    names = [w["name"] for w in m["workloads"]]
    assert len(set(names)) == len(names)
    e2e = {x["name"] for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e
        moved = next(x for x in m["end_to_end"] if x["name"] == metric["moves"])
        for w in metric["workloads"]:
            assert w in moved.get("workloads", names)
    for w in m["workloads"]:
        c = manifest.cell(m, w["name"])
        assert {x["name"] for x in c["end_to_end"]} >= {"setup_s"}
        assert len(c["end_to_end"]) >= 2 and c["per_layer"]
        for metric in c["per_layer"]:
            manifest.reader(metric["name"])


def test_bad_names_are_found():
    m = {"configs": [{"name": "a b", "reduced": ["x/y"]}],
         "workloads": [{"name": "ok", "config": "a b", "traffic": "t"}],
         "end_to_end": [{"name": "m", "unit": "tokens per second"}],
         "per_layer": [{"name": "µs", "unit": "us"}]}
    assert len(manifest.check_names(m)) == 5


def test_config_files_match_the_program_presets():
    from harness import program

    for c in manifest.manifest()["configs"]:
        program.pipeline_config(manifest.load_json(manifest.ROOT / c["file"]))


def test_a_changed_preset_stops_the_cell():
    from harness import program

    c = manifest.load_json(manifest.BENCH / "configs" / "vlp16.json")
    c["mapping"] = dict(c["mapping"], plane_resolution=0.5)
    with pytest.raises(manifest.BenchError):
        program.pipeline_config(c)


def test_dropped_in_files_are_found(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest.manifest()
    # a new configuration, mix, cell and metric: new files and entries only
    conf = json.loads((bench / "configs" / "vlp16.json").read_text())
    conf["name"] = "vlp16_b"
    (bench / "configs" / "vlp16_b.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "ring.live.json").read_text())
    mix["route"]["step_m"] = 2.0
    (bench / "traffic" / "ring.fast.json").write_text(json.dumps(mix))
    (bench / "cells" / "vlp16_b.ring.fast.json").write_text(
        json.dumps({"limits": {"odom_gap_mm": 1.0, "map_gap_mm": 1.0}}))
    (bench / "metrics" / "lap_m.py").write_text(
        "def read(seen):\n    return 157.0\n")
    m["configs"].append({"name": "vlp16_b", "source": "x",
                         "file": "benchmark/configs/vlp16_b.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "vlp16_b.ring.fast", "config": "vlp16_b",
                           "traffic": "ring.fast", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "lap_m", "unit": "m", "better": "lower",
                           "source": "program_counter", "layer": "x",
                           "moves": "frames_per_s",
                           "workloads": ["vlp16_b.ring.fast"]})
    m["end_to_end"][1]["workloads"].append("vlp16_b.ring.fast")
    c = manifest.cell(m, "vlp16_b.ring.fast", bench=bench)
    assert c["config"]["name"] == "vlp16_b"
    assert c["mix"]["route"]["step_m"] == 2.0
    assert c["limits"]["limits"]["odom_gap_mm"] == 1.0
    assert [x["name"] for x in c["per_layer"]] == ["lap_m"]
    assert manifest.reader("lap_m", bench=bench).read({}) == 157.0
    assert manifest.driver(c["mix"], bench=bench).run


def test_unknown_workload():
    with pytest.raises(manifest.BenchError):
        manifest.cell(manifest.manifest(), "nope")


def _run_py(cwd, *args):
    import subprocess
    import sys

    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


ARGS = ("--workload", manifest.manifest()["workloads"][0]["name"], "--seed",
        "5", "--seconds", "1", "--trace", "0")


def test_run_exits_without_the_program(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path, *ARGS)
    assert out.returncode != 0 and out.stdout == ""


def test_run_exits_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(manifest.ROOT, *ARGS)
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr.lower()
