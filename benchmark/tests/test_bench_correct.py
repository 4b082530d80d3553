"""The comparison that decides ``correct`` fails what it must.

* The control, the plain reference computed in TF32 put in the program's
  place, comes out not correct: here at a small size (TF32 rounding
  emulated on the CPU), and on the card at each cell's own size.
* A sound run of the program comes out correct at that small size.
* A run of the harness over the program with the timed path broken comes
  out not correct, once for each fault a cell can have: a step that
  returns its state unchanged, half of the batch left out (half of a
  sweep's points; half of the lanes), and an answer altered where it is
  produced (a pose moved by 5 cm): for the benchmark's odometry cell, and
  for the full frame's drivers (live, lanes) that no cell runs now.  These
  run on the CPU at a small size (``tiny.py``).
"""

import numpy as np
import pytest
import torch

import tiny
from harness import manifest, runner

SEED = 2**31 + 77


def _unchanged(pipe):
    """The frame step leaves the state as it was and answers from it."""
    orig = pipe.process_frame
    last = {}

    def step(xyz, mask):
        if "r" not in last:
            last["r"] = orig(xyz, mask)
        return last["r"]
    return step


def _half_points(pipe):
    """Half of the sweep left out: its second half of the turn."""
    orig = pipe.process_frame

    def step(xyz, mask):
        m = mask.copy()
        m[int(m.sum()) // 2:] = False
        return orig(xyz, m)
    return step


def _altered(pipe):
    orig = pipe.process_frame

    def step(xyz, mask):
        r = orig(xyz, mask)
        r.map_t = r.map_t + np.float32(0.05)
        return r
    return step


def _lanes_half(step):
    def f(state, xyz, mask, cfg):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = False
        return step(state, xyz, mask, cfg)
    return f


def _lanes_altered(step):
    def f(state, xyz, mask, cfg):
        state, odo, mout = step(state, xyz, mask, cfg)
        return state, odo, mout._replace(t_w=mout.t_w + 0.05)
    return f


def _lanes_unchanged(step):
    def f(state, xyz, mask, cfg):
        new, odo, mout = step(state, xyz, mask, cfg)
        return state, odo, mout
    return f


LIVE = {"unchanged": _unchanged, "half": _half_points, "altered": _altered}
LANES = {"unchanged": _lanes_unchanged, "half": _lanes_half,
         "altered": _lanes_altered}


def _odometry_unchanged(step):
    """The sweep step leaves the state as it was and answers from it."""
    last = {}

    def f(state, xyz, mask, timers):
        if "r" not in last:
            last["r"] = step(state, xyz, mask, timers)
        return (state, *last["r"][1:])
    return f


def _odometry_half(step):
    """Half of the sweep left out: its second half of the turn."""
    def f(state, xyz, mask, timers):
        m = mask.copy()
        m[int(m.sum()) // 2:] = False
        return step(state, xyz, m, timers)
    return f


def _odometry_altered(step):
    def f(state, xyz, mask, timers):
        state, q, t = step(state, xyz, mask, timers)
        return state, q, t + np.float32(0.05)
    return f


ODOMETRY = {"unchanged": _odometry_unchanged, "half": _odometry_half,
            "altered": _odometry_altered}


def _run(cell, faults, seconds, control=False):
    torch.set_num_threads(4)
    return runner.run(cell, SEED, seconds, False, "cpu", faults=faults,
                      control=control)


CELLS = {"odometry": (tiny.small_cell, 30.0), "live": (tiny.office_cell, 30.0),
         "lanes": (lambda: tiny.office_cell(lanes=2), 45.0)}


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_control_is_not_correct(kind):
    make, seconds = CELLS[kind]
    r = _run(make(), {}, seconds, control=True)
    assert r["info"]["runs_compared"]
    assert r["correct"] is False, r["compared"]
    # every number the cell compares reads over its limit
    assert all(c["value"] > c["limit"] for c in r["compared"].values())


@pytest.mark.parametrize("fault", sorted(LIVE))
def test_live_faults_are_not_correct(fault):
    r = _run(tiny.office_cell(), {"process_frame": LIVE[fault]}, 30.0)
    assert r["correct"] is False, r["compared"]


@pytest.mark.parametrize("fault", sorted(LANES))
def test_lanes_faults_are_not_correct(fault):
    from light_loam_tpu_torch.models.batch import batched_frame_step

    r = _run(tiny.office_cell(lanes=2),
             {"step": LANES[fault](batched_frame_step)}, 45.0)
    assert r["attempted"] >= 4
    assert r["correct"] is False, r["compared"]


@pytest.mark.parametrize("fault", sorted(ODOMETRY))
def test_odometry_faults_are_not_correct(fault):
    r = _run(tiny.small_cell(), {"sweep_step": ODOMETRY[fault]}, 30.0)
    assert r["correct"] is False, r["compared"]


@pytest.mark.parametrize("kind", ["odometry", "live"])
def test_sound_run_is_correct(kind):
    make, seconds = CELLS[kind]
    r = _run(make(), {}, seconds)
    assert r["correct"] is True, r["compared"]
    assert r["failed"] == 0
    assert len(r["info"]["runs_compared"]) == 2


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(card):
    """The control at each cell's own size, three seeds."""
    for w in manifest.manifest()["workloads"]:
        cell = manifest.cell(manifest.manifest(), w["name"])
        for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
            r = runner.run(cell, seed, 10.0, False, card, control=True)
            assert r["correct"] is False, (w["name"], r["compared"])


@pytest.mark.cuda
def test_run_on_the_card(card):
    """The benchmark's own command, one short run of each cell."""
    import json
    import subprocess
    import sys

    for w in manifest.manifest()["workloads"]:
        out = subprocess.run(
            [sys.executable, str(manifest.BENCH / "run.py"), "--workload",
             w["name"], "--seed", "5", "--seconds", "3", "--trace", "0"],
            capture_output=True, text=True, cwd=manifest.ROOT, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
