"""The odometry front end: one client, closed loop, each sweep through the
program's captured feature and odometry stages (``stages.run_features``,
``stages.run_odometry``: Light-LOAM's scanRegistration and laserOdometry
nodes), its pose read back to the host as the node publishes it.  No
mapping step runs.

Set-up makes the lap (on the card) and replays the mix's first sweeps from
a throwaway state so that both stage graphs are captured; the window then
starts from the empty odometry state at sweep 0 and cycles through the
lap.  Inside the window there are only the program's calls, one clock
reading a sweep into a preallocated array, and at the few boundaries the
comparison takes, copies of the program's odometry state into buffers
allocated before the window (``window.Plan``).  The program's own stage
spans (``utils/timing.py`` StageTimers, CUDA events round each replay)
time the two stages.

With ``--trace 1`` each sweep runs inside the ``bench.unit`` annotation and
the profiler records the mix's ``profile.units`` sweeps after the first
``profile.skip``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import runner, trace, traffic, window


def run(ctx: dict) -> dict:
    cell, cfg, dev = ctx["cell"], ctx["cfg"], ctx["device"]
    mix = cell["mix"]
    from light_loam_tpu_torch.models import stages
    from light_loam_tpu_torch.models.odometry import OdometryState
    from light_loam_tpu_torch.utils.timing import StageTimers

    xyz, mask = traffic.host_laps(mix, cell["config"]["sensor"],
                                  cfg.scan.max_points, ctx["seed"], dev)
    xyz, mask = xyz[:, 0], mask[:, 0]
    lap_done = ctx["since_start"]()
    n_lap = xyz.shape[0]

    def fresh():
        return OdometryState.init(cfg.scan.max_less_sharp,
                                  cfg.scan.max_less_flat, dev)

    def sweep_step(state, xyz_k, mask_k, timers):
        with timers.stage("features"):
            feats = stages.run_features(xyz_k, mask_k, cfg, dev)
        with timers.stage("odometry"):
            state, odo = stages.run_odometry(state, feats, cfg)
        return state, odo.q_w.cpu().numpy(), odo.t_w.cpu().numpy()
    step = ctx["faults"].get("sweep_step", lambda f: f)(sweep_step)

    warm = fresh()
    for k in range(mix["warmup_units"]):
        warm, _, _ = step(warm, xyz[k], mask[k], StageTimers())
    del warm
    warm_end = ctx["since_start"]()
    state = fresh()
    timers = StageTimers(device=dev.type == "cuda")
    plan = window.Plan(ctx, mix, state, None, profiled=ctx["trace"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    cap = int(ctx["seconds"] * mix["max_units_per_s"]) + 8
    times = np.zeros(cap)
    poses = np.zeros((cap, 7), np.float32)

    def odo(_):
        return state

    prof, kept = window.profiler(ctx, mix)
    setup_s = ctx["since_start"]()
    n = 0
    t_start = time.perf_counter()
    deadline = t_start + ctx["seconds"]
    while True:
        k = n % n_lap
        if prof is None:
            t0 = time.perf_counter()
            state, q, t = step(state, xyz[k], mask[k], timers)
            t1 = time.perf_counter()
        else:
            with window.annotated():
                t0 = time.perf_counter()
                state, q, t = step(state, xyz[k], mask[k], timers)
                t1 = time.perf_counter()
        poses[n, :4], poses[n, 4:] = q, t
        times[n] = t1 - t0
        n += 1
        plan.starts(n, t1 - t_start, odo, None)
        if prof is not None:
            prof.step()
        plan.ends(n, odo, None)
        if t1 >= deadline or n == cap:
            break
    window_s = t1 - t_start
    if prof is not None:
        prof.stop()

    seen = {"setup_split": window.setup_split(ctx, lap_done, warm_end, setup_s),
            "frames": n, "window_s": window_s, "program": state,
            "attempted": n, "unit": "frame"}
    seen["failed"] = int((~np.isfinite(poses[:n]).all(-1)).sum())
    seen["end_to_end"] = {
        "setup_s": setup_s,
        "frames_per_s": n / window_s,
        "frame_ms_p95": 1000.0 * runner.percentile95(times[:n]),
    }
    if ctx["trace"]:
        stats = timers.device_report() if dev.type == "cuda" else {}
        seen["stage_ms"] = {k: v.mean_ms for k, v in stats.items()}
        seen["trace"] = trace.summarize(kept.get("events", []))
        seen["stretch"] = window.stretch(times, mix, n)

    def sweep(k, _):
        return xyz[k % n_lap][mask[k % n_lap]].copy()

    def pose(k, _):
        return poses[k, :4], poses[k, 4:], None, None
    seen["compare_runs"] = plan.compare_runs(sweep, pose)
    return seen
