"""The robot's path: one client, closed loop, ``Pipeline.process_frame``.

Set-up makes the lap (on the card), replays the mix's first sweeps through
a throwaway Pipeline so that the three stage graphs are captured, then
hands a fresh Pipeline to the window, which starts at sweep 0 and cycles
through the lap.  Inside the window there are only the program's calls,
one clock reading a sweep into a preallocated array, and at the few
boundaries the comparison takes, copies of the program's states into
buffers allocated before the window (``window.Plan``).

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
    from light_loam_tpu_torch.models.pipeline import Pipeline

    xyz, mask = traffic.host_laps(mix, cell["config"]["sensor"],
                                  cfg.scan.max_points, ctx["seed"], dev)
    xyz, mask = xyz[:, 0], mask[:, 0]
    lap_done = ctx["since_start"]()
    n_lap = xyz.shape[0]
    faults = ctx["faults"]

    warm = Pipeline(cfg, device=str(dev))
    for k in range(mix["warmup_units"]):
        warm.process_frame(xyz[k], mask[k])
    del warm
    warm_end = ctx["since_start"]()
    pipe = Pipeline(cfg, device=str(dev))
    if "process_frame" in faults:
        pipe.process_frame = faults["process_frame"](pipe)
    plan = window.Plan(ctx, mix, pipe.odo_state, pipe.map_state,
                       profiled=ctx["trace"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    cap = int(ctx["seconds"] * mix["max_units_per_s"]) + 8
    times = np.zeros(cap)
    results = [None] * cap

    def odo(_):
        return pipe.odo_state

    def mapping(_):
        return pipe.map_state

    prof, kept = window.profiler(ctx, mix)
    setup_s = ctx["since_start"]()
    n = 0
    t_start = time.perf_counter()
    deadline = t_start + ctx["seconds"]
    while True:
        k = n % n_lap
        if prof is None:
            t0 = time.perf_counter()
            results[n] = pipe.process_frame(xyz[k], mask[k])
            t1 = time.perf_counter()
        else:
            with window.annotated():
                t0 = time.perf_counter()
                results[n] = pipe.process_frame(xyz[k], mask[k])
                t1 = time.perf_counter()
        times[n] = t1 - t0
        n += 1
        plan.starts(n, t1 - t_start, odo, mapping)
        if prof is not None:
            prof.step()
        plan.ends(n, odo, mapping)
        if t1 >= deadline or n == cap:
            break
    window_s = t1 - t_start
    if prof is not None:
        prof.stop()

    seen = {"setup_split": window.setup_split(ctx, lap_done, warm_end, setup_s),
            "frames": n, "window_s": window_s, "program": pipe,
            "attempted": n, "unit": "frame"}
    bad = sum(1 for r in results[:n]
              if not (np.isfinite(r.odom_t).all() and r.mapped
                      and np.isfinite(r.map_t).all()))
    seen["failed"] = bad + pipe.diverged_frames + pipe.dropped_mapping_frames
    seen["end_to_end"] = {
        "setup_s": setup_s,
        "frames_per_s": n / window_s,
        "frame_ms_p95": 1000.0 * runner.percentile95(times[:n]),
    }
    if ctx["trace"]:
        stats = pipe.timers.device_report() if dev.type == "cuda" else {}
        seen["stage_ms"] = {k: v.mean_ms for k, v in stats.items()}
        seen["trace"] = trace.summarize(kept.get("events", []))
        seen["stretch"] = window.stretch(times, mix, n)

    def sweep(k, _):
        return xyz[k % n_lap][mask[k % n_lap]].copy()

    def poses(k, _):
        r = results[k]
        return r.odom_q, r.odom_t, r.map_q, r.map_t
    seen["compare_runs"] = plan.compare_runs(sweep, poses)
    return seen
