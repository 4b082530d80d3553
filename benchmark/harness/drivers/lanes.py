"""The offline evaluator: B independent sequences as batched lanes.

Lane b drives its own ring road (its world from ``--seed`` and b) at the
mix's speed; each step is one ``batched_frame_step`` of all B lanes (on a
card one replay of the lanes' CUDA graph), and its B odometry and B mapped
poses are read back to the host in one copy, as an evaluator writes them
out.  Set-up makes the B laps on the card, steps a throwaway batch state
through the mix's first frames to capture the graph, then hands a fresh
state to the window.  The comparison's runs (``window.Plan``) are every
lane's first steps and runs in lanes drawn from the seed.

With ``--trace 1`` CUDA events around every step give ``batched_step_ms``,
and the profiler records ``profile.units`` steps after ``profile.skip``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import compare, trace, traffic, window


def run(ctx: dict) -> dict:
    cell, cfg, dev = ctx["cell"], ctx["cfg"], ctx["device"]
    mix = cell["mix"]
    from light_loam_tpu_torch.models.batch import batched_frame_step, init_batch_state

    xyz, mask = traffic.host_laps(mix, cell["config"]["sensor"],
                                  cfg.scan.max_points, ctx["seed"], dev)
    n_lap, lanes = xyz.shape[0], xyz.shape[1]
    lap_done = ctx["since_start"]()
    step = ctx["faults"].get("step", batched_frame_step)

    def frames(k):
        return torch.from_numpy(xyz[k]), torch.from_numpy(mask[k])

    warm = init_batch_state(cfg, lanes, str(dev))
    for k in range(mix["warmup_units"]):
        warm, _, _ = step(warm, *frames(k), cfg)
    del warm
    warm_end = ctx["since_start"]()
    state = init_batch_state(cfg, lanes, str(dev))
    plan = window.Plan(ctx, mix, compare.lane(state.odometry, 0),
                       compare.lane(state.mapping, 0), lanes=lanes)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    cap = int(ctx["seconds"] * mix["max_units_per_s"]) + 8
    poses = np.zeros((cap, lanes, 14), np.float32)
    events = []

    def odo(b):
        return compare.lane(state.odometry, b)

    def mapping(b):
        return compare.lane(state.mapping, b)

    prof, kept = window.profiler(ctx, mix)
    setup_s = ctx["since_start"]()
    n = 0
    t_start = time.perf_counter()
    deadline = t_start + ctx["seconds"]
    while True:
        k = n % n_lap
        if prof is None:
            state, odo_out, mout = step(state, *frames(k), cfg)
            poses[n] = torch.cat([odo_out.q_w, odo_out.t_w, mout.q_w,
                                  mout.t_w], dim=1).cpu().numpy()
        else:
            with window.annotated():
                if dev.type == "cuda":
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                state, odo_out, mout = step(state, *frames(k), cfg)
                if dev.type == "cuda":
                    ev[1].record()
                    events.append(ev)
                poses[n] = torch.cat([odo_out.q_w, odo_out.t_w, mout.q_w,
                                      mout.t_w], dim=1).cpu().numpy()
        n += 1
        t1 = time.perf_counter()
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
            "frames": n * lanes, "window_s": window_s, "program": state,
            "attempted": n * lanes, "unit": "step"}
    seen["failed"] = int((~np.isfinite(poses[:n]).all(-1)).sum())
    seen["end_to_end"] = {"setup_s": setup_s,
                          "lane_frames_per_s": n * lanes / window_s}
    if ctx["trace"]:
        seen["step_ms"] = [a.elapsed_time(b) for a, b in events]
        seen["trace"] = trace.summarize(kept.get("events", []))

    def sweep(k, b):
        return xyz[k % n_lap, b][mask[k % n_lap, b]].copy()

    def pose(k, b):
        p = poses[k, b]
        return p[0:4], p[4:7], p[7:11], p[11:14]
    seen["compare_runs"] = plan.compare_runs(sweep, pose)
    return seen
