"""What the program's spans cost on the benchmark's odometry front end, and
where the card's idle gaps fall among them.

    python scripts/span_cost.py [--turns 3] [--seconds 20] [--sweeps 6] [--out DIR]

Needs one CUDA card; imports nothing of JAX.  Makes the lap of the
``hdl64_kitti.ring.odometry`` cell (benchmark/harness: its configuration,
its traffic mix, seed ``--seed``) and warms both stage graphs up, then:

  * in turns (ABBA: timers, none, none, timers, ...), the cell's loop
    (features, odometry, the pose read to the host) for ``--seconds`` each,
    with ``StageTimers(device=True)`` open round each stage as the cell's
    driver (benchmark/harness/drivers/odometry.py) has them ("timers":
    every span inside the stages records) and with no timers open ("none":
    the spans look up and do nothing).  Prints sweeps a
    second and the median sweep of each turn, the medians of each side and
    the cost of the spans as a share of the median sweep, beside the host
    µs a sweep's spans take when timed alone (``host_cost_us``); and, from the
    timers' turns, each span's mean device and host ms a sweep (the host ms
    of ``<stage>.launch`` is that of the ``replay()`` call) and the idle share
    from the program's events (``event_idle_pct``, the benchmark's
    ``idle_pct.events``);
  * one profiled slice of ``--sweeps`` sweeps with the timers open: the 10
    longest gaps in which the card ran nothing, each with the innermost
    program span (a stage or a span: the profiler ranges of the same names)
    whose host interval holds the gap's middle and the smallest host event
    that does, and the profiler's idle share of the slice beside the
    events' share of the same sweeps.

With ``--out`` it writes ``span_cost.json`` there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

from harness import manifest, program, traffic  # noqa: E402
from light_loam_tpu_torch.models import stages  # noqa: E402
from light_loam_tpu_torch.models.odometry import OdometryState  # noqa: E402
from light_loam_tpu_torch.utils.timing import (  # noqa: E402
    StageTimers,
    event_idle_pct,
    span,
)

CELL = "hdl64_kitti.ring.odometry"
STAGES = ("features", "odometry")
SWEEP = "span_cost.sweep"


def sweep(cfg, dev, state, xyz, mask, timers):
    """A sweep as benchmark/harness/drivers/odometry.py runs it: both
    stages, under ``timers`` when given, and the pose read back."""
    if timers is None:
        feats = stages.run_features(xyz, mask, cfg, dev)
        state, odo = stages.run_odometry(state, feats, cfg)
    else:
        with timers.stage("features"):
            feats = stages.run_features(xyz, mask, cfg, dev)
        with timers.stage("odometry"):
            state, odo = stages.run_odometry(state, feats, cfg)
    return state, odo.q_w.cpu().numpy(), odo.t_w.cpu().numpy()


def turn(cfg, dev, lap, seconds, timers):
    """The loop from the empty state at sweep 0 for ``seconds``: (sweeps a
    second, each sweep's host ms)."""
    xyz, mask = lap
    state = OdometryState.init(cfg.scan.max_less_sharp,
                               cfg.scan.max_less_flat, dev)
    torch.cuda.synchronize(dev)
    times = []
    t_start = time.perf_counter()
    while True:
        k = len(times) % xyz.shape[0]
        t0 = time.perf_counter()
        state, _, _ = sweep(cfg, dev, state, xyz[k], mask[k], timers)
        t1 = time.perf_counter()
        times.append(1000.0 * (t1 - t0))
        if t1 - t_start >= seconds:
            return len(times) / (t1 - t_start), times


def host_cost_us(n: int = 2000) -> float:
    """Host µs a sweep's spans take with the timers open: two top-level
    stages, each with three spans (copy-in, launch, clone-out: one event
    more than the launch wait records), on an idle card, over ``n``
    sweeps."""
    timers = StageTimers(device=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        for name in STAGES:
            with timers.stage(name):
                for part in ("copy_in", "launch", "clone_out"):
                    with span(f"{name}.{part}"):
                        pass
    t1 = time.perf_counter()
    timers.device_report()
    return 1e6 * (t1 - t0) / n


def gaps_with_spans(events, span_names, n=10):
    """The ``n`` longest intervals of the profiled sweeps in which no
    kernel, copy or set ran on the card, each as (ms, innermost program
    span holding its middle, smallest host event holding it), and the idle
    share of the sweeps."""
    sweeps, device, host = [], [], []
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        on_card = "CUDA" in str(e.device_type())
        if name == SWEEP or name.startswith("ProfilerStep"):
            if name == SWEEP and not on_card:
                sweeps.append((s, end))
        elif on_card:
            if not e.is_user_annotation():
                device.append((s, end))
        else:
            host.append((s, end, name))
    w0, w1 = min(s for s, _ in sweeps), max(e for _, e in sweeps)
    busy = []
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e in device
                       if e > w0 and s < w1):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (g0 + g1) / 2
        cover = sorted((e - s, name) for s, e, name in host if s <= mid <= e)
        program_spans = [name for _, name in cover if name in span_names]
        nxt = min(((s, name) for s, _, name in host
                   if name in STAGES and s > mid), default=(None, None))[1]
        out.append({
            "ms": (g1 - g0) / 1e6,
            "span": (program_spans[0] if program_spans
                     else f"none (before {nxt}: {nxt}.gap)"),
            "host_event": cover[0][1] if cover else "none"})
    busy_ns = sum(e - s for s, e in busy)
    return out, 100.0 * (1.0 - busy_ns / (w1 - w0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=3,
                    help="turns of each side (ABBA order)")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--sweeps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=2147483901)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_cost: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda:0")
    cell = manifest.cell(manifest.manifest(), CELL)
    cfg = program.pipeline_config(cell["config"])
    xyz, mask = traffic.host_laps(cell["mix"], cell["config"]["sensor"],
                                  cfg.scan.max_points, args.seed, dev)
    lap = (xyz[:, 0], mask[:, 0])
    turn(cfg, dev, lap, 3.0, None)        # captures both graphs

    order = ["timers", "none", "none", "timers"] * ((args.turns + 1) // 2)
    order = order[:2 * args.turns]
    turns = {"timers": [], "none": []}
    totals = {}     # span -> [device ms, samples] over the timers' turns
    host = {}       # span -> [host ms, samples] over the same turns
    missed = 0
    for side in order:
        # fresh timers a turn: no gap reaches back over the turn between
        timers = StageTimers(device=True) if side == "timers" else None
        fps, times = turn(cfg, dev, lap, args.seconds, timers)
        if timers is not None:
            for into, stats in ((totals, timers.device_report()),
                                (host, timers.stages)):
                for name, st in stats.items():
                    tot = into.setdefault(name, [0.0, 0])
                    tot[0] += st.total_ms
                    tot[1] += st.count
            missed += timers.missed
        turns[side].append({"frames_per_s": fps,
                            "median_sweep_ms": statistics.median(times),
                            "sweeps": len(times)})
        print(f"{side:6s} {fps:.4f} sweeps/s, median sweep "
              f"{statistics.median(times):.3f} ms ({len(times)} sweeps)")
    med = {side: {k: statistics.median(t[k] for t in ts)
                  for k in ("frames_per_s", "median_sweep_ms")}
           for side, ts in turns.items()}
    cost_pct = 100.0 * (med["timers"]["median_sweep_ms"]
                        - med["none"]["median_sweep_ms"]) \
        / med["none"]["median_sweep_ms"]
    fps_pct = 100.0 * (med["none"]["frames_per_s"]
                       - med["timers"]["frames_per_s"]) \
        / med["none"]["frames_per_s"]
    print(f"medians: timers {med['timers']}, none {med['none']}; cost of "
          f"the spans {cost_pct:.3f} % of the median sweep, "
          f"{fps_pct:.3f} % of sweeps/s")
    cost_us = host_cost_us()
    print(f"host cost of a sweep's spans on an idle card: {cost_us:.1f} us "
          f"({0.1 * cost_us / med['none']['median_sweep_ms']:.4f} % of the "
          f"median sweep)")
    spans_ms = {k: ms / n for k, (ms, n) in totals.items()}
    host_ms = {k: ms / n for k, (ms, n) in host.items()}
    events_idle = event_idle_pct(spans_ms, STAGES)
    print(f"missed graph samples: {missed}")
    for name in sorted(set(spans_ms) | set(host_ms)):
        dev_ms, host_s = spans_ms.get(name), host_ms.get(name)
        print(f"  {name:22s} device "
              + ("-" if dev_ms is None else f"{dev_ms:9.4f}")
              + " host " + ("-" if host_s is None else f"{host_s:9.4f}")
              + " ms a sweep")
    print(f"idle share from the program's events (idle_pct.events): "
          f"{events_idle:.4f} %")

    from torch.profiler import ProfilerActivity, profile, record_function

    traced = StageTimers(device=True)
    state = OdometryState.init(cfg.scan.max_less_sharp,
                               cfg.scan.max_less_flat, dev)
    for k in range(3):
        state, _, _ = sweep(cfg, dev, state, lap[0][k], lap[1][k], traced)
    torch.cuda.synchronize(dev)
    traced.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(3, 3 + args.sweeps):
            with record_function(SWEEP):
                state, _, _ = sweep(cfg, dev, state, lap[0][k], lap[1][k],
                                    traced)
        torch.cuda.synchronize(dev)
    traced_ms = {k: v.mean_ms for k, v in traced.device_report().items()}
    names = set(traced_ms) | set(traced.stages)
    gaps, prof_idle = gaps_with_spans(prof.profiler.kineto_results.events(),
                                      names)
    traced_idle = event_idle_pct(traced_ms, STAGES)
    print(f"profiled {args.sweeps} sweeps: profiler idle {prof_idle:.4f} %, "
          f"program events' idle {traced_idle:.4f} % of the same sweeps")
    for g in gaps:
        print(f"  gap {g['ms']:8.4f} ms in {g['span']} (host event "
              f"{g['host_event']})")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "span_cost.json").write_text(json.dumps({
            "card": smi, "turns": turns, "medians": med,
            "cost_pct_of_median_sweep": cost_pct,
            "cost_pct_of_frames_per_s": fps_pct, "host_cost_us": cost_us,
            "spans_ms": spans_ms, "spans_host_ms": host_ms,
            "idle_pct_events": events_idle,
            "missed": missed, "profiled": {
                "sweeps": args.sweeps, "profiler_idle_pct": prof_idle,
                "events_idle_pct": traced_idle, "spans_ms": traced_ms,
                "gaps": gaps}}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
