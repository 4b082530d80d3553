"""Where one frame of the PyTorch port's pipeline spends its time on a GPU.

    python scripts/profile_torch.py [--profile hdl64] [--frames 9] [--regimes default async skip2] [--eager] [--fused] [--out DIR] [--trace]

Runs the port's pipeline (``light_loam_tpu_torch``) on the synthetic
straight run on ``cuda``: one warm-up frame, then half of the rest timed
untraced and the other half traced with ``torch.profiler``.  The staged
path runs as it does by default, each stage one CUDA graph replay
(models/stages.py; the graphs are captured before the first frame).
Prints:

  * the card (``nvidia-smi`` name and power limit);
  * per-stage stream time (CUDA events around features, odometry, mapping)
    and host wall time per frame, both from the untraced frames;
  * the card's idle share from the program's own CUDA events over the
    untraced frames (utils/timing.py ``event_idle_pct``, the benchmark's
    ``idle_pct.events``): 100 x (launch waits + gaps between stages) /
    (gaps + the stages' spans), the card waiting on the host outside graph
    execution (gaps between kernels inside a graph are not in it; none on
    the op-by-op path, which replays no graph);
  * kernels per frame on the device, and launches per frame from the host
    (the CUDA runtime's kernel launch, graph launch, copy and set calls);
  * the operators with the most device time, with their launch counts
    (for a replayed graph, which has no host-side operators, its kernels
    by name).

With ``--regimes`` the captured staged path is measured under each regime
named: ``default``, ``async`` (``sync_mapping=False``, the drop policy on:
dropped frames counted) and ``skip2`` (``skip_frame_num=2``).  With
``--eager`` the same frames then go through the staged path op by op
(``stages.eager()``), as the staged path ran before its stages were
captured.

With ``--fused`` the same frames then go through the fused path
(``fused_step=True``, one CUDA graph replay per frame; the graph is captured
before the first frame) and the same numbers are printed beside the staged
path's: the ``fused_step`` stream time, and the kernels of the replayed
graph by name, since a replay has no host-side operators.

With ``--out`` it also writes ``profile_torch.json`` there, and with
``--trace`` a Chrome trace too (~100 MB for 4 flagship frames).  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from light_loam_tpu_torch.models import stages  # noqa: E402
from light_loam_tpu_torch.models.fused import frame_graph  # noqa: E402
from light_loam_tpu_torch.models.pipeline import (  # noqa: E402
    PROFILES,
    Pipeline,
    synthetic_frames,
)
from light_loam_tpu_torch.utils.timing import event_idle_pct  # noqa: E402


# the staged path's regimes: the config each runs under
REGIMES = {
    "default": lambda cfg: cfg,
    "async": lambda cfg: dataclasses.replace(cfg, sync_mapping=False),
    "skip2": lambda cfg: dataclasses.replace(cfg, odometry=dataclasses.replace(
        cfg.odometry, skip_frame_num=2)),
}

# CUDA API calls that start work on the device
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def measure(cfg, frames, n, top_n, smi, profile_name, eager=False) -> tuple:
    """One warm-up frame, ``n`` frames timed untraced, ``n`` traced; returns
    (the numbers, the profiler of the traced frames)."""
    path = ("fused" if cfg.fused_step else
            "staged eager" if eager else "staged captured")
    if not cfg.sync_mapping:
        path += ", sync_mapping=False"
    if cfg.odometry.skip_frame_num > 1:
        path += f", skip_frame_num={cfg.odometry.skip_frame_num}"
    pipe = Pipeline(cfg, device="cuda")
    def run():
        return stages.eager() if eager else contextlib.nullcontext()

    with run():
        pipe.process_frame(*frames[0][1:])
    torch.cuda.synchronize()
    pipe.timers.reset()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    with run():
        for _, xyz, mask in frames[1:1 + n]:
            pipe.process_frame(xyz, mask)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    report = pipe.timers.device_report()
    stage_ms = {k: v.mean_ms for k, v in report.items()}
    idle_pct = event_idle_pct({k: v.total_ms for k, v in report.items()},
                              [k for k in report if "." not in k])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, run():
        for _, xyz, mask in frames[1 + n:1 + 2 * n]:
            pipe.process_frame(xyz, mask)
        torch.cuda.synchronize()

    # kernels (and copies) are the device-side events; each host-side
    # operator's self device time is that of the kernels it launched (a
    # graph replay has no operators: its kernels are listed by name)
    events = prof.key_averages()
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    host_launches = sum(e.count for e in events if e.key in HOST_LAUNCHES)
    ops = on_device if not eager else [
        e for e in events
        if e.device_type != torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0]
    ops = sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)
    top = [
        {"op": e.key, "device_ms_per_frame": e.self_device_time_total / 1e3 / n,
         "calls_per_frame": e.count / n}
        for e in ops[:top_n]
    ]
    result = {
        "card": smi, "profile": profile_name, "path": path,
        "frames_timed": n, "frames_traced": n,
        "wall_ms_per_frame": wall_ms / n,
        "stage_stream_ms_per_frame": stage_ms,
        "idle_pct_events": idle_pct,
        "kernel_ms_per_frame": kernel_ms / n,
        "launches_per_frame": sum(e.count for e in on_device) / n,
        "host_launches_per_frame": host_launches / n,
        "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20,
        "dropped_mapping_frames": pipe.dropped_mapping_frames,
        "top_ops": top,
    }
    print(f"{profile_name} {path}: {n}+{n} frames | wall {wall_ms / n:.2f} "
          f"ms/frame | kernels {kernel_ms / n:.2f} ms/frame in "
          f"{result['launches_per_frame']:.0f} kernels, "
          f"{result['host_launches_per_frame']:.0f} launches from the host "
          f"| device idle (program's events) "
          + ("n/a" if idle_pct is None else f"{idle_pct:.2f} %")
          + f" | peak memory "
          f"{result['peak_memory_mib']:.0f} MiB | dropped mapping frames "
          f"{pipe.dropped_mapping_frames}")
    print("stage stream ms/frame: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(stage_ms.items())))
    for r in top:
        print(f"  {r['device_ms_per_frame']:9.3f} ms  {r['calls_per_frame']:8.1f}x"
              f"  {r['op'][:90]}")
    return result, prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="hdl64", choices=sorted(PROFILES))
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--n-azimuth", type=int, default=1800)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--regimes", nargs="+", default=["default"],
                    choices=sorted(REGIMES),
                    help="the staged path's regimes to measure, captured")
    ap.add_argument("--eager", action="store_true",
                    help="also measure the staged path op by op "
                         "(stages.eager())")
    ap.add_argument("--fused", action="store_true",
                    help="also measure the fused path (one graph replay per "
                         "frame)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    base = PROFILES[args.profile]
    frames = list(synthetic_frames(args.frames, base, n_azimuth=args.n_azimuth))
    n = (len(frames) - 1) // 2
    if n < 1:
        raise SystemExit("profile_torch: --frames must be at least 3")
    results = {}
    graphs = stages.stage_graphs(base, "cuda")
    print("staged: " + ", ".join(
        f"{g.stage} warm-up {g.warmup_seconds:.2f} s, capture "
        f"{g.capture_seconds:.2f} s" for g in graphs))
    for regime in args.regimes:
        key = "staged" if regime == "default" else f"staged {regime}"
        results[key], prof = measure(REGIMES[regime](base), frames, n,
                                     args.top, smi, args.profile)
        results[key]["graphs"] = {
            g.stage: {"warmup_seconds": g.warmup_seconds,
                      "capture_seconds": g.capture_seconds,
                      "kernel_launches": g.kernel_launches} for g in graphs}
    if args.eager:
        results["staged eager"], prof = measure(base, frames, n, args.top,
                                                smi, args.profile, eager=True)
    if args.fused:
        cfg = dataclasses.replace(base, fused_step=True)
        graph = frame_graph(cfg, "cuda")
        print(f"fused: warm-up {graph.warmup_seconds:.2f} s, capture and "
              f"instantiate {graph.capture_seconds:.2f} s")
        results["fused"], prof = measure(cfg, frames, n, args.top, smi,
                                         args.profile)
        results["fused"]["warmup_seconds"] = graph.warmup_seconds
        results["fused"]["capture_seconds"] = graph.capture_seconds
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "profile_torch.json").write_text(
            json.dumps(results, indent=1))
        if args.trace:
            prof.export_chrome_trace(str(args.out / "profile_torch_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
