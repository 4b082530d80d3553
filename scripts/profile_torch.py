"""Where one frame of the PyTorch port's pipeline spends its time on a GPU.

    python scripts/profile_torch.py [--profile hdl64] [--frames 9] [--fused] [--out DIR] [--trace]

Runs the port's pipeline (``light_loam_tpu_torch``) on the synthetic
straight run on ``cuda``: one warm-up frame, then half of the rest timed
untraced and the other half traced with ``torch.profiler``.  Prints:

  * the card (``nvidia-smi`` name and power limit);
  * per-stage stream time (CUDA events around features, odometry, mapping)
    and host wall time per frame, both from the untraced frames;
  * device busy share: kernel time per traced frame over untraced wall
    time per frame (kernels on one stream do not overlap, so 1 - busy is
    the idle share);
  * the operators with the most device time, with their launch counts.

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
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from light_loam_tpu_torch.models.fused import frame_graph  # noqa: E402
from light_loam_tpu_torch.models.pipeline import (  # noqa: E402
    PROFILES,
    Pipeline,
    synthetic_frames,
)


def measure(cfg, frames, n, top_n, smi, profile_name) -> tuple:
    """One warm-up frame, ``n`` frames timed untraced, ``n`` traced; returns
    (the numbers, the profiler of the traced frames)."""
    path = "fused" if cfg.fused_step else "staged"
    pipe = Pipeline(cfg, device="cuda")
    pipe.process_frame(*frames[0][1:])
    torch.cuda.synchronize()
    pipe.timers.reset()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    for _, xyz, mask in frames[1:1 + n]:
        pipe.process_frame(xyz, mask)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = {k: v.mean_ms for k, v in pipe.timers.device_report().items()}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    ops = on_device if cfg.fused_step else [
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
        "stage_stream_ms_per_frame": stages,
        "device_busy_share": kernel_ms / wall_ms,
        "kernel_ms_per_frame": kernel_ms / n,
        "launches_per_frame": sum(e.count for e in on_device) / n,
        "peak_memory_mib": torch.cuda.max_memory_allocated() / 2**20,
        "top_ops": top,
    }
    print(f"{profile_name} {path}: {n}+{n} frames | wall {wall_ms / n:.2f} "
          f"ms/frame | kernels {kernel_ms / n:.2f} ms/frame in "
          f"{result['launches_per_frame']:.0f} launches | device busy "
          f"{kernel_ms / wall_ms:.3f} | peak memory "
          f"{result['peak_memory_mib']:.0f} MiB")
    print("stage stream ms/frame: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(stages.items())))
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
    results["staged"], prof = measure(base, frames, n, args.top, smi,
                                      args.profile)
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
