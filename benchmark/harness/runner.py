"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line.

The driver named by the traffic mix (``harness/drivers/<driver>.py``) makes
the sweeps, warms the program up, runs the window and returns what it saw;
this module reads the metrics from that, runs the reference after the
window and decides ``correct``.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from harness import compare, manifest, program, window

FORBIDDEN = {"jax", "jaxlib", "flax", "light_loam_tpu"}


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since the harness
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        faults=None, control: bool = False) -> dict:
    """The result of one run as a dict (the result line's keys).  With
    ``control`` what is judged is not the program's answers but the
    control's: the reference computed in TF32 in the program's place, from
    the same states and sweeps (the program has no lower precision of its
    own: it refuses one on a card)."""
    cfg = program.pipeline_config(cell["config"])
    drive = manifest.driver(cell["mix"])
    ctx = {"cell": cell, "cfg": cfg, "seed": seed, "seconds": seconds,
           "trace": trace, "device": torch.device(device),
           "since_start": process_age_s, "faults": faults or {}}
    seen = drive.run(ctx)

    on_card = ctx["device"].type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx["device"]) if on_card else 0
    # the program's state goes before the reference runs
    runs = seen.pop("compare_runs")
    seen.pop("program", None)
    gc.collect()
    if on_card:
        from light_loam_tpu_torch.models import fused, stages
        stages.clear_graphs()
        fused.clear_graphs()
        gc.collect()
        torch.cuda.empty_cache()

    params = {g: cell["config"][g] for g in ("scan", "odometry", "mapping")}
    t0 = time.perf_counter()
    sizes = []
    readings = compare.compare_runs(runs, params, ctx["device"], control,
                                    sizes)
    seen["reference_s"] = time.perf_counter() - t0
    if sizes:
        seen["knn_calls"] = window.knn_calls(sizes, cell["config"])
    seen["runs_compared"] = [[r["start"], r["lane"], len(r["sweeps"])]
                             for r in runs]
    seen["readings"] = readings
    correct, compared = compare.verdict(readings, cell["limits"]["limits"])
    if seen["failed"] or not runs:
        correct = False

    metrics = {}
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    for m in wanted:
        if trace:
            value = manifest.reader(m["name"]).read(seen)
        else:
            value = seen["end_to_end"].get(m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(ctx["device"]) if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(seen["attempted"]),
              "failed": int(seen["failed"]), "metrics": metrics,
              "device": dev}
    if trace and seen.get("trace"):
        tr = seen["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["info"] = {k: seen[k] for k in
                      ("frames", "window_s", "reference_s", "setup_split",
                       "readings", "runs_compared", "stretch")
                      if k in seen}
    result["info"]["control"] = control
    result["compared"] = compared
    return result


def idle_pct(trace: dict):
    """100 x (1 - busy / window) of the traced slice, or None."""
    if not trace or trace["window_s"] <= 0:
        return None
    value = 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
    if not 0.0 <= value <= 100.0:
        raise manifest.BenchError(f"idle share {value} outside 0-100")
    return value


def percentile95(values: np.ndarray) -> float:
    """The 95th percentile of every value (linear between order
    statistics, numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))
