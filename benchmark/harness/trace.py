"""One profiler timeline, reduced to the numbers the metrics read.

The traced run profiles a fixed slice of the window through a
``torch.profiler`` schedule.  Every unit of work (a frame, or a batched
step) in the slice runs inside a ``bench.unit`` annotation.  Host events,
kernels and copies of the card all carry the profiler's one clock, so the
device's busy time is the union of its kernel, copy and set intervals
inside the slice, and the idle share is what is left of the slice's length:
it cannot leave 0-100.
"""

from __future__ import annotations

import re

UNIT = "bench.unit"
LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync",
            "cudaMemcpy", "cudaMemsetAsync", "cudaMemset",
            "cudaMemcpy2DAsync"}
KNN5 = ("knn5_segment_kernel", "knn5_merge_kernel")
_NOISE = {"void", "at", "native", "c10", "std", "detail", "anonymous",
          "namespace", "lambda", "operator", "const", "float", "double",
          "int", "long", "unsigned", "char", "bool", "signed", "short",
          "Array", "OffsetCalculator", "TrivialOffsetCalculator",
          "LoadWithoutCast", "StoreWithoutCast", "memory", "array",
          "TensorIteratorBase", "cuda", "Half", "BFloat16", "true", "false",
          "unnamed", "type", "auto", "func_wrapper_t", "func_wrapper",
          "FunctionTraits", "function_traits", "vectorized", "policies",
          "unroll", "impl", "launch", "gpu_kernel", "int64_t", "uint8_t"}


def short_name(name: str) -> str:
    """A kernel's demangled name cut to what tells it apart: its own name
    and the first two distinctive names among its template and lambda
    arguments (the functor or the operator that launched it)."""
    name = name.removeprefix("void ").strip()
    m = re.match(r"[\w:]+", name)
    base = (m.group(0) if m else name).split("::")[-1]
    rest = name[m.end():] if m else ""
    words = []
    for w in re.findall(r"[A-Za-z_]\w*", rest):
        if w in _NOISE or w == base or w in words or len(w) < 3:
            continue
        words.append(w)
        if len(words) == 2:
            break
    return "/".join([base] + words)[:96]


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> dict:
    """Counts and times of the profiled slice from the profiler's events
    (objects with name(), device_type(), start_ns(), duration_ns())."""
    units, host, device = [], [], []
    for e in events:
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if name == UNIT or name.startswith("ProfilerStep"):
            # annotations (the profiler mirrors them on the device's rows)
            if name == UNIT and "CUDA" not in str(e.device_type()):
                units.append((s, end))
        elif "CUDA" in str(e.device_type()):
            device.append((s, end, name))
        else:
            host.append((s, end, name))
    if not units:
        return {}
    w0 = min(s for s, _ in units)
    w1 = max(e for _, e in units)
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device
              if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    busy_ns = sum(e - s for s, e in busy)
    kernels = [(s, e, n) for s, e, n in inside
               if not n.startswith(("Memcpy", "Memset"))]
    by_op = {}
    for s, e, n in inside:
        key = short_name(n) if not n.startswith(("Memcpy", "Memset")) else n
        by_op[key] = by_op.get(key, 0) + (e - s)
    launches = sum(1 for s, e, n in host if n in LAUNCHES and w0 <= s < w1)
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        cover = [(e - s, n) for s, e, n in host if s <= mid <= e]
        named.append([min(cover)[1] if cover else "host", (g1 - g0) / 1e9])
    return {
        "units": len(units),
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": len(kernels),
        "launches": launches,
        "knn5_s": sum(e - s for s, e, n in kernels
                      if any(k in n for k in KNN5)) / 1e9,
        "device_ops": [[k, v / 1e9] for k, v in
                       sorted(by_op.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": named,
    }
