"""idle_pct.events: share of the sweep in which the card waited on the
host outside graph execution, from the program's own CUDA events over every
sweep of the traced run's window: 100 x (launch waits + gaps between the
stages) / (gaps + features_ms + odometry_ms), where a gap is ``<stage>.gap``,
from the end of the previous stage's span to the start of its own.  Gaps
between kernels inside a graph are part of graph_ms, not of this share;
idle_pct.frames, from the profiler, counts both over the profiled sweeps."""

STAGES = ("features", "odometry")


def read(seen):
    ms = seen.get("stage_ms", {})
    names = [f"{s}.{part}" for s in STAGES for part in ("launch", "gap")]
    if not all(n in ms for n in names + list(STAGES)):
        return None
    launch = sum(ms[f"{s}.launch"] for s in STAGES)
    gap = sum(ms[f"{s}.gap"] for s in STAGES)
    whole = gap + sum(ms[s] for s in STAGES)
    if whole <= 0:
        return None
    return 100.0 * (launch + gap) / whole
