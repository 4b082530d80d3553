"""idle_pct.frames: share of the profiled sweeps in which nothing ran on the
card, 100 x (1 - union of kernel and copy intervals / profiled span), all
on the profiler's one clock."""

from harness.runner import idle_pct


def read(seen):
    if seen.get("unit") != "frame":
        return None
    return idle_pct(seen.get("trace"))
