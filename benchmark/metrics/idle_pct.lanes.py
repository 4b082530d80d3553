"""idle_pct.lanes: as idle_pct.frames, over the profiled batched steps."""

from harness.runner import idle_pct


def read(seen):
    if seen.get("unit") != "step":
        return None
    return idle_pct(seen.get("trace"))
