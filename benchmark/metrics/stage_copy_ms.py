"""stage_copy_ms: device ms a sweep of the stages' copies into their static
buffers (pinned staging included) and of the clones of their outputs (the
program's ``<stage>.copy_in`` and ``<stage>.clone_out`` spans), features
plus odometry, mean over every sweep of the traced run's window."""

STAGES = ("features", "odometry")


def read(seen):
    ms = seen.get("stage_ms", {})
    names = [f"{s}.{part}" for s in STAGES
             for part in ("copy_in", "clone_out")]
    if not all(n in ms for n in names):
        return None
    return sum(ms[n] for n in names)
