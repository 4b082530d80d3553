"""launch_wait_ms: device ms a sweep from an event recorded just before each
stage graph's replay() to the graph's first node (the program's
``<stage>.launch`` spans, utils/timing.py GraphMarks), features plus
odometry, mean over every sweep of the traced run's window."""

STAGES = ("features", "odometry")


def read(seen):
    ms = seen.get("stage_ms", {})
    names = [f"{s}.launch" for s in STAGES]
    if not all(n in ms for n in names):
        return None
    return sum(ms[n] for n in names)
