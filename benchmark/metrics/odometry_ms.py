"""odometry_ms: mean device ms of the odometry stage a sweep over the traced
run's window, from the program's StageTimers."""


def read(seen):
    return seen.get("stage_ms", {}).get("odometry")
