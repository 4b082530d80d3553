"""mapping_ms: mean device ms of the mapping stage a sweep over the traced
run's window, from the program's StageTimers."""


def read(seen):
    return seen.get("stage_ms", {}).get("mapping")
