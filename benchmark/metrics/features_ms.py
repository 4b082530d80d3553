"""features_ms: mean device ms of the feature stage a sweep over the traced
run's window, from the program's StageTimers (CUDA events around each stage
replay, utils/timing.py)."""


def read(seen):
    return seen.get("stage_ms", {}).get("features")
