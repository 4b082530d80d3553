"""host_launches_per_frame: launches of kernels, graphs and copies the host
made (CUDA runtime calls in the profiler's timeline) per profiled sweep."""


def read(seen):
    tr = seen.get("trace")
    if seen.get("unit") != "frame" or not tr or not tr["units"]:
        return None
    return tr["launches"] / tr["units"]
