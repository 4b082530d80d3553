"""graph_ms: device ms a sweep from each stage graph's first node to its
last (the program's ``<stage>.graph`` spans: two timing events captured
into the graph), features plus odometry, mean over every sweep of the
traced run's window.  Gaps between kernels inside a graph count here."""

STAGES = ("features", "odometry")


def read(seen):
    ms = seen.get("stage_ms", {})
    names = [f"{s}.graph" for s in STAGES]
    if not all(n in ms for n in names):
        return None
    return sum(ms[n] for n in names)
