"""knn5_roofline_pct: the least time of the profiled sweeps' knn5 calls
(harness/roofline.py knn_bound from each call's capacity and live query and
reference counts) as a share of the device time of knn5's kernels
(segment and merge) in the same sweeps."""

from harness.roofline import knn_bound


def read(seen):
    tr, calls = seen.get("trace"), seen.get("knn_calls")
    if not tr or not calls or tr["knn5_s"] <= 0:
        return None
    least = sum(knn_bound(Q, [(qc, rc)])[0] for Q, qc, rc in calls)
    return 100.0 * least / tr["knn5_s"]
