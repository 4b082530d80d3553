"""The readers of the program's spans inside the stages (launch_wait_ms,
graph_ms, stage_copy_ms, idle_pct.events) on a hand-made ``seen``: their
sums, the idle share's definition, and nothing read, without raising, from
a program that records no such span."""

import pytest

from harness import manifest

# mean device ms a sweep, as harness/drivers/odometry.py takes them from
# the program's device_report()
STAGE_MS = {
    "features": 23.0, "odometry": 60.0,
    "features.copy_in": 0.5, "features.launch": 4.0, "features.graph": 18.0,
    "features.clone_out": 0.3, "features.gap": 1.5,
    "odometry.copy_in": 0.2, "odometry.launch": 0.1, "odometry.graph": 59.5,
    "odometry.clone_out": 0.1, "odometry.gap": 0.05,
}
NEW = ("launch_wait_ms", "graph_ms", "stage_copy_ms", "idle_pct.events")


def read(name, seen):
    return manifest.reader(name).read(seen)


def test_sums_of_both_stages():
    seen = {"stage_ms": STAGE_MS}
    assert read("launch_wait_ms", seen) == pytest.approx(4.1)
    assert read("graph_ms", seen) == pytest.approx(77.5)
    assert read("stage_copy_ms", seen) == pytest.approx(0.5 + 0.3 + 0.2 + 0.1)


def test_idle_share_counts_launch_waits_and_gaps():
    seen = {"stage_ms": STAGE_MS}
    # (launches 4.1 + gaps 1.55) / (gaps 1.55 + features 23 + odometry 60)
    assert read("idle_pct.events", seen) == pytest.approx(
        100.0 * 5.65 / 84.55)
    busy = dict(STAGE_MS, **{"features.launch": 0.0, "odometry.launch": 0.0,
                            "features.gap": 0.0, "odometry.gap": 0.0})
    assert read("idle_pct.events", {"stage_ms": busy}) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_program_without_the_spans_reads_nothing(name):
    # the parent's program: the stages' outer spans only, or no traced run
    outer = {"stage_ms": {"features": 23.0, "odometry": 60.0}}
    assert read(name, outer) is None
    assert read(name, {}) is None


def test_the_four_are_in_the_odometry_cell():
    m = manifest.manifest()
    c = manifest.cell(m, "hdl64_kitti.ring.odometry")
    have = {x["name"]: x for x in c["per_layer"]}
    for name in NEW:
        assert have[name]["source"] == "program_span"
        assert have[name]["moves"] == "frames_per_s"
