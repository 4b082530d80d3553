"""The full-frame cell ``hdl64_kitti.ring.live``: it resolves by name, the
readers of the mapping step's phases read the program's spans (and nothing,
without raising, from a program that records none), and a small ring-road
run of its driver is correct with the program's plane fit and not correct
with the float32 adjugate of the raw normal equations it replaced: the map
lies tens of metres from its origin there, where that fit fails
(tests/test_torch_plane_fit.py).  The run is HDL64_SMALL at 400 azimuth
steps on the CPU (``tiny.py``), about 65 s a case: marked ``slow``."""

import pytest
import torch

import tiny
from harness import manifest, runner

WORKLOAD = "hdl64_kitti.ring.live"
PHASES = {"map_search_ms": "mapping.search", "map_solve_ms": "mapping.solve",
          "map_merge_ms": "mapping.merge"}
SEED = 2**31 + 4099


def test_cell_resolves_with_its_metrics_and_limits():
    m = manifest.manifest()
    c = manifest.cell(m, WORKLOAD)
    assert c["workload"]["chips"] == 1
    assert c["workload"]["config"] == "hdl64_kitti_slam"
    assert c["mix"]["driver"] == "live"
    assert {x["name"] for x in c["end_to_end"]} == {
        "setup_s", "frames_per_s", "frame_ms_p95"}
    have = {x["name"]: x for x in c["per_layer"]}
    for name in ("mapping_ms", "knn5_roofline_pct", *PHASES, "features_ms",
                 "odometry_ms", "kernels_per_frame", "host_launches_per_frame",
                 "idle_pct.frames"):
        assert have[name]["moves"] == "frames_per_s", name
        manifest.reader(name)
    # these sum the features and odometry stages only
    for name in ("graph_ms", "launch_wait_ms", "stage_copy_ms",
                 "idle_pct.events"):
        assert name not in have
    limits = c["limits"]
    assert set(limits["readings"]) == set(limits["limits"])
    assert "odom_gap_mm" in limits["limits"]


def test_phase_readers_read_the_programs_spans():
    ms = {"mapping": 12.0, "mapping.graph": 11.5, "mapping.search": 6.0,
          "mapping.solve": 4.5, "mapping.merge": 1.0}
    for name, span in PHASES.items():
        assert manifest.reader(name).read({"stage_ms": ms}) == ms[span]
    assert manifest.reader("mapping_ms").read({"stage_ms": ms}) == 12.0
    # the parent's program: the stage's own span only, or no traced run
    for name in PHASES:
        assert manifest.reader(name).read({"stage_ms": {"mapping": 12.0}}) \
            is None
        assert manifest.reader(name).read({}) is None


def ring_cell() -> dict:
    cell = manifest.cell(manifest.manifest(), WORKLOAD)
    cell["config"] = tiny.small_config()
    return tiny._shrink(cell, 2, 3)


def adjugate_normal(near):
    """The fit the program replaced: AᵀA n = -Aᵀ1 of raw coordinates in
    float32 by the adjugate."""
    from light_loam_tpu_torch.models.mapping import _solve3x3

    return _solve3x3(torch.einsum("...ni,...nj->...ij", near, near),
                     -near.sum(dim=-2))


@pytest.mark.slow
@pytest.mark.parametrize("fit", ["program", "adjugate"])
def test_small_ring_run_is_correct_with_the_programs_fit_only(fit,
                                                              monkeypatch):
    from light_loam_tpu_torch.models import mapping

    if fit == "adjugate":
        monkeypatch.setattr(mapping, "plane_normal", adjugate_normal)
    torch.set_num_threads(4)
    r = runner.run(ring_cell(), SEED, 20.0, False, "cpu")
    assert r["info"]["runs_compared"]
    assert r["failed"] == 0
    assert r["correct"] is (fit == "program"), r["compared"]
