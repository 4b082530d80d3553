"""The staged Pipeline through its stage graphs (models/stages.py) on the
CPU, the default config: against the same Pipeline under
``stages.eager()`` bitwise, and against the JAX package's staged Pipeline
on the same numpy frames within tests/test_torch_pipeline.py's band
(``AGREE_M``).  Helpers in test_torch_stages.py.  ~60 s on two CPU
threads.
"""

import pytest
import torch

from test_torch_pipeline import AGREE_M
from test_torch_stages import (
    BASE,
    assert_near_jax,
    assert_runs_equal,
    drive,
    frames,
    jax_drive,
)
from light_loam_tpu_torch.models import stages

torch.set_num_threads(2)

N_FRAMES = 3


@pytest.fixture(scope="module")
def runs():
    frame_list = frames(N_FRAMES)
    stages.clear_graphs()
    return dict(frames=frame_list,
                graph=drive(BASE, frame_list),
                eager=drive(BASE, frame_list, eager=True),
                jax=jax_drive("hdl64-small", frame_list))


def test_default_run_equals_eager(runs):
    assert_runs_equal(runs["graph"], runs["eager"])
    pipe, results = runs["graph"]
    assert all(r.mapped for r in results) and pipe.dropped_mapping_frames == 0
    graphs = stages.stage_graphs(BASE, "cpu")
    assert [g.replays for g in graphs] == [N_FRAMES] * 3
    assert set(pipe.timers.stages) >= {"features", "odometry", "mapping"}


def test_default_run_near_jax(runs):
    assert_near_jax(runs["graph"], runs["jax"], AGREE_M)


def test_default_run_times_its_spans_and_counts_its_reads(runs):
    """Each frame's spans inside the stages (models/stages.py), the host
    spans round the pose read, the keyframe stack and the retire, and its
    reads of the device: the two pose rows, and at the retire the mapped
    pose, the keyframe stack and the three saturation counters."""
    for key in ("graph", "eager"):
        pipe, _ = runs[key]
        timers = pipe.timers
        for name in ("pose_read", "keyframe_stack", "retire"):
            assert timers.stages[name].count == N_FRAMES, (key, name)
        assert timers.reads.count == 9 * N_FRAMES, key
        assert f"host reads: 9.0 a frame ({9 * N_FRAMES} in {N_FRAMES} " \
            "frames)" in timers.report()
    timers = runs["graph"][0].timers
    for stage in ("features", "odometry", "mapping"):
        for part in ("copy_in", "launch", "clone_out"):
            assert timers.stages[f"{stage}.{part}"].count == N_FRAMES
    assert not any(name.startswith("features.") for name in
                   runs["eager"][0].timers.stages)
