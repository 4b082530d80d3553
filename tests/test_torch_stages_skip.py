"""The staged Pipeline through its stage graphs (models/stages.py) on the
CPU with ``skip_frame_num=2``: every other frame maps, and a frame that
does not map runs the features and odometry stages only.  Against the same
Pipeline under ``stages.eager()`` bitwise, and against the JAX package's
staged Pipeline on the same numpy frames within
tests/test_torch_pipeline.py's band.  Helpers in test_torch_stages.py.
~55 s on two CPU threads.
"""

import dataclasses

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


def test_skip_two_equals_eager_and_stays_near_jax():
    odometry = dataclasses.replace(BASE.odometry, skip_frame_num=2)
    cfg = dataclasses.replace(BASE, odometry=odometry)
    frame_list = frames(N_FRAMES)
    stages.clear_graphs()
    run = drive(cfg, frame_list)
    graphs = stages.stage_graphs(cfg, "cpu")
    # two stages a frame, the mapping stage every other frame
    mapped = [i % 2 == 0 for i in range(N_FRAMES)]
    assert [r.mapped for r in run[1]] == mapped
    assert [g.replays for g in graphs] == [N_FRAMES, N_FRAMES, sum(mapped)]
    assert_runs_equal(run, drive(cfg, frame_list, eager=True))
    assert_near_jax(run, jax_drive("hdl64-small", frame_list,
                                   odometry=dataclasses.replace(
                                       BASE.odometry, skip_frame_num=2)),
                    AGREE_M)
