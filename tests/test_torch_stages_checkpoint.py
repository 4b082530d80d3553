"""A checkpoint of the staged Pipeline saved mid-run and resumed, on the
CPU, through the stage graphs (models/stages.py): saved after frame
``SAVE_AFTER`` and loaded into a fresh Pipeline, whose next stage runs copy
the loaded states into their buffers, the rest of the run is the
uninterrupted run under ``stages.eager()`` bit for bit, and within
tests/test_torch_pipeline.py's band of the JAX package's staged Pipeline on
the same numpy frames.  Helpers in test_torch_stages.py.  ~50 s on two
CPU threads.
"""

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
from light_loam_tpu_torch.models.pipeline import Pipeline

torch.set_num_threads(2)

N_FRAMES = 3
SAVE_AFTER = 2


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """Saved after frame ``SAVE_AFTER`` and loaded into a fresh Pipeline,
    whose next replays copy the loaded states in: the rest of the run is
    the uninterrupted eager run's, bit for bit, and within the band of the
    JAX package's."""
    frame_list = frames(N_FRAMES)
    stages.clear_graphs()
    head, _ = drive(BASE, frame_list[:SAVE_AFTER])
    path = str(tmp_path / "ckpt.npz")
    head.save(path)
    resumed = Pipeline(BASE, device="cpu")
    resumed.load(path)
    run = drive(BASE, frame_list[SAVE_AFTER:], pipe=resumed)
    assert_runs_equal(run, drive(BASE, frame_list, eager=True),
                      first=SAVE_AFTER)
    jpipe, jres = jax_drive("hdl64-small", frame_list)
    assert_near_jax(run, (jpipe, jres[SAVE_AFTER:]), AGREE_M)
