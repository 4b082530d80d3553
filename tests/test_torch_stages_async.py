"""The staged Pipeline through its stage graphs (models/stages.py) on the
CPU with ``sync_mapping=False`` and ``drop_mapping_backlog=True``: a
mapping step stays busy until the test releases it (every third frame, as
in tests/test_torch_backpressure.py, whose ``_SlowSteps`` holds the
steps), so the two frames between releases are dropped for mapping.  The
pending step the Pipeline retires later holds copies of the stage's
outputs, which later replays cannot overwrite.  Against the same Pipeline
under ``stages.eager()`` bitwise, and against the JAX package's staged
Pipeline held busy the same way (tests/test_backpressure.py's
``_SlowLeaf``) within tests/test_torch_pipeline.py's band.  Helpers in
test_torch_stages.py.  ~60 s on two CPU threads.
"""

import contextlib
import dataclasses

import torch

from test_backpressure import _SlowLeaf
from test_torch_backpressure import _SlowSteps
from test_torch_pipeline import AGREE_M
from test_torch_stages import BASE, assert_near_jax, assert_runs_equal, frames
from light_loam_tpu_torch.models import stages
from light_loam_tpu_torch.models.pipeline import Pipeline

torch.set_num_threads(2)

N_FRAMES = 4
RELEASE_EVERY = 3


def _released(i: int) -> bool:
    return i > 0 and i % RELEASE_EVERY == 0


def _drive_held(monkeypatch, cfg, frame_list, eager: bool):
    slow = _SlowSteps(monkeypatch)
    pipe = Pipeline(cfg, device="cpu")
    results = []
    with stages.eager() if eager else contextlib.nullcontext():
        for i, (xyz, mask) in enumerate(frame_list):
            if _released(i):
                slow.release()
            results.append(pipe.process_frame(xyz, mask))
        slow.release()
        pipe._retire_mapping(wait=True)
    return pipe, results


def _jax_drive_held(monkeypatch, frame_list):
    import light_loam_tpu.models.pipeline as jpl

    real_step = jpl.mapping_step
    leaves = []

    def slow_step(*args, **kwargs):
        state, out = real_step(*args, **kwargs)
        leaves.append(_SlowLeaf(out.t_w))
        return state, out._replace(t_w=leaves[-1])

    monkeypatch.setattr(jpl, "mapping_step", slow_step)
    pipe = jpl.Pipeline(dataclasses.replace(jpl.PROFILES["hdl64-small"],
                                            sync_mapping=False))
    results = []
    for i, (xyz, mask) in enumerate(frame_list):
        if _released(i):
            for leaf in leaves:
                leaf.release()
        results.append(pipe.process_frame(xyz, mask))
    pipe._retire_mapping(wait=True)
    return pipe, results


def test_async_drops_equal_eager_and_stay_near_jax(monkeypatch):
    cfg = dataclasses.replace(BASE, sync_mapping=False)
    assert cfg.drop_mapping_backlog
    frame_list = frames(N_FRAMES)
    stages.clear_graphs()
    run = _drive_held(monkeypatch, cfg, frame_list, eager=False)
    pipe, results = run
    mapped = [r.mapped for r in results]
    assert mapped == [i % RELEASE_EVERY == 0 for i in range(N_FRAMES)]
    assert pipe.dropped_mapping_frames == mapped.count(False)
    assert len(pipe.mapped_positions()) == mapped.count(True)
    assert [g.replays for g in stages.stage_graphs(cfg, "cpu")] == [
        N_FRAMES, N_FRAMES, mapped.count(True)]
    assert_runs_equal(run, _drive_held(monkeypatch, cfg, frame_list,
                                       eager=True))
    assert_near_jax(run, _jax_drive_held(monkeypatch, frame_list), AGREE_M)
