"""The staged Pipeline through its stage graphs (models/stages.py) on the
CPU with a divergence injected mid-run: the odometry step emits a NaN
translation on a scan without sharp points (tests/test_torch_fused.py's
``_nan_on_empty``, here where the stages call it), frame 2 of 4 is empty,
and the host contains the failure, writing the previous pose and an
identity warm start into the odometry state; the next odometry replay
copies them in.  Against the same Pipeline under ``stages.eager()``
bitwise, and against the JAX package's staged Pipeline with the same
injection within tests/test_torch_pipeline.py's band.  Helpers in
test_torch_stages.py.  ~45 s on two CPU threads.
"""

import numpy as np
import torch

from test_torch_fused import _nan_on_empty
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

EMPTY_FRAME = 2


def _jax_nan_on_empty(real_step):
    import jax.numpy as jnp

    def step(state, feats, ocfg, period):
        state2, odo = real_step(state, feats, ocfg, period)
        poison = jnp.where(feats.sharp.mask.any(), 0.0, jnp.nan)
        return (state2._replace(t_w=state2.t_w + poison),
                odo._replace(t_w=odo.t_w + poison))
    return step


def test_divergence_contained_as_eager_and_as_jax(monkeypatch):
    import light_loam_tpu.models.pipeline as jpl

    frame_list = frames(4)
    xyz, mask = frame_list[EMPTY_FRAME]
    frame_list[EMPTY_FRAME] = (xyz, np.zeros_like(mask))
    monkeypatch.setattr(stages, "odometry_step",
                        _nan_on_empty(stages.odometry_step))
    monkeypatch.setattr(jpl, "odometry_step",
                        _jax_nan_on_empty(jpl.odometry_step))
    stages.clear_graphs()
    run = drive(BASE, frame_list)
    pipe, results = run
    assert pipe.diverged_frames == 1
    np.testing.assert_array_equal(results[EMPTY_FRAME].odom_t,
                                  results[EMPTY_FRAME - 1].odom_t)
    for r in results:
        assert np.isfinite(r.odom_t).all() and np.isfinite(r.map_t).all()
    assert_runs_equal(run, drive(BASE, frame_list, eager=True))
    assert_near_jax(run, jax_drive("hdl64-small", frame_list), AGREE_M)
