"""One odometry step of the PyTorch port against the JAX package from the
same mid-trajectory state.

The JAX package runs 6 frames of the hdl64-small straight run (so the
frame counter is past ``vote_start_frame`` and the plane vote gates the
factors), its state is carried across with ``convert.py``, and both
packages step once on the same features of the next scan (the JAX
package's, carried across too: the feature stage has its own tests).

The port runs op by op, each op rounding once, so it is held to the JAX
step run op by op too (``jax.disable_jit``): poses agree to 1e-5
(rotation) and 1e-4 m (translation), float32 rounding through 3 x 4 LM
iterations, and the corner/plane factor counts are equal.  Under ``jit``
XLA fuses multiply-adds into FMAs, which moves a borderline plane
correspondence across its gate (one factor of ~1200 on this frame, ~0.2 mm
of translation); against the jitted step the counts may differ by 2 and
the pose by 1e-3 m / 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.models import odometry as jo
from light_loam_tpu.ops import features as jf
from light_loam_tpu_torch import convert
from light_loam_tpu_torch.config import HDL64_SMALL
from light_loam_tpu_torch.core.frame import PointCloud, RangeImage, ScanFeatures
from light_loam_tpu_torch.models import odometry as to
from light_loam_tpu_torch.models.pipeline import synthetic_frames

torch.set_num_threads(2)

CFG = HDL64_SMALL


@pytest.fixture(scope="module")
def carried():
    frames = list(synthetic_frames(7, CFG, n_azimuth=700, speed=0.6, seed=2))
    scan = CFG.scan
    state = jo.OdometryState.init(scan.max_less_sharp, scan.max_less_flat)
    for _, xyz, mask in frames[:6]:
        feats = jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), scan)
        state, _ = jo.odometry_step(state, feats, CFG.odometry, scan.scan_period)
    leaves = jax.tree_util.tree_map(np.asarray, state)._asdict()
    return leaves, state, frames[6]


def test_state_round_trips_through_convert(carried):
    leaves, _, _ = carried
    back = convert.odometry_state_to_numpy(
        convert.odometry_state_from_numpy(leaves))
    for name in ("q_w", "t_w", "q_lc", "t_lc", "frame"):
        np.testing.assert_array_equal(back[name], leaves[name])
    for cloud in ("corner_last", "surf_last"):
        for leaf in ("xyz", "rel", "mask"):
            np.testing.assert_array_equal(back[cloud][leaf],
                                          getattr(leaves[cloud], leaf))


def test_odometry_step_matches_jax(carried):
    leaves, jstate, (_, xyz, mask) = carried
    assert int(leaves["frame"]) == 6 > CFG.odometry.vote_start_frame
    scan = CFG.scan
    jfeats = jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), scan)
    with jax.disable_jit():
        _, jout = jo.odometry_step(jstate, jfeats, CFG.odometry,
                                   scan.scan_period)
    _, jit_out = jo.odometry_step(jstate, jfeats, CFG.odometry,
                                  scan.scan_period)

    tstate = convert.odometry_state_from_numpy(leaves)
    tfeats = ScanFeatures(
        full=RangeImage(*[torch.as_tensor(np.array(a)) for a in jfeats.full]),
        **{name: PointCloud(*[torch.as_tensor(np.array(a))
                              for a in getattr(jfeats, name)])
           for name in ("sharp", "less_sharp", "flat", "less_flat")})
    new_state, tout = to.odometry_step(tstate, tfeats, CFG.odometry,
                                       scan.scan_period)

    np.testing.assert_allclose(tout.q_w.numpy(), np.asarray(jout.q_w),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout.t_w.numpy(), np.asarray(jout.t_w),
                               rtol=0, atol=1e-4)
    assert int(jout.plane_count) > 100 and int(jout.corner_count) > 50
    assert int(tout.corner_count) == int(jout.corner_count)
    assert int(tout.plane_count) == int(jout.plane_count)
    assert int(new_state.frame) == 7
    assert torch.equal(new_state.surf_last.mask, tfeats.less_flat.mask)

    np.testing.assert_allclose(tout.q_w.numpy(), np.asarray(jit_out.q_w),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tout.t_w.numpy(), np.asarray(jit_out.t_w),
                               rtol=0, atol=1e-3)
    assert abs(int(tout.plane_count) - int(jit_out.plane_count)) <= 2
    assert abs(int(tout.corner_count) - int(jit_out.corner_count)) <= 2
