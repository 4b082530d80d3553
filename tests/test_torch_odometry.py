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
the pose by 1e-3 m / 1e-4.

The options off the live path step from the same carried state: the full
plane vote, the simple corner vote with scalar edge factors and the tiled
surf search (on the carried cloud compacted as the tiled hand-off stores
it), the full corner vote with the distortion hook.  Each is held to the
op-by-op bands above, the hand-off clouds to the JAX step's, and, as
tests/test_aux.py does for the JAX package, three frames of each track
the truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dataclasses

from light_loam_tpu.core.frame import PointCloud as JCloud
from light_loam_tpu.models import odometry as jo
from light_loam_tpu.ops import features as jf
from light_loam_tpu.ops.voxel import compact_rows as jcompact
from light_loam_tpu_torch import convert
from light_loam_tpu_torch.config import HDL64_SMALL, OdometryConfig, ScanConfig
from light_loam_tpu_torch.core.frame import PointCloud, RangeImage, ScanFeatures
from light_loam_tpu_torch.models import odometry as to
from light_loam_tpu_torch.models.pipeline import synthetic_frames
from light_loam_tpu_torch.ops import features as tfeat
from light_loam_tpu_torch.utils.synthetic import World, pad_cloud, simulate_scan

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


def _torch_feats(jfeats):
    return ScanFeatures(
        full=RangeImage(*[torch.as_tensor(np.array(a)) for a in jfeats.full]),
        **{name: PointCloud(*[torch.as_tensor(np.array(a))
                              for a in getattr(jfeats, name)])
           for name in ("sharp", "less_sharp", "flat", "less_flat")})


OPTION_CASES = [
    # (plane vote, corner vote, surf search, distortion hook)
    ("full", "off", "grid", False),
    ("simple", "simple", "tiled", False),
    ("off", "full", "grid", True),
]


@pytest.mark.parametrize("plane,corner,surf_knn,distortion", OPTION_CASES)
def test_odometry_options_match_jax(carried, plane, corner, surf_knn,
                                    distortion):
    leaves, jstate, (_, xyz, mask) = carried
    cfg = dataclasses.replace(CFG.odometry, plane_vote_mode=plane,
                              corner_vote_mode=corner, surf_knn=surf_knn,
                              distortion=distortion)
    scan = CFG.scan
    if surf_knn == "tiled":
        # the carried cloud as a tiled hand-off would have stored it
        s = jstate.surf_last
        km, kx, kr = jcompact(s.mask, s.capacity, s.xyz, s.rel)
        jstate = jstate._replace(surf_last=JCloud(xyz=kx, rel=kr, mask=km))
        leaves = jax.tree_util.tree_map(np.asarray, jstate)._asdict()
    jfeats = jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), scan)
    with jax.disable_jit():
        jnew, jout = jo.odometry_step(jstate, jfeats, cfg, scan.scan_period)
    tnew, tout = to.odometry_step(convert.odometry_state_from_numpy(leaves),
                                  _torch_feats(jfeats), cfg, scan.scan_period)

    np.testing.assert_allclose(tout.q_w.numpy(), np.asarray(jout.q_w),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout.t_w.numpy(), np.asarray(jout.t_w),
                               rtol=0, atol=1e-4)
    assert int(jout.plane_count) > 100 and int(jout.corner_count) > 50
    assert int(tout.corner_count) == int(jout.corner_count)
    assert int(tout.plane_count) == int(jout.plane_count)

    # the hand-off: compacted (tiled) or moved to the sweep's end
    # (distortion) exactly as the JAX step stores it
    for name in ("corner_last", "surf_last"):
        t_c, j_c = getattr(tnew, name), getattr(jnew, name)
        np.testing.assert_array_equal(t_c.mask.numpy(), np.asarray(j_c.mask))
        np.testing.assert_array_equal(t_c.rel.numpy(), np.asarray(j_c.rel))
        if distortion:
            # moved by each package's own solved pose (within 1e-4 m)
            np.testing.assert_allclose(t_c.xyz.numpy(), np.asarray(j_c.xyz),
                                       rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(t_c.xyz.numpy(),
                                          np.asarray(j_c.xyz))
    if surf_knn == "tiled":
        n = int(tnew.surf_last.mask.sum())
        assert n > 1000 and bool(tnew.surf_last.mask[:n].all())


@pytest.mark.parametrize("distortion", [False, True])
def test_transform_to_end_matches_jax(carried, distortion):
    _, jstate, _ = carried
    rng = np.random.default_rng(4)
    q = rng.normal(size=4).astype(np.float32) * np.float32(0.05)
    q[3] = 1.0
    q = (q / np.linalg.norm(q)).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    cloud = jstate.surf_last
    j = jo.transform_to_end(jnp.asarray(q), jnp.asarray(t), cloud,
                            distortion, 0.1)
    tc = to.transform_to_end(torch.as_tensor(q), torch.as_tensor(t),
                             PointCloud(*[torch.as_tensor(np.array(a))
                                          for a in cloud]), distortion, 0.1)
    np.testing.assert_allclose(tc.xyz.numpy(), np.asarray(j.xyz), rtol=0,
                               atol=2e-5)
    np.testing.assert_array_equal(tc.rel.numpy(), np.asarray(j.rel))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(j.mask))


@pytest.mark.parametrize("plane,corner", [("full", "off"),
                                          ("simple", "simple"),
                                          ("off", "full")])
def test_vote_modes_run(plane, corner):
    """tests/test_aux.py::test_vote_modes_run on the port: three frames of
    a 16-ring scan per vote mode pair, translation within 0.3 m of the
    truth."""
    scfg = ScanConfig(n_scans=16, h_max=512, max_points=16384)
    ocfg = dataclasses.replace(
        OdometryConfig(outer_iterations=2, inner_iterations=3),
        plane_vote_mode=plane, corner_vote_mode=corner, vote_start_frame=1)
    world = World.urban(seed=3)
    st = to.OdometryState.init(scfg.max_less_sharp, scfg.max_less_flat)
    for i in range(3):
        pts = simulate_scan(world, np.array([0.3 * i, 0.0, 0.0]), n_rings=16,
                            lower_deg=-15, upper_deg=15, n_azimuth=450,
                            noise=0.01, seed=10 + i)
        xyz, mask = pad_cloud(pts, scfg.max_points)
        feats = tfeat.extract_features(torch.as_tensor(xyz),
                                       torch.as_tensor(mask), scfg)
        st, out = to.odometry_step(st, feats, ocfg)
    t = out.t_w.numpy()
    assert np.isfinite(t).all()
    assert abs(t[0] - 0.6) < 0.3, f"{plane}/{corner}: {t}"
