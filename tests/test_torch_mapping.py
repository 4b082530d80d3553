"""The mapping stage of the PyTorch port against the JAX package.

Module pieces (eigh3x3, the voxel segment reduce, the sorted merge) get
the same inputs on both sides and agree to float32 rounding.  The whole
``mapping_step`` starts from a state carried across with ``convert.py``
after 4 frames of the JAX pipeline (a non-empty, key-sorted map store), on
a frame that stays in the grid and on one that recenters it.

Tolerances of the whole step: the plane fit solves the 3x3 normal
equations of 5 neighbours in float32 (as the JAX package does), and for
near-collinear neighbour sets (cond(AᵀA) ~1e5-1e6, common along a ring on
the ground) its residual gate is decided by rounding.  So any two float32
roundings, the JAX package's own jit and op-by-op runs among them, accept
a few percent different plane factors (1831 vs 1787 of ~1800 on this
frame) and land a few mm apart.  The step is therefore held to 1 cm and
1e-3 in pose, 5 % in factor counts and 1 % in map points, while its inputs
(local maps, stacks, 5-NN distances) must agree exactly or to float32
rounding, and the well-conditioned fits (cond(AᵀA) < 1e4) but for the
rare near-tie at the residual gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.config import MappingConfig as JMappingConfig
from light_loam_tpu.core import quaternion as jq
from light_loam_tpu.models import mapping as jm
from light_loam_tpu.models import odometry as jo
from light_loam_tpu.models import pipeline as jpl
from light_loam_tpu.ops import eig3 as jeig
from light_loam_tpu.ops import features as jf
from light_loam_tpu.ops import knn as jknn
from light_loam_tpu.ops import sorted_store as jss
from light_loam_tpu.ops.voxel import voxel_downsample as jvoxel_downsample
from light_loam_tpu_torch import convert
from light_loam_tpu_torch.config import HDL64_SMALL
from light_loam_tpu_torch.core import quaternion as tq
from light_loam_tpu_torch.core.frame import PointCloud
from light_loam_tpu_torch.models import mapping as tm
from light_loam_tpu_torch.models.pipeline import synthetic_frames
from light_loam_tpu_torch.ops import sorted_store as tss
from light_loam_tpu_torch.ops.cuda_knn import knn5
from light_loam_tpu_torch.ops.eig3 import eigh3x3
from light_loam_tpu_torch.ops.voxel import voxel_downsample

torch.set_num_threads(2)

CFG = HDL64_SMALL
MCFG = CFG.mapping


def _t(a):
    return torch.as_tensor(np.array(a))


def test_eigh3x3_matches_jax():
    rng = np.random.default_rng(0)
    B = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = np.einsum("nij,nkj->nik", B, B)
    # plus covariances of 5 points along a line, the corner fits' case
    d = rng.normal(size=(16, 1, 3))
    pts = rng.uniform(-1, 1, (16, 5, 1)) * d + rng.normal(
        scale=1e-3, size=(16, 5, 3))
    c = pts - pts.mean(axis=1, keepdims=True)
    A = np.concatenate([A, np.einsum("nki,nkj->nij", c, c)]).astype(np.float32)
    jvals, jvec = map(np.asarray, jeig.eigh3x3(jnp.asarray(A)))
    tvals, tvec = eigh3x3(torch.as_tensor(A))
    # the same closed form; arccos/cos may differ in the last ulp between
    # the libraries, which the cancellation in λ0 = q + 2p·cos(φ + 2π/3)
    # lifts to ~1e-5 of the matrix scale
    scale = np.abs(A).max(axis=(1, 2))[:, None]
    assert (np.abs(tvals.numpy() - jvals) <= 1e-5 * scale + 1e-6).all()
    dots = np.abs(np.sum(tvec.numpy() * jvec, axis=-1))
    assert (dots > 1 - 1e-5).all()


def _rand_cloud(rng, n, scale=30.0, live_frac=0.8):
    xyz = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    return xyz, rng.uniform(size=n) < live_frac


def test_voxel_segment_reduce_matches_jax():
    rng = np.random.default_rng(1)
    xyz, mask = _rand_cloud(rng, 300, scale=5.0)
    cell = rng.integers(0, 4, size=300).astype(np.int32)
    kmaj, kmin, jsum, jcnt, jcell = map(np.asarray, jss.voxel_segment_reduce(
        jnp.asarray(xyz), jnp.asarray(mask), 0.8, jnp.asarray(cell)))
    key, tsum, tcnt, tcell = tss.voxel_segment_reduce(
        _t(xyz), _t(mask), 0.8, _t(cell))
    u = int((jcnt > 0).sum())
    assert u > 20
    # one int64 key in the port, the (major, minor) int32 pair in JAX
    want = (kmaj[:u].astype(np.int64) << 32) | kmin[:u].astype(np.int64)
    np.testing.assert_array_equal(key.numpy()[:u], want)
    np.testing.assert_array_equal(tcnt.numpy(), jcnt)
    np.testing.assert_array_equal(tcell.numpy()[:u], jcell[:u])
    # per-voxel sums of a few float32 points: reassociation only
    np.testing.assert_allclose(tsum.numpy(), jsum, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("leaf,capacity,n_new", [
    (0.4, 4096, 800),
    (0.8, 4096, 800),
    (0.8, 256, 300),   # overflow: the highest keys drop
])
def test_merge_sorted_matches_jax(leaf, capacity, n_new):
    rng = np.random.default_rng(2)
    cfg = JMappingConfig()
    cen = jnp.asarray([10, 10, 5], jnp.int32)
    store = jm.MapStore.zeros(capacity)
    for _ in range(3):
        xyz, mask = _rand_cloud(rng, n_new)
        store = jm._merge_into_store(store, jnp.asarray(xyz),
                                     jnp.asarray(mask), cen, cfg, leaf,
                                     capacity)
    new_xyz, new_mask = _rand_cloud(rng, n_new)
    cell = np.asarray(jm._cell_linear(jm._cube_of(jnp.asarray(new_xyz), cen,
                                                  cfg), cfg)).astype(np.int32)
    j = [np.asarray(a) for a in jss.merge_sorted(
        store.xyz, store.cell, store.mask, jnp.asarray(new_xyz),
        jnp.asarray(cell), jnp.asarray(new_mask), leaf)]
    t = [a.numpy() for a in tss.merge_sorted(
        _t(store.xyz), _t(store.cell), _t(store.mask), _t(new_xyz),
        _t(cell), _t(new_mask), leaf)]
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[1][t[2]], j[1][j[2]])
    # running centroids (c·w + Σ)/(w + n): float reassociation only
    np.testing.assert_allclose(t[0][t[2]], j[0][j[2]], rtol=1e-5, atol=1e-5)
    assert bool(tss.is_key_sorted(_t(t[0]), _t(t[1]), _t(t[2]), leaf))


@pytest.fixture(scope="module")
def carried():
    """The JAX pipeline's mapping state after 4 frames of the hdl64-small
    straight run, and the next frame's odometry output."""
    frames = list(synthetic_frames(5, CFG, n_azimuth=700, speed=0.6, seed=2))
    pipe = jpl.Pipeline(CFG)
    for _, xyz, mask in frames[:4]:
        pipe.process_frame(xyz, mask)
    pipe._retire_mapping(wait=True)
    _, xyz, mask = frames[4]
    feats = jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), CFG.scan)
    ost, oout = jo.odometry_step(pipe.odo_state, feats, CFG.odometry,
                                 CFG.scan.scan_period)
    return pipe.map_state, ost.corner_last, ost.surf_last, oout.q_w, oout.t_w


def _shift_grid(state, di):
    """The same map with the grid center moved by ``di`` cells along x
    (every live cell id moves with it, so the store stays key-sorted)."""
    def shift(store):
        return store._replace(cell=jnp.where(store.mask, store.cell + di,
                                             store.cell))
    return state._replace(corner=shift(state.corner), surf=shift(state.surf),
                          cen=state.cen + jnp.asarray([di, 0, 0], jnp.int32))


def _cloud(c):
    return PointCloud(*[_t(a) for a in c])


def test_scan_to_map_inputs_match_jax(carried):
    """First outer iteration, same pose: local map and stack bitwise, 5-NN
    distances to Gram-form rounding, and the well-conditioned plane fits
    accept the same factors."""
    jstate, _, surf, q_odom, t_odom = carried

    @jax.jit
    def jax_side(st, surf, q_odom, t_odom):
        q_w = jq.quat_normalize(jq.quat_multiply(st.q_wm, q_odom))
        t_w = jq.quat_rotate(st.q_wm, t_odom) + st.t_wm
        _, s, _, center = jm._recenter(st, t_w, MCFG)
        lx, lm, _ = jm._gather_local(s, center, MCFG, MCFG.local_surf_capacity)
        sx, _, sm, _ = jvoxel_downsample(surf.xyz, surf.rel, surf.mask,
                                         MCFG.plane_resolution,
                                         MCFG.stack_surf_capacity)
        p = jq.quat_rotate(q_w[None], sx) + t_w[None]
        d, idx = jknn.knn_tiled(p, lx, lm, k=5, tile=MCFG.knn_tile)
        pf = jm.plane_fit_factors(sx, sm, d, lx[idx], MCFG)
        return lx, lm, sx, sm, d, pf.mask

    jlx, jlm, jsx, jsm, jd, jmask = map(np.asarray,
                                        jax_side(jstate, surf, q_odom, t_odom))

    tstate = convert.mapping_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict())
    tsurf = _cloud(surf)
    q_w = tq.quat_normalize(tq.quat_multiply(tstate.q_wm, _t(q_odom)))
    t_w = tq.quat_rotate(tstate.q_wm, _t(t_odom)) + tstate.t_wm
    _, s, _, center = tm._recenter(tstate, t_w, MCFG)
    lx, lm, _ = tm._gather_local(s, center, MCFG, MCFG.local_surf_capacity)
    sx, _, sm, _ = voxel_downsample(tsurf.xyz, tsurf.rel, tsurf.mask,
                                    MCFG.plane_resolution,
                                    MCFG.stack_surf_capacity)
    np.testing.assert_array_equal(lm.numpy(), jlm)
    np.testing.assert_array_equal(lx.numpy(), jlx)
    np.testing.assert_array_equal(sm.numpy(), jsm)
    # stack centroids: segment-sum reassociation
    np.testing.assert_allclose(sx.numpy(), jsx, rtol=0, atol=1e-5)

    p = tq.quat_rotate(q_w[None], sx) + t_w[None]
    counts = torch.stack([sm.sum(), lm.sum()]).to(torch.int32)
    d, idx = knn5(p, lx, lm, counts)
    live = jsm[:, None] & (jd < 1e30)
    assert live.sum() > 1000
    # Gram-form distances round at the scale of |p|² + |r|² (~1e3 m² here)
    np.testing.assert_allclose(d.numpy()[live], jd[live], rtol=0, atol=2e-3)

    near = lx[idx.long()]
    pf = tm.plane_fit_factors(sx, sm, d, near, MCFG)
    nd = near.double().numpy()
    ev = np.linalg.eigvalsh(np.einsum("qni,qnj->qij", nd, nd))
    cond = ev[:, 2] / np.maximum(ev[:, 0], 1e-30)
    gated = jsm & (d.numpy()[:, 4] < MCFG.knn_sq_gate) & (
        jd[:, 4] < MCFG.knn_sq_gate)
    well = gated & (cond < 1e4)
    assert well.sum() > 300
    # a well-conditioned fit whose residual lies at the 0.2 m gate may
    # still flip: at most 1 % of them
    flips = (pf.mask.numpy() != jmask) & well
    assert flips.sum() <= 0.01 * well.sum(), (flips.sum(), well.sum())


@pytest.mark.parametrize("recenter", [False, True])
def test_mapping_step_matches_jax(carried, recenter):
    jstate, corner, surf, q_odom, t_odom = carried
    if recenter:
        # move the grid so the pose cube sits past the margin: the step
        # shifts it back by one cell and re-sorts the whole store
        jstate = _shift_grid(jstate, 8)
    new_j, jout = jm.mapping_step(jstate, corner, surf, q_odom, t_odom, MCFG)

    tstate = convert.mapping_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict())
    assert int(tstate.corner.mask.sum()) > 1000
    new_t, tout = tm.mapping_step(tstate, _cloud(corner), _cloud(surf),
                                  _t(q_odom), _t(t_odom), MCFG)

    np.testing.assert_array_equal(new_t.cen.numpy(), np.asarray(new_j.cen))
    assert (not np.array_equal(np.asarray(new_j.cen),
                               np.asarray(jstate.cen))) == recenter
    np.testing.assert_allclose(tout.q_w.numpy(), np.asarray(jout.q_w),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(tout.t_w.numpy(), np.asarray(jout.t_w),
                               rtol=0, atol=1e-2)
    for name, rel in (("corner_factors", 0.05), ("surf_factors", 0.05),
                      ("map_corner_points", 0.01), ("map_surf_points", 0.01)):
        want = int(getattr(jout, name))
        assert want > 100
        assert abs(int(getattr(tout, name)) - want) <= rel * want, name
    for store, leaf in ((new_t.corner, MCFG.line_resolution),
                        (new_t.surf, MCFG.plane_resolution)):
        assert bool(tss.is_key_sorted(store.xyz, store.cell, store.mask, leaf))
    assert int(new_t.frame) == int(new_j.frame)
