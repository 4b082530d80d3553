"""Voxel downsampling and compaction of the PyTorch port against the JAX
package: masks, cells and row order bitwise equal; centroids to 1e-5
(float reassociation of the segment sums, sorted_store.py:36-38)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.ops import voxel as jv
from light_loam_tpu.utils import synthetic as jsyn
from light_loam_tpu_torch.ops import voxel as tv
from light_loam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(2)

CENTROID_TOL = dict(rtol=1e-5, atol=1e-5)


def _cloud(rng, n, scale=8.0, live=0.8):
    xyz = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    rel = rng.uniform(0, 64, n).astype(np.float32)
    mask = rng.random(n) < live
    return xyz, rel, mask


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("with_cell", [False, True])
def test_voxel_downsample_matches_jax(with_cell):
    rng = np.random.default_rng(0)
    xyz, rel, mask = _cloud(rng, 3000, scale=4.0)
    cell = rng.integers(0, 4, 3000).astype(np.int32) if with_cell else None
    leaf, cap = 0.8, 2048
    j = jv.voxel_downsample(jnp.asarray(xyz), jnp.asarray(rel),
                            jnp.asarray(mask), leaf, cap,
                            extra_key=None if cell is None else jnp.asarray(cell))
    t = tv.voxel_downsample(*_t(xyz, rel, mask), leaf, cap,
                            extra_key=None if cell is None else torch.as_tensor(cell))
    jx, jr, jm, je = (np.asarray(a) for a in j)
    tx, tr, tm, te = (a.numpy() for a in t)
    assert 100 < jm.sum() < cap  # a real dedup, inside capacity
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_allclose(tx, jx, **CENTROID_TOL)
    np.testing.assert_allclose(tr, jr, **CENTROID_TOL)


def test_voxel_downsample_capacity_clip():
    rng = np.random.default_rng(1)
    xyz, rel, mask = _cloud(rng, 2000, scale=30.0)
    j = jv.voxel_downsample(jnp.asarray(xyz), jnp.asarray(rel),
                            jnp.asarray(mask), 0.2, 256)
    t = tv.voxel_downsample(*_t(xyz, rel, mask), 0.2, 256)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), **CENTROID_TOL)


@pytest.mark.parametrize("ring_capacity", [64, 16])  # 16: rings overflow
def test_voxel_downsample_rings_matches_jax(ring_capacity):
    rng = np.random.default_rng(2)
    R, H = 8, 200
    xyz = rng.uniform(-6, 6, (R, H, 3)).astype(np.float32)
    rel = rng.uniform(0, 8, (R, H)).astype(np.float32)
    mask = rng.random((R, H)) < 0.7
    mask[3] = False  # an empty ring
    j = jv.voxel_downsample_rings(jnp.asarray(xyz), jnp.asarray(rel),
                                  jnp.asarray(mask), 0.8, ring_capacity)
    t = tv.voxel_downsample_rings(*_t(xyz, rel, mask), 0.8, ring_capacity)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), **CENTROID_TOL)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), **CENTROID_TOL)


@pytest.mark.parametrize("capacity", [4096, 700])
def test_compact_rows_matches_jax(capacity):
    rng = np.random.default_rng(3)
    n = 3000
    mask = rng.random(n) < 0.4
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    cell = rng.integers(0, 1000, n).astype(np.int32)
    j = jv.compact_rows(jnp.asarray(mask), capacity, jnp.asarray(xyz),
                        jnp.asarray(cell))
    t = tv.compact_rows(*_t(mask), capacity, *_t(xyz, cell))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("capacity", [4096, 700])
@pytest.mark.parametrize("with_keys", [False, True])
def test_compact_matches_jax(with_keys, capacity):
    """``compact``'s gather indices, mask and full order bitwise the JAX
    package's: a stable argsort, so equal keys keep their row order."""
    rng = np.random.default_rng(4)
    n = 3000
    mask = rng.random(n) < 0.4
    values = rng.normal(size=(n, 3)).astype(np.float32)
    keys = (rng.integers(0, 200, n).astype(np.int32) if with_keys else None)
    j = jv.compact(jnp.asarray(values), jnp.asarray(mask), capacity,
                   None if keys is None else jnp.asarray(keys))
    t = tv.compact(*_t(values, mask), capacity,
                   None if keys is None else torch.as_tensor(keys))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx, out_mask, _ = t
    live = int(mask.sum())
    assert int(out_mask.sum()) == min(live, capacity)
    assert mask[idx[:live].numpy()].all()


def test_simulate_scan_copy_is_bitwise_identical():
    pj = jsyn.simulate_scan(jsyn.World.urban(seed=3), np.array([1.0, 0.5, 0.0]),
                            n_azimuth=400, noise=0.01, seed=7)
    pt = tsyn.simulate_scan(tsyn.World.urban(seed=3), np.array([1.0, 0.5, 0.0]),
                            n_azimuth=400, noise=0.01, seed=7)
    assert pj.dtype == pt.dtype and pj.shape == pt.shape
    np.testing.assert_array_equal(pt, pj)


def _revisit_rings(seed=12, R=3, H=96):
    """tests/test_voxel.py:135-175's rings: a slow walk round a circle that
    returns to its start region (a revisited voxel), masked slots among."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, H, dtype=np.float32)
    xyz = np.zeros((R, H, 3), np.float32)
    for r in range(R):
        xyz[r, :, 0] = 3.0 * np.cos(t) + 0.01 * rng.normal(size=H)
        xyz[r, :, 1] = 3.0 * np.sin(t) + 0.01 * rng.normal(size=H)
        xyz[r, :, 2] = 0.1 * r
    rel = rng.uniform(0, 1, (R, H)).astype(np.float32)
    mask = rng.random((R, H)) < 0.85
    return xyz, rel, mask


def _monotonic_rings(seed=13, R=2, H=128):
    """tests/test_voxel.py's no-revisit rings: strictly increasing x."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((R, H, 3), np.float32)
    xyz[:, :, 0] = np.cumsum(rng.uniform(0.05, 0.2, (R, H)), axis=1)
    xyz[:, :, 1] = rng.uniform(0, 0.4, (R, H))
    rel = rng.uniform(0, 1, (R, H)).astype(np.float32)
    mask = rng.random((R, H)) < 0.9
    return xyz, rel, mask


@pytest.mark.parametrize("case,leaf,capacity", [
    ("revisit", 0.5, 64),
    ("revisit", 0.5, 8),      # every ring overflows: the stride decimation
    ("monotonic", 0.5, 128),
    ("random", 0.8, 64),      # runs of one slot, masked rings and gaps
])
def test_voxel_downsample_rings_runs_matches_jax(case, leaf, capacity):
    """The "runs" less-flat downsample against the JAX package's on the
    inputs of tests/test_voxel.py:135-175: masks equal, xyz and rel within
    1e-6."""
    if case == "revisit":
        xyz, rel, mask = _revisit_rings()
    elif case == "monotonic":
        xyz, rel, mask = _monotonic_rings()
    else:
        rng = np.random.default_rng(2)
        xyz = rng.uniform(-6, 6, (8, 200, 3)).astype(np.float32)
        rel = rng.uniform(0, 8, (8, 200)).astype(np.float32)
        mask = rng.random((8, 200)) < 0.7
        mask[3] = False
    j = jv.voxel_downsample_rings_runs(jnp.asarray(xyz), jnp.asarray(rel),
                                       jnp.asarray(mask), leaf, capacity)
    t = tv.voxel_downsample_rings_runs(*_t(xyz, rel, mask), leaf, capacity)
    jm = np.asarray(j[2])
    assert jm.sum() > 10
    np.testing.assert_array_equal(t[2].numpy(), jm)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=0,
                               atol=1e-6)


def test_voxel_rings_runs_equals_exact_when_no_revisit():
    """Twin of tests/test_voxel.py's property on the port's side: on rings
    that never re-enter a voxel, the runs mode yields the exact mode's voxel
    set and centroids (exact is key-ordered, runs azimuth-ordered)."""
    xyz, rel, mask = _monotonic_rings()
    ex, er, em = (a.numpy() for a in tv.voxel_downsample_rings(
        *_t(xyz, rel, mask), 0.5, 128))
    ux, ur, um = (a.numpy() for a in tv.voxel_downsample_rings_runs(
        *_t(xyz, rel, mask), 0.5, 128))
    for r in range(xyz.shape[0]):
        n_e, n_u = em[r].sum(), um[r].sum()
        assert n_e == n_u > 10
        assert not em[r][n_e:].any() and not um[r][n_u:].any()
        se = sorted(map(tuple, np.round(ex[r][:n_e], 4)))
        su = sorted(map(tuple, np.round(ux[r][:n_u], 4)))
        assert se == su
        assert sorted(np.round(er[r][:n_e], 4)) == sorted(np.round(ur[r][:n_u],
                                                                   4))
