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


def test_simulate_scan_copy_is_bitwise_identical():
    pj = jsyn.simulate_scan(jsyn.World.urban(seed=3), np.array([1.0, 0.5, 0.0]),
                            n_azimuth=400, noise=0.01, seed=7)
    pt = tsyn.simulate_scan(tsyn.World.urban(seed=3), np.array([1.0, 0.5, 0.0]),
                            n_azimuth=400, noise=0.01, seed=7)
    assert pj.dtype == pt.dtype and pj.shape == pt.shape
    np.testing.assert_array_equal(pt, pj)
