"""Feature extraction of the PyTorch port against the JAX package on a
simulated HDL-64 scan (hdl64-small shapes).  Ring ids, labels, order keys
and masks bitwise equal; picked coordinates to 1e-6 (the same points,
moved by identical gathers) and less-flat centroids to 1e-5 (segment-sum
reassociation); rel_time to 1e-6 and rel = ring + 0.1 * rel_time to 1e-5
(arctan2 differs in the last ulp between the libraries, and a float32 ulp
at 64 is ~4e-6).  The occlusion filter (off in every profile) is held to
the same bands: its mask bitwise, and the four clouds with it on against
the JAX stage run op by op (``jax.disable_jit``): under ``jit`` XLA's
FMA-contracted curvature reorders near-tied less-sharp picks on this scan,
the band ROADMAP.md Queue 3 records."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.ops import features as jf
from light_loam_tpu_torch.config import HDL64_SMALL
from light_loam_tpu_torch.ops import cuda_features as cf
from light_loam_tpu_torch.ops import features as tf
from light_loam_tpu_torch.utils.synthetic import World, pad_cloud, simulate_scan

torch.set_num_threads(2)

CFG = HDL64_SMALL.scan


@pytest.fixture(scope="module")
def scan():
    pts = simulate_scan(World.urban(seed=5), np.array([0.5, 0.2, 0.0]),
                        n_rings=CFG.n_scans, lower_deg=CFG.lower_bound_deg,
                        upper_deg=CFG.upper_bound_deg, n_azimuth=700,
                        noise=0.01, seed=11)
    return pad_cloud(pts, CFG.max_points)


def test_ring_ids_and_rel_time(scan):
    xyz, mask = scan
    jr, jok = jf.compute_ring_ids(jnp.asarray(xyz), jnp.asarray(mask), CFG)
    tr, tok = tf.compute_ring_ids(torch.as_tensor(xyz), torch.as_tensor(mask),
                                  CFG)
    # ring ids compared where they are used: padding slots (0, 0, 0) give
    # arctan(0/0) = NaN, whose int conversion differs between the libraries
    ok = np.asarray(jok)
    assert ok.sum() > 10000
    np.testing.assert_array_equal(tok.numpy(), ok)
    np.testing.assert_array_equal(tr.numpy()[ok], np.asarray(jr)[ok])
    jt = jf.compute_rel_time(jnp.asarray(xyz), jnp.asarray(mask), jok)
    tt = tf.compute_rel_time(torch.as_tensor(xyz), torch.as_tensor(mask), tok)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)


def test_select_features_on_the_same_grid(scan):
    """Labels and push-order keys bitwise equal given the same range image
    (the greedy pick sequence is integer logic over equal curvatures)."""
    xyz, mask = scan
    j = jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), CFG)
    grid = j.full
    jcurv = jf.compute_curvature(grid.xyz)
    jlab, jkey = jf.select_features(grid, jcurv, CFG)
    tgrid = tf.RangeImage(*[torch.as_tensor(np.array(a)) for a in grid])
    tcurv = cf.compute_curvature(tgrid.xyz)
    np.testing.assert_array_equal(tcurv.numpy(), np.asarray(jcurv))
    tlab, tkey = cf.select_features(tgrid, tcurv, CFG)
    jlab = np.asarray(jlab)
    assert (jlab == 2).sum() > 50 and (jlab == -1).sum() > 50
    np.testing.assert_array_equal(tlab.numpy(), jlab)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))


@pytest.mark.parametrize("cloud", ["sharp", "less_sharp", "flat", "less_flat"])
def test_extract_features_matches_jax(scan, cloud):
    xyz, mask = scan
    j = getattr(jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), CFG),
                cloud)
    t = getattr(tf.extract_features(torch.as_tensor(xyz),
                                    torch.as_tensor(mask), CFG), cloud)
    jm = np.asarray(j.mask)
    assert jm.sum() > 50
    np.testing.assert_array_equal(t.mask.numpy(), jm)
    np.testing.assert_array_equal(t.ring().numpy(), np.asarray(jnp.floor(
        j.rel).astype(jnp.int32)))
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), rtol=0,
                               atol=1e-6 if cloud != "less_flat" else 1e-5)
    np.testing.assert_allclose(t.rel.numpy(), np.asarray(j.rel), rtol=0,
                               atol=1e-5)


OCC = dataclasses.replace(CFG, occlusion_filter=True)


def test_occlusion_mask_on_the_same_grid(scan):
    xyz, mask = scan
    grid = jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), OCC).full
    want = np.asarray(jf.occlusion_mask(grid, OCC))
    got = tf.occlusion_mask(tf.RangeImage(*[torch.as_tensor(np.array(a))
                                            for a in grid]), OCC)
    # a street scene has both shadow boundaries and grazing beams
    assert 100 < want.sum() < 0.5 * np.asarray(grid.mask).sum()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def occluded_jax(scan):
    xyz, mask = scan
    with jax.disable_jit():
        return jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), OCC)


@pytest.mark.parametrize("cloud", ["sharp", "less_sharp", "flat", "less_flat"])
def test_extract_features_with_occlusion_filter_matches_jax(scan, occluded_jax,
                                                            cloud):
    xyz, mask = scan
    j = getattr(occluded_jax, cloud)
    t = getattr(tf.extract_features(torch.as_tensor(xyz),
                                    torch.as_tensor(mask), OCC), cloud)
    off = getattr(jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask),
                                      CFG), cloud)
    jm = np.asarray(j.mask)
    assert jm.sum() > 50
    # the filter changed this cloud
    assert not np.array_equal(np.asarray(j.xyz), np.asarray(off.xyz))
    np.testing.assert_array_equal(t.mask.numpy(), jm)
    np.testing.assert_array_equal(t.ring().numpy(), np.asarray(jnp.floor(
        j.rel).astype(jnp.int32)))
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), rtol=0,
                               atol=1e-6 if cloud != "less_flat" else 1e-5)
    np.testing.assert_allclose(t.rel.numpy(), np.asarray(j.rel), rtol=0,
                               atol=1e-5)


RUNS = dataclasses.replace(CFG, lessflat_mode="runs")


def test_extract_features_runs_mode_matches_jax(scan):
    """``lessflat_mode="runs"``: the less-flat cloud against the JAX
    package's, live counts and masks equal, centroids within 1e-5; a few %
    more live points than the exact mode (one centroid per visit of a
    voxel), and the other clouds untouched by the mode."""
    xyz, mask = scan
    j = jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), RUNS)
    t = tf.extract_features(torch.as_tensor(xyz), torch.as_tensor(mask), RUNS)
    exact = tf.extract_features(torch.as_tensor(xyz), torch.as_tensor(mask),
                                CFG)
    jm = np.asarray(j.less_flat.mask)
    n_runs, n_exact = int(t.less_flat.mask.sum()), int(exact.less_flat.mask.sum())
    assert n_runs == int(jm.sum()) > 1000
    assert 0.97 * n_exact <= n_runs <= 1.10 * n_exact, (n_exact, n_runs)
    np.testing.assert_array_equal(t.less_flat.mask.numpy(), jm)
    np.testing.assert_allclose(t.less_flat.xyz.numpy(), np.asarray(j.less_flat.xyz),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.less_flat.rel.numpy(), np.asarray(j.less_flat.rel),
                               rtol=0, atol=1e-5)
    for cloud in ("sharp", "less_sharp", "flat"):
        for a, b in zip(getattr(t, cloud), getattr(exact, cloud)):
            assert torch.equal(a, b)


def test_range_image_matches_jax(scan):
    xyz, mask = scan
    j = jf.extract_features(jnp.asarray(xyz), jnp.asarray(mask), CFG).full
    t = tf.extract_features(torch.as_tensor(xyz), torch.as_tensor(mask),
                            CFG).full
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(t.xyz.numpy(), np.asarray(j.xyz))


def test_empty_scan_gives_no_features():
    xyz = np.zeros((CFG.max_points, 3), np.float32)
    mask = np.zeros(CFG.max_points, bool)
    f = tf.extract_features(torch.as_tensor(xyz), torch.as_tensor(mask), CFG)
    for cloud in (f.sharp, f.less_sharp, f.flat, f.less_flat):
        assert int(cloud.mask.sum()) == 0
        assert torch.isfinite(cloud.xyz).all()
