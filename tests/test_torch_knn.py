"""Correspondence searches and the 5-NN of the PyTorch port against the JAX
package.

The odometry searches (corner, grid surf) must pick the same indices and
validity.  ``knn5_plain`` (the plain version of the CUDA 5-NN kernel) is held
against ``knn_tiled`` and the Pallas kernel in interpret mode, mirroring
tests/test_pallas_knn.py: distances to rtol 1e-5 / atol 1e-4 plus two float32
ulps of |q|² + |r|² — the Gram form ‖q‖² + ‖r‖² − 2q·r rounds at that scale
(~5e-4 m² here), and jitted XLA contracts it into an FMA where eager PyTorch
does not; indices equal where a neighbour exists (d < 1e30; empty slots
carry index 0 here and any index in knn_tiled)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu.core.frame import PointCloud as JCloud
from light_loam_tpu.ops import knn as jk
from light_loam_tpu.ops.pallas_knn import knn_pallas
from light_loam_tpu.utils.synthetic import World, simulate_scan
from light_loam_tpu_torch.core.frame import PointCloud as TCloud
from light_loam_tpu_torch.ops import knn as tk
from light_loam_tpu_torch.ops.cuda_knn import KNN5, knn5, knn5_plain

torch.set_num_threads(2)

RTOL, ATOL, GRAM_ULPS = 1e-5, 1e-4, 2.0


def _cloud(rng, n, scale=60.0):
    return (rng.random((n, 3), np.float32) - 0.5) * scale


def _counts(qc, rc):
    return torch.tensor([qc, rc], dtype=torch.int32)


def _assert_knn_equal(q, r, d_t, i_t, d_j, i_j):
    d_t, i_t = d_t.numpy(), i_t.numpy()
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    scale = (q * q).sum(-1)[:, None] + (r * r).sum(-1)[i_t]
    tol = RTOL * np.abs(d_j) + ATOL + GRAM_ULPS * np.finfo(np.float32).eps * scale
    assert (np.abs(d_t - d_j) <= tol).all(), np.abs(d_t - d_j).max()
    live = d_j < 1e30
    np.testing.assert_array_equal(i_t[live], i_j[live])
    assert (i_t[~live] == 0).all()
    assert i_t.dtype == np.int32


@pytest.mark.parametrize("Q,N", [(128, 1024), (300, 5000), (256, 2048)])
def test_knn5_plain_matches_knn_tiled_and_pallas(Q, N):
    rng = np.random.default_rng(0)
    q, r = _cloud(rng, Q), _cloud(rng, N)
    m = rng.random(N) > 0.2
    d_t, i_t = knn5_plain(torch.as_tensor(q), torch.as_tensor(r),
                          torch.as_tensor(m), _counts(Q, N), tile=1024)
    d_j, i_j = jk.knn_tiled(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                            k=5, tile=1024)
    _assert_knn_equal(q, r, d_t, i_t, d_j, i_j)
    d_p, i_p = knn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                          k=5, interpret=True)
    _assert_knn_equal(q, r, d_t, i_t, d_p, i_p)


def test_masked_columns_never_selected():
    rng = np.random.default_rng(1)
    q, r = _cloud(rng, 64), _cloud(rng, 512)
    m = np.zeros(512, bool)
    m[:7] = True
    d, i = knn5(torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(m),
                _counts(64, 512))
    assert int(i.max()) < 7
    assert torch.isfinite(d).all()


def test_fewer_live_points_than_k():
    rng = np.random.default_rng(5)
    q, r = _cloud(rng, 40), _cloud(rng, 300)
    m = np.zeros(300, bool)
    m[[3, 150, 299]] = True
    d_t, i_t = knn5_plain(torch.as_tensor(q), torch.as_tensor(r),
                          torch.as_tensor(m), _counts(40, 300), tile=128)
    d_j, i_j = jk.knn_tiled(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                            k=5, tile=128)
    _assert_knn_equal(q, r, d_t, i_t, d_j, i_j)
    assert (d_t[:, 3:] > 1e20).all() and (d_t[:, :3] < 1e20).all()


def test_all_masked_returns_big():
    rng = np.random.default_rng(2)
    q, r = _cloud(rng, 32), _cloud(rng, 256)
    d, i = knn5(torch.as_tensor(q), torch.as_tensor(r),
                torch.zeros(256, dtype=torch.bool), _counts(32, 256))
    assert (d > 1e20).all() and (i == 0).all()


def test_count_skip_matches_full_search():
    """Live-prefix operands: rows below query_count equal the full search
    exactly; rows at or past it come back as (1e30, 0)."""
    rng = np.random.default_rng(4)
    Q, N = 600, 5000
    q, r = _cloud(rng, Q), _cloud(rng, N)
    n_live_r, n_live_q = 1800, 450
    m = np.zeros(N, bool)
    m[:n_live_r] = True
    args = (torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(m))
    d_full, i_full = knn5_plain(*args, _counts(Q, N))
    d_skip, i_skip = knn5_plain(*args, _counts(n_live_q, n_live_r))
    assert torch.equal(d_skip[:n_live_q], d_full[:n_live_q])
    assert torch.equal(i_skip[:n_live_q], i_full[:n_live_q])
    assert (d_skip[n_live_q:] > 1e20).all() and (i_skip[n_live_q:] == 0).all()
    d_p, i_p = knn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                          k=5, interpret=True,
                          query_count=jnp.int32(n_live_q),
                          ref_count=jnp.int32(n_live_r))
    _assert_knn_equal(q[:n_live_q], r, d_skip[:n_live_q], i_skip[:n_live_q],
                      np.asarray(d_p)[:n_live_q], np.asarray(i_p)[:n_live_q])


def test_cpu_tensors_do_not_launch_the_kernel():
    KNN5.launches = 0
    rng = np.random.default_rng(6)
    knn5(torch.as_tensor(_cloud(rng, 16)), torch.as_tensor(_cloud(rng, 64)),
         torch.ones(64, dtype=torch.bool), _counts(16, 64))
    assert KNN5.launches == 0


@pytest.fixture(scope="module")
def scans():
    world = World.urban(seed=7)
    a = simulate_scan(world, np.zeros(3), n_azimuth=500, noise=0.01, seed=1)
    b = simulate_scan(world, np.array([0.3, 0.05, 0.0]), n_azimuth=500,
                      noise=0.01, seed=2)
    return a, b


def _ring_cloud(pts, n_rings, cap_per_ring, rng):
    """A ring-slotted cloud (ring r owns rows [r*C, r*C+C)) with holes."""
    ring = np.clip((np.arange(len(pts)) % n_rings), 0, n_rings - 1)
    xyz = np.zeros((n_rings * cap_per_ring, 3), np.float32)
    rel = np.zeros(n_rings * cap_per_ring, np.float32)
    mask = np.zeros(n_rings * cap_per_ring, bool)
    for r in range(n_rings):
        sel = pts[ring == r][:cap_per_ring]
        keep = rng.random(len(sel)) < 0.9
        rows = r * cap_per_ring + np.arange(len(sel))
        xyz[rows] = sel
        rel[rows] = r + 0.05
        mask[rows] = keep
    return xyz, rel, mask


def test_corner_correspondences_match_jax(scans):
    a, b = scans
    rng = np.random.default_rng(8)
    xyz, rel, mask = _ring_cloud(a, 16, 96, rng)
    qn = 700
    query = b[rng.permutation(len(b))[:qn]].astype(np.float32)
    qmask = rng.random(qn) < 0.95
    j = jk.corner_correspondences(jnp.asarray(query), jnp.asarray(qmask),
                                  JCloud(jnp.asarray(xyz), jnp.asarray(rel),
                                         jnp.asarray(mask)))
    t = tk.corner_correspondences(torch.as_tensor(query),
                                  torch.as_tensor(qmask),
                                  TCloud(torch.as_tensor(xyz),
                                         torch.as_tensor(rel),
                                         torch.as_tensor(mask)))
    assert int(np.asarray(j.valid).sum()) > 100
    for name in ("a_idx", "b_idx", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))


def test_surf_correspondences_grid_match_jax(scans):
    a, b = scans
    rng = np.random.default_rng(9)
    n_rings = 16
    xyz, rel, mask = _ring_cloud(a, n_rings, 256, rng)
    qn = 1000
    query = b[rng.permutation(len(b))[:qn]].astype(np.float32)
    qmask = rng.random(qn) < 0.95
    j = jk.surf_correspondences_grid(
        jnp.asarray(query), jnp.asarray(qmask),
        JCloud(jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask)), n_rings)
    t = tk.surf_correspondences_grid(
        torch.as_tensor(query), torch.as_tensor(qmask),
        TCloud(torch.as_tensor(xyz), torch.as_tensor(rel),
               torch.as_tensor(mask)), n_rings)
    assert int(np.asarray(j.valid).sum()) > 100
    for name in ("a_idx", "b_idx", "c_idx", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
