"""The mapping step's plane fit (models/mapping.py ``plane_normal``,
``plane_fit_factors``) against float64 least squares.

laserMapping.cpp fits each surf point's 5 map neighbours with the plane
n · x = -1 by solving A n = -1 with a QR in double; ``tests/oracle.py``
does it with ``np.linalg.lstsq``.  The port solves it in float32 from the
neighbours' centred coordinates.  Here, on seeded sets of 5 points, noisy
strips along a scan line and exactly planar sets, 3 to 50 m from the
map's origin: the 0.2 m residual gate decides as float64 does, but within
1e-4 m of the gate, and the normal's p99 error stays under 0.01 deg.  The
normal equations of raw coordinates solved in float32 by the adjugate (the
JAX package's fit) break those bounds from 12 m on, which shows the test
can fail.  And where the total-least-squares (PCA) plane differs from the
A n = -1 solution, the port follows the latter.  The fit that the JAX
package's side of the port's whole-step twins takes in place of its own
(tests/oracle_planes.py) is float64 ``lstsq`` reached from a jitted,
vmapped JAX step.  A few seconds.
"""

import numpy as np
import pytest
import torch

from light_loam_tpu_torch.config import HDL64_SMALL
from light_loam_tpu_torch.models.mapping import (
    _solve3x3,
    plane_fit_factors,
    plane_normal,
)

torch.set_num_threads(2)

MCFG = HDL64_SMALL.mapping
GATE = MCFG.plane_fit_gate
SETS = 4000
SEED = 20


def strips(rng, n, dist, noise):
    """``n`` sets of 5 points on planes of random orientation whose patch
    centre lies ``dist`` from the origin in a random direction: spread 2 m
    along a line of the plane (a scan line) and 0.3 m across it, with
    Gaussian noise of ``noise`` m (0: exactly planar, in float64)."""
    unit = rng.normal(size=(3, n, 3))
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    toward, normal, other = unit
    along = np.cross(normal, other)
    along /= np.linalg.norm(along, axis=-1, keepdims=True)
    across = np.cross(normal, along)
    a = rng.uniform(-1.0, 1.0, size=(n, 5, 1))
    b = rng.uniform(-0.15, 0.15, size=(n, 5, 1))
    p = (dist * toward[:, None] + a * along[:, None] + b * across[:, None]
         + rng.normal(scale=noise, size=(n, 5, 3)))
    return p.astype(np.float32)


def lstsq_fit(near):
    """tests/oracle.py's fit in float64: (unit normal, largest residual)."""
    near = near.astype(np.float64)
    n = np.stack([np.linalg.lstsq(a, -np.ones(len(a)), rcond=None)[0]
                  for a in near])
    norm = np.linalg.norm(n, axis=-1)
    n_hat = n / norm[:, None]
    resid = np.abs(np.einsum("qni,qi->qn", near, n_hat) + 1.0 / norm[:, None])
    return n_hat, resid.max(-1)


def port_fit(near):
    """The factors' normals and gate decisions of ``plane_fit_factors``."""
    near = torch.from_numpy(near)
    q = near.shape[0]
    pf = plane_fit_factors(near[:, 0], torch.ones(q, dtype=torch.bool),
                           torch.zeros(q, 5), near, MCFG)
    return pf.n.double().numpy(), pf.mask.numpy()


def adjugate_fit(near):
    """The same gate from AᵀA n = -Aᵀ1 of raw coordinates, solved in
    float32 by the adjugate (the JAX package's fit)."""
    near_t = torch.from_numpy(near)
    nvec, ok = _solve3x3(torch.einsum("qni,qnj->qij", near_t, near_t),
                         -near_t.sum(dim=1))
    norm = torch.sqrt(torch.clamp((nvec * nvec).sum(-1), min=1e-20))
    n_hat = nvec / norm[:, None]
    resid = (torch.einsum("qni,qi->qn", near_t, n_hat)
             + (1.0 / norm)[:, None]).abs()
    return n_hat.double().numpy(), ((resid <= GATE).all(-1) & ok).numpy()


def angle_deg(a, b):
    """Angle between the lines of two unit normals, from the cross product
    (arccos of a dot product near 1 would round away the small ones)."""
    sin = np.linalg.norm(np.cross(a, b), axis=-1)
    return np.degrees(np.arcsin(np.clip(sin, 0.0, 1.0)))


def departures(fit, dist, noise):
    """(gate decisions that differ from float64 away from the gate, p99
    normal error in degrees) of ``fit`` over seeded sets."""
    rng = np.random.default_rng([SEED, dist, int(noise * 1000)])
    near = strips(rng, SETS, dist, noise)
    want_n, want_r = lstsq_fit(near)
    n_hat, ok = fit(near)
    clear = np.abs(want_r - GATE) > 1e-4
    flips = int(((ok != (want_r <= GATE)) & clear).sum())
    return flips, float(np.percentile(angle_deg(n_hat, want_n), 99))


KINDS = {"noisy": 0.03, "planar": 0.0}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dist", [3, 12, 30, 50])
def test_plane_fit_matches_float64_least_squares(dist, kind):
    flips, p99 = departures(port_fit, dist, KINDS[kind])
    assert flips == 0
    assert p99 < 0.01, p99


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dist", [12, 30, 50])
def test_raw_normal_equations_fail_the_same_bounds(dist, kind):
    flips, p99 = departures(adjugate_fit, dist, KINDS[kind])
    assert flips > 0 and p99 > 0.01, (flips, p99)


def jax_twin_fit(near):
    """The normals and gate decisions of the JAX package's
    ``plane_fit_factors`` inside tests/oracle_planes.py's block, jitted
    and vmapped over two halves of the sets."""
    import jax
    import jax.numpy as jnp
    from light_loam_tpu.models import mapping as jm
    from oracle_planes import oracle_planes

    half = near.shape[0] // 2
    near = jnp.asarray(near[:2 * half].reshape(2, half, 5, 3))
    with oracle_planes():
        pf = jax.jit(jax.vmap(lambda a: jm.plane_fit_factors(
            a[:, 0], jnp.ones(half, bool), jnp.zeros((half, 5)), a,
            MCFG)))(near)
    return (np.asarray(pf.n, np.float64).reshape(-1, 3),
            np.asarray(pf.mask).reshape(-1))


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dist", [3, 50])
def test_jax_twins_fit_matches_float64_least_squares(dist, kind):
    flips, p99 = departures(jax_twin_fit, dist, KINDS[kind])
    assert flips == 0
    assert p99 < 0.01, p99


def test_plane_fit_follows_least_squares_not_the_pca_plane():
    """Noisy sets near the origin: where the plane of least perpendicular
    distances (the scatter's smallest eigenvector) leans more than 0.1 deg
    from the A n = -1 solution, the port's normal is the latter's."""
    rng = np.random.default_rng(SEED)
    near = strips(rng, SETS, 3.0, 0.08)
    want_n, _ = lstsq_fit(near)
    centred = near.astype(np.float64) - near.mean(1, keepdims=True)
    pca_n = np.linalg.eigh(np.einsum("qni,qnj->qij", centred, centred))[1][
        :, :, 0]
    differ = angle_deg(pca_n, want_n) > 0.1
    assert differ.sum() > 0.5 * SETS
    n_hat, _ = port_fit(near)
    err = angle_deg(n_hat, want_n)[differ]
    assert err.max() < 0.01, err.max()
    assert (angle_deg(n_hat, pca_n)[differ] > 0.09).all()


def test_degenerate_sets_are_rejected_without_nan():
    """Collinear neighbours, a plane through the origin and five copies of
    one point: A is rank-deficient, nothing is solved and nothing is NaN."""
    line = (torch.linspace(0.0, 1.0, 5)[:, None]
            * torch.tensor([1.0, 2.0, 3.0]) + torch.tensor([10.0, 0.0, 0.0]))
    through_origin = torch.tensor([[1.0, 0.0, 0.0], [2.0, 1.0, 0.0],
                                   [3.0, 0.0, 0.0], [4.0, 1.0, 0.0],
                                   [5.0, 0.5, 0.0]])
    same = torch.full((5, 3), 7.0)
    near = torch.stack([line, through_origin, same])
    n, ok = plane_normal(near)
    assert not ok.any()
    assert torch.isfinite(n).all()
    pf = plane_fit_factors(near[:, 0], torch.ones(3, dtype=torch.bool),
                           torch.zeros(3, 5), near, MCFG)
    assert not pf.mask.any()
    assert torch.isfinite(pf.n).all() and torch.isfinite(pf.d).all()


def test_exactly_planar_set_gives_its_plane():
    """Five points of the plane x + 2y + 2z = 30, 10 m from the origin:
    n = -(1, 2, 2) / 30."""
    pts = torch.tensor([[30.0, 0.0, 0.0], [0.0, 15.0, 0.0],
                        [0.0, 0.0, 15.0], [10.0, 5.0, 5.0],
                        [2.0, 4.0, 10.0]])
    n, ok = plane_normal(pts[None])
    assert bool(ok[0])
    torch.testing.assert_close(n[0], -torch.tensor([1.0, 2.0, 2.0]) / 30.0,
                               rtol=1e-5, atol=0.0)
