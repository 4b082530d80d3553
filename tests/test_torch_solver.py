"""Residuals, analytic Jacobians and the LM solve of the PyTorch port.

Residuals agree with the JAX package to 1e-5 and Jacobians to 1e-5
relative / 1e-4 absolute (entries reach ~20 m, a few float32 ulps); in
float64 the analytic Jacobians equal ``torch.autograd``'s through the
right-tangent update q ⊗ Exp(δθ), t + δt to 1e-8; the LM pose agrees with
the JAX package's to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_loam_tpu import solver as js
from light_loam_tpu_torch import solver as ts
from light_loam_tpu_torch.core import quaternion as tq

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pose(rng):
    q = rng.normal(size=4).astype(np.float32)
    q[3] = 3.0  # a moderate rotation, away from the identity
    return (q / np.linalg.norm(q)).astype(np.float32), \
        rng.normal(size=3).astype(np.float32)


def _factors(kind, rng, n=64):
    cp = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mask = rng.random(n) < 0.9
    s = np.ones(n, np.float32)
    if kind == "edge":
        a = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        b = a + rng.normal(size=(n, 3)).astype(np.float32)
        return dict(cp=cp, a=a, b=b, s=s, weight=w, mask=mask)
    if kind == "plane":
        a, b, c = (rng.uniform(-20, 20, (n, 3)).astype(np.float32)
                   for _ in range(3))
        return dict(cp=cp, a=a, b=b, c=c, s=s, weight=w, mask=mask)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return dict(cp=cp, n=nrm, d=rng.normal(size=n).astype(np.float32),
                weight=w, mask=mask)


def _build(pkg, kind, f, to):
    f = {k: to(v) for k, v in f.items()}
    if kind == "edge":
        return pkg.EdgeFactors(**f), pkg.edge_residuals
    if kind == "plane":
        return pkg.make_plane_factors(**f), pkg.plane_residuals
    return pkg.PlaneNormFactors(**f), pkg.plane_norm_residuals


KINDS = ["edge", "plane", "plane_norm"]


@pytest.mark.parametrize("kind", KINDS)
def test_residuals_and_jacobians_match_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    q, t = _pose(rng)
    f = _factors(kind, rng)
    jf, jfn = _build(js, kind, f, jnp.asarray)
    tf, tfn = _build(ts, kind, f, torch.as_tensor)
    jr, jJ = jfn(jnp.asarray(q), jnp.asarray(t), jf)
    tr, tJ = tfn(torch.as_tensor(q), torch.as_tensor(t), tf)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_analytic_jacobians_match_autograd(kind):
    rng = np.random.default_rng(10 + KINDS.index(kind))
    q, t = _pose(rng)
    f = _factors(kind, rng, n=16)
    fac, fn = _build(ts, kind, f, lambda a: torch.as_tensor(
        a.astype(np.float64) if a.dtype == np.float32 else a))
    q0, t0 = torch.as_tensor(q, dtype=torch.float64), torch.as_tensor(
        t, dtype=torch.float64)

    def residual(delta):
        qd = tq.quat_multiply(q0, tq.quat_exp(delta[:3]))
        return fn(qd, t0 + delta[3:], fac)[0]

    auto = torch.autograd.functional.jacobian(
        residual, torch.zeros(6, dtype=torch.float64))
    _, J = fn(q0, t0, fac)
    np.testing.assert_allclose(J.numpy(), auto.numpy(), rtol=1e-8, atol=1e-8)


def test_lm_solve_matches_jax():
    rng = np.random.default_rng(20)
    q_true, t_true = _pose(rng)
    n = 300
    # planes through points of the true pose: n·(R p + t) + d = 0
    cp = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pw = np.asarray(tq.quat_rotate(torch.as_tensor(q_true)[None],
                                   torch.as_tensor(cp))) + t_true
    d = (-(nrm * pw).sum(1) + rng.normal(scale=0.02, size=n)).astype(np.float32)
    f = dict(cp=cp, n=nrm, d=d, weight=np.ones(n, np.float32),
             mask=rng.random(n) < 0.95)
    q0 = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    t0 = np.zeros(3, np.float32)
    jq, jt, jc = js.lm_solve(jnp.asarray(q0), jnp.asarray(t0), js.FactorSet(
        plane_norm=js.PlaneNormFactors(**{k: jnp.asarray(v) for k, v in f.items()})),
        n_iterations=8)
    tq_, tt, tc = ts.lm_solve(torch.as_tensor(q0), torch.as_tensor(t0), ts.FactorSet(
        plane_norm=ts.PlaneNormFactors(**{k: torch.as_tensor(v) for k, v in f.items()})),
        n_iterations=8)
    np.testing.assert_allclose(tq_.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-6)
    # and it actually moved toward the true pose
    assert np.linalg.norm(tt.numpy() - t_true) < np.linalg.norm(t_true) * 0.5


def test_lm_solve_without_factors_keeps_the_pose():
    q0 = torch.tensor([0.1, 0.0, 0.0, 0.995])
    t0 = torch.tensor([1.0, 2.0, 3.0])
    f = _factors("plane_norm", np.random.default_rng(3), n=8)
    f["mask"] = np.zeros(8, bool)
    fs = ts.FactorSet(plane_norm=ts.PlaneNormFactors(
        **{k: torch.as_tensor(v) for k, v in f.items()}))
    q, t, _ = ts.lm_solve(q0, t0, fs)
    assert torch.equal(q, q0) and torch.equal(t, t0)
