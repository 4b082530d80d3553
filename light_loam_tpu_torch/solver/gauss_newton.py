"""Levenberg-Marquardt on SE(3) with Huber IRLS.

Counterpart of ``light_loam_tpu/solver/gauss_newton.py`` (single device):
replaces the reference's per-frame Ceres solves (HuberLoss(0.1) +
EigenQuaternionManifold, max_num_iterations=4;
src/laserOdometry.cpp:475-482,819-826, src/laserMapping.cpp:1864-1872,
2080-2087).  The 6-dof normal equations are accumulated over all factors;
each residual block is scaled by sqrt(ρ'(‖r‖²)), ρ the Huber loss, and the
cost is 0.5 Σ ρ(‖r‖²).  The damped 6×6 system is solved by Cholesky
(``cholesky_ex``, which reports failure in a tensor instead of raising, so
the loop never waits on the device).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from light_loam_tpu_torch.core import quaternion as quat
from light_loam_tpu_torch.solver import residuals as res


class FactorSet(NamedTuple):
    """The factor families of one solve; any entry may be None.

    edge/plane/plane_norm are the live-path families; edge_scalar,
    plane_component and distance are the reference's latent factor types
    (see solver.residuals)."""

    edge: Optional[res.EdgeFactors] = None
    plane: Optional[res.PlaneFactors] = None
    plane_norm: Optional[res.PlaneNormFactors] = None
    edge_scalar: Optional[res.EdgeScalarFactors] = None
    plane_component: Optional[res.PlaneComponentFactors] = None
    distance: Optional[res.DistanceFactors] = None


# (field name, residual fn) registry driving the accumulation loops
_FAMILIES = (
    ("edge", res.edge_residuals),
    ("plane", res.plane_residuals),
    ("plane_norm", res.plane_norm_residuals),
    ("edge_scalar", res.edge_scalar_residuals),
    ("plane_component", res.plane_component_residuals),
    ("distance", res.distance_residuals),
)


def _huber_rho(s2: torch.Tensor, delta: float):
    """Ceres HuberLoss: ρ(s) = s for s ≤ δ², else 2δ√s − δ²; returns
    (ρ(s), ρ'(s))."""
    d2 = delta * delta
    small = s2 <= d2
    sqrt_s = torch.sqrt(torch.clamp(s2, min=1e-24))
    rho = torch.where(small, s2, 2.0 * delta * sqrt_s - d2)
    drho = torch.where(small, torch.ones_like(s2), delta / sqrt_s)
    return rho, drho


def _accumulate(r, J, mask, delta):
    """Robustified contributions of one factor family.

    r: (N, D), J: (N, D, 6), mask: (N,) → (H (6,6), g (6,), cost)."""
    m = mask.to(r.dtype)
    rho, w = _huber_rho(torch.sum(r * r, dim=-1), delta)
    Jw = J * (w * m)[:, None, None]
    H = torch.einsum("nid,nie->de", Jw, J)
    g = torch.einsum("nid,ni->d", Jw, r)
    return H, g, 0.5 * torch.sum(rho * m)


def _residuals_all(q, t, factors: FactorSet, delta):
    H = q.new_zeros((6, 6))
    g = q.new_zeros((6,))
    cost = q.new_zeros(())
    for name, res_fn in _FAMILIES:
        fac = getattr(factors, name)
        if fac is not None:
            r, J = res_fn(q, t, fac)
            h, gg, c = _accumulate(r, J, fac.mask, delta)
            H, g, cost = H + h, g + gg, cost + c
    return H, g, cost


def _cost_only(q, t, factors: FactorSet, delta):
    cost = q.new_zeros(())
    for name, res_fn in _FAMILIES:
        fac = getattr(factors, name)
        if fac is not None:
            r, _ = res_fn(q, t, fac)
            rho, _d = _huber_rho(torch.sum(r * r, dim=-1), delta)
            cost = cost + 0.5 * torch.sum(rho * fac.mask)
    return cost


def lm_solve(
    q0: torch.Tensor,
    t0: torch.Tensor,
    factors: FactorSet,
    n_iterations: int = 4,
    huber_delta: float = 0.1,
    lambda_init: float = 1e-4,
    min_factors: int = 1,
):
    """Run ``n_iterations`` LM steps from (q0, t0).

    Damped normal equations (H + λ·diag(H)) δ = −g; a step is accepted only
    if the robust cost decreases (λ ×1/3 on accept, ×4 on reject).  A
    failed or non-finite solve takes a zero step.  With fewer than
    ``min_factors`` active factors the pose is returned unchanged."""
    n_active = q0.new_zeros(())
    for f in factors:
        if f is not None:
            n_active = n_active + torch.sum(f.mask.to(torch.float32))
    solvable = n_active >= min_factors
    eye = torch.eye(6, dtype=q0.dtype, device=q0.device)

    q, t = q0, t0
    lam = torch.full((), lambda_init, dtype=q0.dtype, device=q0.device)
    cost = _cost_only(q0, t0, factors, huber_delta)
    for _ in range(n_iterations):
        H, g, _ = _residuals_all(q, t, factors, huber_delta)
        damped = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye
        L, info = torch.linalg.cholesky_ex(damped)
        delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
        ok = (info == 0) & torch.isfinite(delta).all()
        delta = torch.where(ok, delta, torch.zeros_like(delta))
        q_new = quat.quat_normalize(quat.quat_multiply(q, quat.quat_exp(delta[:3])))
        t_new = t + delta[3:]
        new_cost = _cost_only(q_new, t_new, factors, huber_delta)
        accept = (new_cost < cost) & solvable
        q = torch.where(accept, q_new, q)
        t = torch.where(accept, t_new, t)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * (1.0 / 3.0), lam * 4.0)
    return q, t, cost
