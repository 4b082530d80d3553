"""Batched LiDAR registration residuals with analytic SE(3) Jacobians.

Counterpart of ``light_loam_tpu/solver/residuals.py`` (the Ceres cost
functors of src/lidarFactor.hpp) for the three factor types the main path
uses.  Each residual function returns (r, J) with J the Jacobian with
respect to the 6-dim right tangent perturbation [δθ, δt]:

    q(δ) = q0 ⊗ Exp(δθ),  t(δ) = t0 + δt
    p' = R(q) p + t  ⇒  ∂p'/∂δθ = -R0 [p]×,  ∂p'/∂δt = I

Factor weights are baked into the residual and the Jacobian, as the
reference's LidarPlaneFactor_modify multiplies its residual by the vote
weight (lidarFactor.hpp:233).  The remaining factor types
(EdgeScalarFactors, PlaneComponentFactors, DistanceFactors) are not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from light_loam_tpu_torch.core import quaternion as quat


class EdgeFactors(NamedTuple):
    """Point-to-line factors (lidarFactor.hpp:9-52):
    residual (3-dim) = ((p' - a) × (p' - b)) / ‖a - b‖."""

    cp: torch.Tensor      # (N, 3) current points
    a: torch.Tensor       # (N, 3) line point 1
    b: torch.Tensor       # (N, 3) line point 2
    s: torch.Tensor       # (N,)  undistortion fraction
    weight: torch.Tensor  # (N,)
    mask: torch.Tensor    # (N,)  bool


class PlaneFactors(NamedTuple):
    """Point-to-plane via a precomputed triangle normal
    (LidarPlaneFactor_modify, lidarFactor.hpp:203-251):
    residual (1-dim) = ((p' - j) · n̂) * weight."""

    cp: torch.Tensor      # (N, 3)
    j: torch.Tensor       # (N, 3) plane anchor
    n: torch.Tensor       # (N, 3) unit normal (precomputed)
    s: torch.Tensor       # (N,)
    weight: torch.Tensor  # (N,)
    mask: torch.Tensor    # (N,)


class PlaneNormFactors(NamedTuple):
    """Plane factors from a fitted (n, d) (LidarPlaneNormFactor,
    lidarFactor.hpp:253-285): residual = n · p_w + d."""

    cp: torch.Tensor      # (N, 3)
    n: torch.Tensor       # (N, 3) unit normal
    d: torch.Tensor       # (N,)  negative_OA_dot_norm
    weight: torch.Tensor  # (N,)
    mask: torch.Tensor    # (N,)


def make_plane_factors(cp, a, b, c, s, weight, mask) -> PlaneFactors:
    """PlaneFactors from a point triangle, normalizing (j-l)×(j-m) once
    like the reference constructor."""
    n = torch.linalg.cross(a - b, a - c, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    return PlaneFactors(cp=cp, j=a, n=n, s=s, weight=weight, mask=mask)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N, 3, 3) cross-product matrices [v]×."""
    zero = torch.zeros_like(v[:, 0])
    return torch.stack(
        [
            torch.stack([zero, -v[:, 2], v[:, 1]], dim=-1),
            torch.stack([v[:, 2], zero, -v[:, 0]], dim=-1),
            torch.stack([-v[:, 1], v[:, 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _transform_with_jac(pose_q, pose_t, cp, s):
    """p' = slerp(I, q, s) cp + s·t and its Jacobian wrt [δθ, δt].

    Returns p' (N,3) and Jp (N,3,6)."""
    qb = pose_q.expand(cp.shape[:1] + (4,))
    qs = quat.quat_slerp_identity(qb, s)
    p = quat.quat_rotate(qs, cp) + s[:, None] * pose_t[None, :]
    R = quat.quat_to_matrix(qs)
    Jrot = -torch.bmm(R, _skew(cp)) * s[:, None, None]
    Jt = torch.eye(3, dtype=cp.dtype, device=cp.device).expand(
        Jrot.shape) * s[:, None, None]
    return p, torch.cat([Jrot, Jt], dim=-1)


def edge_residuals(pose_q, pose_t, f: EdgeFactors):
    """(r, J): r (N,3), J (N,3,6)."""
    p, Jp = _transform_with_jac(pose_q, pose_t, f.cp, f.s)
    u = p - f.a
    v = p - f.b
    de = f.a - f.b
    inv_norm = 1.0 / torch.clamp(
        torch.linalg.vector_norm(de, dim=-1, keepdim=True), min=1e-12)
    r = torch.linalg.cross(u, v, dim=-1) * inv_norm
    # d(u×v)/dp' = [b - a]×  (since u - v = b - a)
    dr_dp = _skew(f.b - f.a) * inv_norm[..., None]
    J = torch.bmm(dr_dp, Jp)
    w = (f.weight * f.mask).to(p.dtype)
    return r * w[:, None], J * w[:, None, None]


def plane_residuals(pose_q, pose_t, f: PlaneFactors):
    """(r, J): r (N,1), J (N,1,6)."""
    p, Jp = _transform_with_jac(pose_q, pose_t, f.cp, f.s)
    r = torch.sum((p - f.j) * f.n, dim=-1, keepdim=True)
    J = torch.bmm(f.n[:, None, :], Jp)
    w = (f.weight * f.mask).to(p.dtype)
    return r * w[:, None], J * w[:, None, None]


def plane_norm_residuals(pose_q, pose_t, f: PlaneNormFactors):
    """(r, J): r (N,1), J (N,1,6)."""
    s = torch.ones(f.cp.shape[0], dtype=f.cp.dtype, device=f.cp.device)
    p, Jp = _transform_with_jac(pose_q, pose_t, f.cp, s)
    r = (torch.sum(p * f.n, dim=-1) + f.d)[:, None]
    J = torch.bmm(f.n[:, None, :], Jp)
    w = (f.weight * f.mask).to(p.dtype)
    return r * w[:, None], J * w[:, None, None]
