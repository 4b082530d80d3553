"""Levenberg-Marquardt on the pose with Huber weights, plain PyTorch.

The solve Light-LOAM hands to Ceres (HuberLoss(0.1), at most
``n_iterations`` steps): the normal equations of every factor, each
residual block weighted by rho'(|r|^2) of the Huber loss, damped by
lambda * diag(H) + 1e-9 I with lambda starting at 1e-4; a step
(q <- q * exp(dtheta), t <- t + dt) is taken only if the robust cost
0.5 * sum rho(|r|^2) falls, lambda then divided by 3, else multiplied by 4.

A factor family is (residual function of the moved points, Jacobian of
the residual by the moved point, points): the pose Jacobian follows from
d(Rp + t) = -R [p]x dtheta + dt.
"""

from __future__ import annotations

import torch

from reference.numerics import Numerics, quat_exp, quat_mul, quat_normalize, rot, skew, transform


def huber(s2: torch.Tensor, delta: float):
    d2 = delta * delta
    small = s2 <= d2
    sq = torch.sqrt(torch.clamp(s2, min=1e-24))
    return (torch.where(small, s2, 2.0 * delta * sq - d2),
            torch.where(small, torch.ones_like(s2), delta / sq))


def edge_factor(a: torch.Tensor, b: torch.Tensor):
    """Distance of the moved point from the line through a and b, as the
    3-vector (p - a) x (p - b) / |a - b|."""
    inv = 1.0 / torch.clamp(torch.linalg.norm(a - b, dim=-1), min=1e-12)

    def res(pe):
        return torch.cross(pe - a, pe - b, dim=-1) * inv[:, None]

    def jac(pe):
        return skew(b - a) * inv[:, None, None]
    return res, jac


def plane_factor(j: torch.Tensor, n: torch.Tensor, w: torch.Tensor):
    """Weighted distance of the moved point from the plane through j with
    unit normal n."""
    def res(pe):
        return (((pe - j) * n).sum(-1) * w)[:, None]

    def jac(pe):
        return (n * w[:, None])[:, None, :]
    return res, jac


def plane_norm_factor(n: torch.Tensor, d: torch.Tensor):
    """n . p + d for the plane n . x + d = 0 (|n| = 1)."""
    def res(pe):
        return ((pe * n).sum(-1) + d)[:, None]

    def jac(pe):
        return n[:, None, :]
    return res, jac


def lm(nm: Numerics, q, t, factors, n_iterations: int, delta: float):
    """factors: list of (points (n, 3), (res, jac)).  Returns (q, t)."""
    factors = [(p, f) for p, f in factors if p.shape[0] > 0]
    if not factors:
        return q, t

    def cost_at(qq, tt):
        c = q.new_zeros(())
        for p, (res, _) in factors:
            r = res(transform(nm, qq, tt, p))
            c = c + 0.5 * huber((r * r).sum(-1), delta)[0].sum()
        return c

    cost = cost_at(q, t)
    lam = 1e-4
    eye = torch.eye(6, dtype=q.dtype, device=q.device)
    for _ in range(n_iterations):
        H = q.new_zeros((6, 6))
        g = q.new_zeros(6)
        R = rot(q)
        for p, (res, jac) in factors:
            pe = transform(nm, q, t, p)
            r = res(pe)
            dr = jac(pe)                                   # (n, D, 3)
            dp = torch.cat([-nm.mm(R, skew(p)),
                            eye[3:, 3:].expand(p.shape[0], 3, 3)], dim=-1)
            J = nm.mm(dr, dp)                              # (n, D, 6)
            w = huber((r * r).sum(-1), delta)[1]
            Jw = J * w[:, None, None]
            H = H + nm.mm(Jw.reshape(-1, 6).T, J.reshape(-1, 6))
            g = g + nm.mm(Jw.reshape(-1, 6).T, r.reshape(-1, 1))[:, 0]
        damped = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye
        try:
            step = -torch.linalg.solve(damped, g)
        except RuntimeError:
            step = torch.zeros_like(g)
        if not bool(torch.isfinite(step).all()):
            step = torch.zeros_like(g)
        q_new = quat_normalize(quat_mul(q, quat_exp(step[:3])))
        t_new = t + step[3:]
        new_cost = cost_at(q_new, t_new)
        if bool(new_cost < cost):
            q, t, cost = q_new, t_new, new_cost
            lam /= 3.0
        else:
            lam *= 4.0
    return q, t
