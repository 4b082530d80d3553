"""Closed-form batched symmetric 3×3 eigendecomposition.

Counterpart of ``light_loam_tpu/ops/eig3.py``: replaces the reference's
per-point Eigen::SelfAdjointEigenSolver in the mapping corner loop
(src/laserMapping.cpp:1905-1911) with the trigonometric (Cardano) solve.
Eigenvalues come back ascending, plus the unit eigenvector of the largest
one (the line direction, the only one the reference uses).
"""

from __future__ import annotations

import math

import torch


def eigh3x3(A: torch.Tensor):
    """A: (..., 3, 3) symmetric.  Returns (eigvals (..., 3) ascending,
    v_max (..., 3) unit eigenvector of the largest eigenvalue)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))

    # det(B/p) / 2 with B = A - qI
    db = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(db / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lam2 = q + 2.0 * p * torch.cos(phi)                        # largest
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam1 = 3.0 * q - lam2 - lam0
    vals = torch.stack([lam0, lam1, lam2], dim=-1)

    # eigenvector of lam2: the largest cross product of rows of (A − λ2 I)
    r0 = torch.stack([a00 - lam2, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam2, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam2], dim=-1)
    cand = torch.stack([torch.linalg.cross(r0, r1, dim=-1),
                        torch.linalg.cross(r0, r2, dim=-1),
                        torch.linalg.cross(r1, r2, dim=-1)], dim=-2)
    norms = torch.sum(cand * cand, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    norm = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True),
                                  min=1e-30))
    # degenerate (repeated λ): e_x — callers gate such cases out via the
    # λ2 > 3 λ1 line test anyway
    good = norm[..., 0] > 1e-12
    ex = torch.cat([torch.ones_like(v[..., :1]),
                    torch.zeros_like(v[..., 1:])], dim=-1)
    return vals, torch.where(good[..., None], v / norm, ex)
