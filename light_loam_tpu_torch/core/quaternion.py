"""Quaternion algebra on (..., 4) tensors in **(x, y, z, w)** order.

Counterpart of ``light_loam_tpu/core/quaternion.py``: the xyzw layout
mirrors the reference's Ceres parameter block (``para_q[4] = {x, y, z,
w}``, src/laserOdometry.cpp:61-64), so poses cross between the packages
without reshuffling.  All functions broadcast over leading dimensions and
keep the dtype and device of their inputs.
"""

from __future__ import annotations

import torch


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 (rotation q2 followed by q1)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse for (approximately) unit quaternions == conjugate."""
    return quat_conjugate(q)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p (..., 3) by unit quaternion q (..., 4):
    p' = p + 2 w (v x p) + 2 v x (v x p)."""
    v, w = q[..., :3], q[..., 3:4]
    v = v.expand(p.shape)
    c1 = _cross(v, p)
    c2 = _cross(v, c1)
    return p + 2.0 * (w * c1 + c2)


def quat_slerp_identity(q: torch.Tensor, s) -> torch.Tensor:
    """slerp(I, q, s): interpolate from identity toward q by fraction s
    (Eigen's ``Quaterniond::Identity().slerp(s, q)``,
    src/laserOdometry.cpp:86); lerp + normalize for tiny angles."""
    s = torch.as_tensor(s, dtype=q.dtype, device=q.device)
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    sign = torch.where(w < 0, -1.0, 1.0).to(q.dtype)
    theta = torch.arccos(torch.clamp(w.abs(), 0.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    c_id = torch.where(small, 1.0 - s, torch.sin((1.0 - s) * theta) / safe_sin)
    c_q = torch.where(small, s, torch.sin(s * theta) / safe_sin)
    ident = torch.cat([torch.zeros_like(q[..., :3]),
                       torch.ones_like(q[..., 3:])], dim=-1)
    out = c_id[..., None] * ident + (c_q * sign)[..., None] * q
    return quat_normalize(out)


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector phi (..., 3) -> unit quaternion,
    the manifold ⊞ used in place of Ceres's EigenQuaternionManifold
    (src/laserOdometry.cpp:476-477)."""
    angle = torch.sqrt(torch.sum(phi * phi, dim=-1, keepdim=True) + 1e-24)
    half = 0.5 * angle
    small = angle < 1e-8
    safe = torch.where(small, torch.ones_like(angle), angle)
    k = torch.where(small, torch.full_like(angle, 0.5), torch.sin(half) / safe)
    return torch.cat([k * phi, torch.cos(half)], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))
