"""SE(3) pose and composition rules on tensors.

Counterpart of ``light_loam_tpu/core/pose.py``.  Poses are (quaternion
xyzw, translation) pairs.  Composition follows the reference's world-pose
integration (src/laserOdometry.cpp:830-831):

    t_w = t_w + q_w * t_delta ;  q_w = q_w * q_delta

and the odom→map association (src/laserMapping.cpp:113-123).  Results stay
on the device of their inputs; ``Pose.identity`` takes one explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from light_loam_tpu_torch.core import quaternion as quat


class Pose(NamedTuple):
    """Rigid transform: x_out = q * x + t."""

    q: torch.Tensor  # (..., 4) xyzw
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Pose":
        return Pose(q=quat.quat_identity(dtype, device),
                    t=torch.zeros(3, dtype=dtype, device=device))

    def matrix(self) -> torch.Tensor:
        """Homogeneous 4x4 matrix."""
        R = quat.quat_to_matrix(self.q)
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
            top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    def normalize(self) -> "Pose":
        return Pose(q=quat.quat_normalize(self.q), t=self.t)


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a.  (a∘b)(x) = a.q*(b.q*x + b.t) + a.t."""
    return Pose(
        q=quat.quat_multiply(a.q, b.q),
        t=quat.quat_rotate(a.q, b.t) + a.t,
    )


def inverse(p: Pose) -> Pose:
    qi = quat.quat_inverse(p.q)
    return Pose(q=qi, t=-quat.quat_rotate(qi, p.t))


def transform_points(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to (..., 3) points; a batch of poses (B, 4) and one set
    of points (N, 3) give (B, N, 3)."""
    q = p.q[..., None, :]
    shape = torch.broadcast_shapes(q.shape[:-1], pts.shape[:-1])
    return (quat.quat_rotate(q.expand(shape + (4,)), pts.expand(shape + (3,)))
            + p.t[..., None, :])
