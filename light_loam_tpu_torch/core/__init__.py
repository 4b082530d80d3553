from light_loam_tpu_torch.core.quaternion import (
    quat_identity,
    quat_multiply,
    quat_conjugate,
    quat_inverse,
    quat_normalize,
    quat_rotate,
    quat_slerp_identity,
    quat_exp,
    quat_log,
    quat_to_matrix,
    matrix_to_quat,
)
from light_loam_tpu_torch.core.pose import (
    Pose,
    compose,
    inverse,
    transform_points,
)

__all__ = [
    "quat_identity",
    "quat_multiply",
    "quat_conjugate",
    "quat_inverse",
    "quat_normalize",
    "quat_rotate",
    "quat_slerp_identity",
    "quat_exp",
    "quat_log",
    "quat_to_matrix",
    "matrix_to_quat",
    "Pose",
    "compose",
    "inverse",
    "transform_points",
]
