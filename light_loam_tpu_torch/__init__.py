"""light_loam_tpu_torch — the Light-LOAM SLAM engine in PyTorch and CUDA.

A port of ``light_loam_tpu`` (the JAX package beside it, which stays the
reference) to PyTorch, with hand-written CUDA C++ kernels for NVIDIA
Hopper (``sm_90a``) in place of the JAX package's two Pallas kernels:

  * ``ops/cuda_knn.py`` + ``csrc/knn.cu``: the mapping stage's streamed 5-NN;
  * ``ops/cuda_vote.py`` + ``csrc/vote.cu``: the graph-vote compatibility
    counts.

Layout and names mirror the JAX package (``config``, ``core``, ``ops``,
``solver``, ``models``, ``utils``) so each function's counterpart is easy
to find.  Everything runs eagerly on an explicit ``device``; a kernel
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors.
"""

import torch as _torch

# Distances are formed in Gram form, ‖a‖² + ‖b‖² − 2·a·b, on world
# coordinates of up to hundreds of metres: the cross terms reach ~1e4 m².
# TF32 keeps 10 mantissa bits (~5e-4 relative), i.e. several m² of error,
# which is above the mapping 5-NN gate (knn_sq_gate = 1 m²) and the vote's
# 1 m length scale.  So every float32 matmul and convolution stays full
# float32, and a run on a CUDA device refuses LLT_MATMUL_PRECISION (the JAX
# package's tier switch) at any other value than "highest"
# (models/pipeline.py resolve_device) until an accuracy gate shows a
# cheaper tier is safe.  The check waits for the device: the JAX package
# may share the process with another tier, and a CPU has no cheaper one.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from light_loam_tpu_torch.config import (  # noqa: E402
    HDL32,
    HDL64_KITTI,
    HDL64_SMALL,
    M2DGR_VLP32C,
    VLP16,
    MappingConfig,
    OdometryConfig,
    PipelineConfig,
    ScanConfig,
)

__version__ = "0.1.0"

__all__ = [
    "ScanConfig",
    "OdometryConfig",
    "MappingConfig",
    "PipelineConfig",
    "HDL64_KITTI",
    "HDL64_SMALL",
    "VLP16",
    "HDL32",
    "M2DGR_VLP32C",
    "__version__",
]
