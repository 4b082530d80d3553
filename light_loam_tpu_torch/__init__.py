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

# PyTorch's CPU kernels of these functions call MKL's vector math (VML),
# which sets itself up at a function's first call.  When that first call
# comes from several threads at once (a tensor large enough to be split),
# one thread may compute its share at about 12 correct bits: a float32
# sqrt then errs by up to 3e-4 relative, 1.4 cm on a 37 m distance, which
# flips vote decisions far from their threshold
# (``scripts/vml_first_call.py`` counts how often).  One call of each on a
# tensor too small to split settles the set-up before any parallel call.
for _fn in (_torch.acos, _torch.asin, _torch.atan, _torch.cos, _torch.erf,
            _torch.erfinv, _torch.erfc, _torch.exp, _torch.log,
            _torch.log10, _torch.log2, _torch.sin, _torch.sqrt, _torch.tan,
            _torch.tanh, _torch.trunc):
    for _dtype in (_torch.float32, _torch.float64):
        _fn(_torch.full((2,), 0.5, dtype=_dtype))
del _fn, _dtype

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
