"""Graph-vote compatibility counts: CUDA kernel wrapper and plain version.

Replaces ``light_loam_tpu/ops/pallas_vote.py`` (``compat_votes_pallas``),
the hot core of the Light-LOAM vote (laserOdometry.cpp:228-252).  For
each of R chunks of K correspondences, with Gram-form Euclidean distance
matrices over src and over tgt, score = exp(−(ds − dt)² / res²); row i's
vote counts the j ≠ i with score < threshold and both ends valid.

``compat_votes`` launches ``csrc/vote.cu`` for CUDA tensors and runs
``compat_votes_plain`` for CPU tensors; it never falls back from one to
the other.
"""

from __future__ import annotations

import ctypes

import torch

from light_loam_tpu_torch.ops.cuda_build import CudaKernel

VOTE = CudaKernel(
    "vote.cu", "compat_votes_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_void_p],
)


def compat_scores(src: torch.Tensor, tgt: torch.Tensor,
                  resolution: float) -> torch.Tensor:
    """(R, K, K) compatibility matrix per chunk, distances in Gram form
    (exact float32 matmuls: TF32 cross terms at ~100 m coordinates would
    corrupt metre-scale distances)."""
    def dists(p):
        n2 = torch.sum(p * p, dim=-1)
        d2 = n2[:, :, None] + n2[:, None, :] - 2.0 * torch.bmm(
            p, p.transpose(1, 2))
        return torch.sqrt(torch.clamp(d2, min=0.0))

    gap = dists(src) - dists(tgt)
    return torch.exp(-(gap * gap) / (resolution * resolution))


def compat_votes_plain(src: torch.Tensor, tgt: torch.Tensor,
                       valid: torch.Tensor, threshold: float = 0.96,
                       resolution: float = 1.0) -> torch.Tensor:
    """The kernel's plain PyTorch version (the JAX package's XLA votes,
    ops/graphvote.py simple_vote): (R, K) float32 vote counts."""
    K = src.shape[1]
    scores = compat_scores(src, tgt, resolution)
    eye = torch.eye(K, dtype=torch.bool, device=src.device)[None]
    pair_ok = (valid[:, :, None] * valid[:, None, :]) > 0
    incompat = (scores < threshold) & pair_ok & ~eye
    return incompat.to(torch.float32).sum(-1)


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"compat_votes: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"compat_votes: {name} has dtype {t.dtype}, "
                         "expected torch.float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"compat_votes: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"compat_votes: {name} must be contiguous")


def compat_votes(src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                 threshold: float = 0.96,
                 resolution: float = 1.0) -> torch.Tensor:
    """Incompatibility votes per chunked correspondence: src, tgt (R, K, 3)
    f32, valid (R, K) f32 -> (R, K) f32 counts.  CUDA tensors launch
    ``csrc/vote.cu``; CPU tensors run ``compat_votes_plain``."""
    if not src.is_cuda:
        return compat_votes_plain(src, tgt, valid, threshold, resolution)
    R, K = valid.shape
    dev = src.device
    _check("src", src, (R, K, 3), dev)
    _check("tgt", tgt, (R, K, 3), dev)
    _check("valid", valid, (R, K), dev)
    votes = torch.empty((R, K), dtype=torch.float32, device=dev)
    VOTE.launch(
        src.data_ptr(), tgt.data_ptr(), valid.data_ptr(), R, K,
        float(threshold), float(1.0 / (resolution * resolution)),
        votes.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    return votes
