"""Graph-vote compatibility counts: CUDA kernel wrapper and plain version.

Replaces ``light_loam_tpu/ops/pallas_vote.py`` (``compat_votes_pallas``),
the hot core of the Light-LOAM vote (laserOdometry.cpp:228-252).  For
each of R chunks of K correspondences, with Gram-form Euclidean distance
matrices over src and over tgt, score = exp(−(ds − dt)² / res²); row i's
vote counts the j ≠ i with score < threshold and both ends valid.

``compat_votes`` launches ``csrc/vote.cu`` for CUDA tensors and runs
``compat_votes_plain`` for CPU tensors; it never falls back from one to
the other.  The kernel's launch geometry (``vote_geometry``) and the band
of exp arguments it decides without calling ``expf`` (``exp_band``) are
computed here, on the host.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from light_loam_tpu_torch.ops.cuda_build import CudaKernel

VOTE = CudaKernel(
    "vote.cu", "compat_votes_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_float] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)

WARPS_PER_BLOCK = 8            # vote.cu WARPS
BYTES_PER_POINT = 36           # x, y, z, |x|² of src and tgt, validity
# j points staged at once: 36 KB, under the 48 KB a launch takes without
# opting in; larger tiles lower occupancy (vote.cu)
MAX_TILE = 1024
H100_SMS = 132
EXP_BAND = 1e-5                # half-width of the band around ln(threshold)


class VoteGeometry(NamedTuple):
    """Launch geometry of vote.cu: ``rows_per_warp`` rows per warp, 8 warps
    per block, ``row_blocks`` blocks per chunk, the j side staged
    ``tile`` points at a time."""
    rows_per_warp: int
    row_blocks: int
    tile: int

    @property
    def smem_bytes(self) -> int:
        return BYTES_PER_POINT * self.tile


@functools.lru_cache(maxsize=64)
def vote_geometry(R: int, K: int, n_sm: int = H100_SMS) -> VoteGeometry:
    """Two rows per warp where that still launches a block for every SM,
    else one (on the H100, 2 beat 1 and 4 at K = 829 and 7000; at K = 163
    two would leave SMs idle)."""
    for rpw in (2, 1):
        row_blocks = -(-K // (WARPS_PER_BLOCK * rpw))
        if R * row_blocks >= n_sm:
            break
    return VoteGeometry(rpw, row_blocks, min(K, MAX_TILE))


@functools.lru_cache(maxsize=16)
def exp_band(threshold: float) -> tuple:
    """[a_lo, a_hi] around ln(threshold), rounded outwards to float32,
    outside which ``expf(a) < threshold`` is decided by ``a < a_lo`` (see
    vote.cu for the proof); the whole line where that does not hold."""
    t = float(np.float32(threshold))
    if not (math.isfinite(t) and t > 0.0 and math.log(t) >= -80.0):
        return -math.inf, math.inf
    c = math.log(t)
    lo = np.nextafter(np.float32(c - EXP_BAND), np.float32(-np.inf))
    hi = np.nextafter(np.float32(c + EXP_BAND), np.float32(np.inf))
    return float(lo), float(hi)


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
    geom = vote_geometry(R, K, _sm_count(dev.index))
    votes = torch.empty((R, K), dtype=torch.float32, device=dev)
    a_lo, a_hi = exp_band(threshold)
    VOTE.launch(
        src.data_ptr(), tgt.data_ptr(), valid.data_ptr(), R, K,
        float(threshold), float(1.0 / (resolution * resolution)), a_lo, a_hi,
        geom.rows_per_warp, geom.row_blocks, geom.tile, geom.smem_bytes,
        votes.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    return votes


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
