"""The mapping stage's streamed 5-NN: CUDA kernel wrapper and plain version.

Replaces ``light_loam_tpu/ops/pallas_knn.py`` (``knn_pallas``), the
nearestKSearch(5) of the scan-to-map loop (laserMapping.cpp:1882,1948).
``knn5`` launches ``csrc/knn.cu`` for CUDA tensors and runs ``knn5_plain``
for CPU tensors; it never falls back from one to the other.

Contract of both, the JAX package's ``knn_pallas`` with its counts:

  * returns (sq_dists (Q, 5) float32 ascending, indices (Q, 5) int32);
  * ties go to the lower reference index;
  * ``counts`` is a device int32 pair [query_count, ref_count]: rows at or
    past query_count come back as (1e30, 0) and references at or past
    ref_count are not visited (callers guarantee they are masked);
  * a slot with no live neighbour left holds (1e30, 0).  The JAX package's
    ``knn_tiled`` may carry another index there; every consumer gates those
    slots out by distance (models/mapping.py).
"""

from __future__ import annotations

import ctypes

import torch

from light_loam_tpu_torch.ops.cuda_build import CudaKernel
from light_loam_tpu_torch.ops.knn import BIG, pairwise_sq_dist

K = 5

KNN5 = CudaKernel(
    "knn.cu", "knn5_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
)


def _select_k(d: torch.Tensor, idx: torch.Tensor, k: int):
    """k ascending (value, index) pairs per row by k argmin passes; ties go
    to the first column, like ``lax.top_k`` in the JAX package.  A picked
    entry becomes +inf, so it is never picked again, even among 1e30s."""
    d = d.clone()
    vals, idxs = [], []
    for _ in range(k):
        v, j = torch.min(d, dim=1, keepdim=True)
        vals.append(v)
        idxs.append(torch.gather(idx, 1, j))
        d.scatter_(1, j, float("inf"))
    return torch.cat(vals, 1), torch.cat(idxs, 1)


def knn5_plain(query: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
               counts: torch.Tensor, tile: int = 4096):
    """The kernel's plain PyTorch version: ``knn_tiled`` of the JAX package
    (streamed over reference tiles, so no (Q, N) block is ever whole) plus
    the counts.  The counts mask rows and columns instead of shortening the
    sweep, which keeps it free of host syncs."""
    Q, N = query.shape[0], ref.shape[0]
    dev = query.device
    counts = counts.to(torch.int64)
    live_col = mask & (torch.arange(N, device=dev) < counts[1])
    best_d = torch.full((Q, K), BIG, device=dev)
    best_i = torch.zeros((Q, K), dtype=torch.int64, device=dev)
    big = torch.full((), BIG, device=dev)
    for sl in range(0, N, tile):
        chunk = ref[sl:sl + tile]
        d = torch.where(live_col[None, sl:sl + tile],
                        pairwise_sq_dist(query, chunk), big)
        gcol = torch.arange(sl, sl + chunk.shape[0], device=dev).expand(Q, -1)
        cd, ci = _select_k(d, gcol, K)
        # running side first: it wins ties, as in knn_tiled's merge
        best_d, best_i = _select_k(torch.cat([best_d, cd], 1),
                                   torch.cat([best_i, ci], 1), K)
    dead = (torch.arange(Q, device=dev) >= counts[0])[:, None]
    best_d = torch.where(dead, big, best_d)
    best_i = torch.where(dead, torch.zeros_like(best_i), best_i)
    return best_d, best_i.to(torch.int32)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"knn5: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"knn5: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"knn5: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"knn5: {name} must be contiguous")


def knn5(query: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
         counts: torch.Tensor):
    """5-NN of each query among the masked-in references (module
    docstring).  query (Q, 3) f32, ref (N, 3) f32, mask (N,) bool, counts
    (2,) int32.  CUDA tensors launch ``csrc/knn.cu``; CPU tensors run
    ``knn5_plain``."""
    if not query.is_cuda:
        return knn5_plain(query, ref, mask, counts)
    Q, N = query.shape[0], ref.shape[0]
    dev = query.device
    _check("query", query, torch.float32, (Q, 3), dev)
    _check("ref", ref, torch.float32, (N, 3), dev)
    _check("mask", mask, torch.bool, (N,), dev)
    _check("counts", counts, torch.int32, (2,), dev)
    out_d = torch.empty((Q, K), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, K), dtype=torch.int32, device=dev)
    KNN5.launch(
        query.data_ptr(), ref.data_ptr(), mask.data_ptr(), counts.data_ptr(),
        Q, N, out_d.data_ptr(), out_i.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return out_d, out_i
