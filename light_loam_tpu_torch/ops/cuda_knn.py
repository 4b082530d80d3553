"""The mapping stage's streamed 5-NN: CUDA kernel wrapper and plain version.

Replaces ``light_loam_tpu/ops/pallas_knn.py`` (``knn_pallas``), the
nearestKSearch(5) of the scan-to-map loop (laserMapping.cpp:1882,1948).
``knn5`` is a custom operator (``torch.ops.light_loam_tpu_torch.knn5``): its
CUDA kernel launches ``csrc/knn.cu`` and its CPU kernel runs ``knn5_plain``;
it never falls back from one to the other.

Under ``torch.vmap`` (the batched lanes, models/batch.py) its vmap rule, the
counterpart of ``_knn_fn``'s ``custom_vmap`` rule, moves the lane axis to
the front, broadcasts operands that have none, and runs all B lanes as one
launch of the kernel's lane axis: (B, Q, 3) queries, (B, N, 3) references,
(B, N) masks and (B, 2) counts.  On the CPU it runs the plain version per
lane.  ``KNN5.launches`` counts one launch per call, whatever B is.

Contract of both, the JAX package's ``knn_pallas`` with its counts:

  * returns (sq_dists (Q, 5) float32 ascending, indices (Q, 5) int32);
  * ties go to the lower reference index;
  * ``counts`` is a device int32 pair [query_count, ref_count]: rows at or
    past query_count come back as (1e30, 0) and references at or past
    ref_count are not visited (callers guarantee they are masked);
  * a slot with no live neighbour left holds (1e30, 0).  The JAX package's
    ``knn_tiled`` may carry another index there; every consumer gates those
    slots out by distance (models/mapping.py).

The kernel splits the live reference range into segments across blocks and
merges the segments' lists; its launch geometry (``knn_geometry``) is
computed here, on the host, from the capacities (Q, N) alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from light_loam_tpu_torch.ops.cuda_build import CudaKernel
from light_loam_tpu_torch.ops.knn import BIG, knn_tiled

K = 5

KNN5 = CudaKernel(
    "knn.cu", "knn5_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_void_p],
)

# knn.cu's QB and MAX_SEGMENTS: these must match the kernel source
# (tests/test_torch_knn.py reads them from it)
QUERIES_PER_BLOCK = 128
MAX_SEGMENTS = 32
MIN_SEGMENT = 256          # references per segment at capacity, at least


class KnnGeometry(NamedTuple):
    """Launch geometry of knn.cu: ``query_blocks`` blocks of
    QUERIES_PER_BLOCK queries (one a thread), each against every one of
    ``segments`` reference segments."""
    query_blocks: int
    segments: int

    @property
    def blocks(self) -> int:
        return self.query_blocks * self.segments


@functools.lru_cache(maxsize=64)
def knn_geometry(Q: int, N: int) -> KnnGeometry:
    """The most segments, a power of two up to MAX_SEGMENTS, that leave
    MIN_SEGMENT references each at capacity.  On the H100, 32 segments
    were the fastest of the sweep at both mapping shapes (PERF.md)."""
    segments = 1
    while segments * 2 <= MAX_SEGMENTS and N // (segments * 2) >= MIN_SEGMENT:
        segments *= 2
    return KnnGeometry(-(-Q // QUERIES_PER_BLOCK), segments)


def segment_length(rc: int, segments: int) -> int:
    """References per segment at live count ``rc`` (knn.cu's
    segment_length): segment s covers [s * length, min((s + 1) * length,
    rc))."""
    return -(-rc // segments)


def knn5_plain(query: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
               counts: torch.Tensor, tile: int = 4096):
    """The kernel's plain PyTorch version: ``ops/knn.py`` ``knn_tiled``
    (streamed over reference tiles, so no (Q, N) block is ever whole) plus
    the counts.  The counts mask rows and columns instead of shortening the
    sweep, which keeps it free of host syncs."""
    Q, N = query.shape[0], ref.shape[0]
    dev = query.device
    counts = counts.to(torch.int64)
    live_col = mask & (torch.arange(N, device=dev) < counts[1])
    best_d, best_i = knn_tiled(query, ref, live_col, K, tile=tile)
    dead = (torch.arange(Q, device=dev) >= counts[0])[:, None]
    return (torch.where(dead, torch.full((), BIG, device=dev), best_d),
            torch.where(dead, torch.zeros_like(best_i), best_i))


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


def _launch(query: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
            counts: torch.Tensor):
    """One launch of ``csrc/knn.cu`` over B lanes: query (B, Q, 3), ref
    (B, N, 3), mask (B, N), counts (B, 2) -> (B, Q, 5) f32, (B, Q, 5)
    i32."""
    B, Q, N = query.shape[0], query.shape[1], ref.shape[1]
    dev = query.device
    _check("query", query, torch.float32, (B, Q, 3), dev)
    _check("ref", ref, torch.float32, (B, N, 3), dev)
    _check("mask", mask, torch.bool, (B, N), dev)
    _check("counts", counts, torch.int32, (B, 2), dev)
    geom = knn_geometry(Q, N)
    out_d = torch.empty((B, Q, K), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, Q, K), dtype=torch.int32, device=dev)
    part_d = torch.empty((B, geom.segments, Q, K), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((B, geom.segments, Q, K), dtype=torch.int32,
                         device=dev)
    KNN5.launch(
        query.data_ptr(), ref.data_ptr(), mask.data_ptr(), counts.data_ptr(),
        B, Q, N, geom.segments,
        part_d.data_ptr(), part_i.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return out_d, out_i


@torch.library.custom_op("light_loam_tpu_torch::knn5", mutates_args=(),
                         device_types="cpu")
def knn5(query: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
         counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """5-NN of each query among the masked-in references (module
    docstring).  query (Q, 3) f32, ref (N, 3) f32, mask (N,) bool, counts
    (2,) int32.  CUDA tensors launch ``csrc/knn.cu``; CPU tensors run
    ``knn5_plain``."""
    return knn5_plain(query, ref, mask, counts)


@knn5.register_kernel("cuda")
def _knn5_cuda(query, ref, mask, counts):
    if query.dim() != 2:
        raise ValueError(f"knn5: query has shape {tuple(query.shape)}, "
                         "expected (Q, 3)")
    d, i = _launch(query[None], ref[None], mask[None], counts[None])
    return d[0], i[0]


def lanes_first(x: torch.Tensor, dim, lanes: int) -> torch.Tensor:
    """An operand of a vmap rule with its lane axis in front, contiguous; an
    operand without one is broadcast to every lane (``ensure`` in the JAX
    package's rules)."""
    if dim is None:
        x = x.expand((lanes,) + tuple(x.shape))
    else:
        x = x.movedim(dim, 0)
    return x.contiguous()


@knn5.register_vmap
def _knn5_lanes(info, in_dims, query, ref, mask, counts):
    lanes = [lanes_first(x, d, info.batch_size)
             for x, d in zip((query, ref, mask, counts), in_dims)]
    if lanes[0].is_cuda:
        return _launch(*lanes), (0, 0)
    outs = [knn5_plain(*lane) for lane in zip(*lanes)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0, 0)
