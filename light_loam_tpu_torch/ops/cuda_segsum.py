"""Ordered segment sums: CUDA kernel wrapper and plain version.

The port's voxel centroids, sorted-store reduce and refinement blocks sum
float rows into slots.  With ``index_add_`` the card adds them with
atomics, in an order that changes from run to run, so a centroid's last
bit and, through the float32 plane-fit gates, the trajectory changed from
run to run.  Every caller holds its rows sorted by slot (the voxel sums
by key) or sorts them stably first (the refinement), so ``segment_sum``
adds each slot's rows in row order instead: the same bits
on every run, and the same bits as ``index_add`` on the CPU (and
``np.add.at``), which add in index order too.  The JAX package's
counterparts are XLA scatter-adds; no Pallas kernel is replaced.

``segment_sum`` is a custom operator
(``torch.ops.light_loam_tpu_torch.segment_sum``): its CUDA kernel launches
``csrc/segsum.cu`` and its CPU kernel runs ``segment_sum_plain``; it never
falls back from one to the other.  Contract of both: values (N, C) float32
or float64, seg (N,) int64 nondecreasing with entries in [0, S], S a
static int -> (S, C): row s is the sum of the rows with seg == s, a left
fold in row order from 0; rows with seg == S (the dump slot) are dropped;
an empty slot is 0.

Under ``torch.vmap`` (the batched lanes, models/batch.py) its vmap rule
moves the lane axis to the front and runs all B lanes as one launch of the
kernel's lane axis; on the CPU it offsets lane b's slots by b·(S + 1) and
adds all lanes in one ``index_add``, which adds each slot's rows in the
same order as B single calls.  ``SEGSUM.launches`` counts one launch per
call, whatever B is.
"""

from __future__ import annotations

import ctypes

import torch

from light_loam_tpu_torch.ops.cuda_build import CudaKernel
from light_loam_tpu_torch.ops.cuda_knn import lanes_first

SEGSUM = CudaKernel(
    "segsum.cu", "segment_sum_launch",
    [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)

# segsum.cu's column groups: a thread sums one column of a slot, or up to
# WIDE_GROUP of them (the instantiations the source has)
WIDE_GROUP = 8
# threads that give every SM of an H100 (132) one block of segsum.cu's 256
FILL_THREADS = 132 * 256


def segsum_geometry(B: int, S: int, C: int) -> int:
    """Columns per thread of segsum.cu: WIDE_GROUP where B·S slots alone
    (one thread per slot and group of WIDE_GROUP columns) fill the card,
    so that each slot is searched for once; else 1 (one thread per output
    element: more threads for few slots, and a long segment's columns
    folded side by side)."""
    return WIDE_GROUP if B * S * -(-C // WIDE_GROUP) >= FILL_THREADS else 1


def segment_sum_plain(values: torch.Tensor, seg: torch.Tensor,
                      S: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``index_add`` into S + 1 slots,
    the dump slot cut off (on the CPU a left fold in index order; on the
    card atomics, whose order is not fixed)."""
    return values.new_zeros((S + 1, values.shape[1])).index_add(
        0, seg, values)[:S]


def _check(values: torch.Tensor, seg: torch.Tensor) -> None:
    if values.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"segment_sum: values have dtype {values.dtype}, "
                         "expected float32 or float64")
    if seg.dtype != torch.int64:
        raise ValueError(f"segment_sum: seg has dtype {seg.dtype}, "
                         "expected torch.int64")
    if values.dim() != 3 or tuple(seg.shape) != tuple(values.shape[:2]):
        raise ValueError(f"segment_sum: values {tuple(values.shape)} and seg "
                         f"{tuple(seg.shape)} do not match (B, N, C), (B, N)")
    if seg.device != values.device:
        raise ValueError(f"segment_sum: seg is on {seg.device}, values on "
                         f"{values.device}")
    if not (values.is_contiguous() and seg.is_contiguous()):
        raise ValueError("segment_sum: values and seg must be contiguous")


def _launch(values: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """One launch of ``csrc/segsum.cu`` over B lanes: values (B, N, C), seg
    (B, N) -> (B, S, C).  Reads nothing to the host: S and the grid come
    from the shapes."""
    _check(values, seg)
    B, N, C = values.shape
    dev = values.device
    out = torch.empty((B, S, C), dtype=values.dtype, device=dev)
    if out.numel() == 0:
        return out
    SEGSUM.launch(
        values.data_ptr(), seg.data_ptr(), B, N, S, C,
        int(values.dtype == torch.float64), segsum_geometry(B, S, C),
        out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


@torch.library.custom_op("light_loam_tpu_torch::segment_sum",
                         mutates_args=(), device_types="cpu")
def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                S: int) -> torch.Tensor:
    """Per-slot sums of rows sorted by slot (module docstring): values
    (N, C), seg (N,) int64 in [0, S] nondecreasing -> (S, C).  CUDA tensors
    launch ``csrc/segsum.cu``; CPU tensors run ``segment_sum_plain``."""
    return segment_sum_plain(values, seg, S)


@segment_sum.register_kernel("cuda")
def _segment_sum_cuda(values, seg, S):
    if values.dim() != 2:
        raise ValueError(f"segment_sum: values have shape "
                         f"{tuple(values.shape)}, expected (N, C)")
    return _launch(values[None], seg[None], S)[0]


@segment_sum.register_vmap
def _segment_sum_lanes(info, in_dims, values, seg, S):
    B = info.batch_size
    values = lanes_first(values, in_dims[0], B)
    seg = lanes_first(seg, in_dims[1], B)
    if values.is_cuda:
        return _launch(values, seg, S), 0
    _, N, C = values.shape
    offset = torch.arange(B, device=seg.device)[:, None] * (S + 1)
    sums = values.new_zeros((B * (S + 1), C)).index_add(
        0, (seg + offset).reshape(-1), values.reshape(B * N, C))
    return sums.reshape(B, S + 1, C)[:, :S].contiguous(), 0
