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
import functools

import torch

from light_loam_tpu_torch.ops.cuda_build import CudaKernel
from light_loam_tpu_torch.ops.cuda_knn import lanes_first

SEGSUM = CudaKernel(
    "segsum.cu", "segment_sum_launch",
    [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
       ctypes.c_void_p],
)

# segsum.cu's block size, the most rows a tile has (ROWS_PER_THREAD a
# thread), its shared-memory budget for the value rows it stages at a time
# and the running sums of a segment that runs past the tile, the most slot
# ids a thread loads in a search round, and the blocks an SM holds
THREADS = 256
TILE_ROWS = 512
TILE_BYTES = 32768
PROBES_MAX = 8
MIN_BLOCKS = 5
# one wave of the kernel on an H100 (132 SMs)
WAVE = 132 * MIN_BLOCKS
# the fewest rows a tile has where the row width allows more
MIN_TILE_ROWS = 64


def search_rounds(N: int, probes: int) -> int:
    """Rounds of segsum.cu's search for a lane's live count among N rows,
    at most: each round cuts the n rows left to ceil(n / P) - 1, with P =
    THREADS slot ids loaded side by side in the first round (alongside the
    tile's) and probes · THREADS in each later one."""
    P, rounds = THREADS, 0
    while N > 0:
        N, P, rounds = -(-N // P) - 1, probes * THREADS, rounds + 1
    return rounds


@functools.lru_cache(maxsize=None)
def segsum_geometry(N: int, S: int, C: int, itemsize: int) -> tuple:
    """(rows a tile, rows staged at a time, blocks per lane, probes per
    thread) of segsum.cu for N rows of C values of ``itemsize`` bytes into
    S slots.  Staged at a time: TILE_ROWS rows, halved while they and one
    more row of running sums pass TILE_BYTES.  A tile: the fewest rows,
    from MIN_TILE_ROWS up to that, whose grid (a block for every tile of
    rows and for as many slots of the empty tail) fits one WAVE; the fewer
    rows a tile, the more SMs share the folds.  Probes: the fewest that
    give the fewest search rounds.  Raises for rows too wide to stage one
    at a time."""
    width = C * itemsize
    if 2 * width > TILE_BYTES:
        raise ValueError(f"segment_sum: rows of {C} x {itemsize} bytes pass "
                         f"the kernel's {TILE_BYTES // 2}-byte limit")
    buf = TILE_ROWS
    while (buf + 1) * width > TILE_BYTES:
        buf //= 2
    rows = min(buf, MIN_TILE_ROWS)
    while rows < buf and -(-max(N, S) // rows) > WAVE:
        rows *= 2
    blocks = max(-(-N // rows), -(-S // rows), 1)
    probes = min(range(1, PROBES_MAX + 1),
                 key=lambda p: (search_rounds(N, p), p))
    return rows, buf, blocks, probes


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
    from the shapes.  ``values`` may start at any element: the kernel
    stages an unaligned view element by element."""
    _check(values, seg)
    B, N, C = values.shape
    dev = values.device
    out = torch.empty((B, S, C), dtype=values.dtype, device=dev)
    if out.numel() == 0:
        return out
    if B > 65535:
        raise ValueError(f"segment_sum: {B} lanes, the kernel takes 65535")
    rows, buf, blocks, probes = segsum_geometry(N, S, C,
                                                values.element_size())
    SEGSUM.launch(
        values.data_ptr(), seg.data_ptr(), B, N, S, C,
        int(values.dtype == torch.float64), rows, buf, blocks, probes,
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
