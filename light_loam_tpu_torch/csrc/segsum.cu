// segment_sum: per-slot sums of rows sorted by slot, added in row order.
//
// Replaces no Pallas kernel.  It replaces the float scatter-adds of the
// port (index_add_, which on CUDA adds with atomics in an order that
// changes from run to run), whose JAX counterparts are XLA scatter-adds:
// the voxel sums of light_loam_tpu/ops/voxel.py (voxel_downsample :106,
// which voxel_downsample_rings runs per ring), the sorted-store reduce of
// light_loam_tpu/ops/sorted_store.py (:125-128) and the landmark blocks of
// light_loam_tpu/models/refine.py (:186-196).
//
// Contract: values (B, N, C), seg (B, N) int64 nondecreasing along each
// lane, every entry in [0, S].  out (B, S, C): out[b, s, c] is the sum of
// values[b, r, c] over the rows r with seg[b, r] == s, as a left fold in
// row order starting from 0, so the CPU's index_add and np.add.at give
// the same bits.  Rows with seg == S (dead or over-capacity rows, the dump
// slot every caller throws away) are never read.  An empty slot is 0.
// Every output element is written: no memset, no atomics.
//
// What bounds it on an H100: bytes, one add per value read; at the
// flagship shapes the live rows and the slots are 0.05-6 MB, under 2 us at
// 3.35 TB/s.  What holds this design above that is latency: each slot's
// binary search is ~18 dependent loads, so it runs at a few microseconds
// a launch whatever the size.
//
// Design: one thread per slot and group of G consecutive columns, G = 1
// (one thread per output element) or 8 (a whole row of C <= 8, or a third
// of an 18-wide one), chosen by the wrapper from the shapes
// (ops/cuda_segsum.py segsum_geometry): G = 8 where the slots alone give
// enough threads to fill the card, so that the slot search is made once per
// slot and not once per column.  The thread binary-searches lane b's seg
// for the slot's first row, then folds its columns forward while seg == s,
// ROWS rows at a time: it reads the next ROWS slot ids first, counts how
// many still belong to s, then issues the loads of those rows' values
// together and adds them in order, so a long segment keeps loads in flight
// and a short one reads no value past its end.  Neighbouring threads take
// neighbouring slots (or columns): their searches read the same or nearby
// words, their value loads and their stores are contiguous.  The order of
// the additions is fixed by the row order alone, whatever the grid and G,
// so B lanes in one launch give each lane's bits of its own launch.  float
// and double (the refinement runs in float64 in the comparisons on the
// card).  No fast-math: an add is an IEEE add.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const T* __restrict__ values,
                   const int64_t* __restrict__ seg, int64_t N, int64_t S,
                   int C, int groups, int64_t total, T* __restrict__ out) {
  constexpr int ROWS = G == 1 ? 8 : 4;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int64_t slot = idx / groups;  // b * S + s
  const int c0 = static_cast<int>(idx - slot * groups) * G;
  const int64_t lane = slot / S;
  const int64_t s = slot - lane * S;
  const int64_t* sg = seg + lane * N;
  const T* v = values + lane * N * C + c0;

  // first row whose slot id is >= s
  int64_t lo = 0, hi = N;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(sg + mid) < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }

  T acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = T(0);
  for (int64_t r = lo; r < N; r += ROWS) {
    int64_t k[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      k[u] = r + u < N ? __ldg(sg + r + u) : -1;  // -1: no slot
    }
    int m = 0;  // rows r .. r + m - 1 belong to slot s
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      m += (m == u && k[u] == s);
    }
    T x[ROWS][G];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        x[u][g] = u < m && c0 + g < C ? __ldg(v + (r + u) * C + g) : T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (u < m) {
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += x[u][g];
      }
    }
    if (m < ROWS) break;
  }
  T* o = out + slot * C + c0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (c0 + g < C) o[g] = acc[g];
  }
}

template <typename T, int G>
cudaError_t launch(const void* values, const void* seg, int64_t B, int64_t N,
                   int64_t S, int C, void* out, cudaStream_t stream) {
  const int groups = (C + G - 1) / G;
  const int64_t total = B * S * groups;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  segment_sum_kernel<T, G>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
          static_cast<const T*>(values), static_cast<const int64_t*>(seg), N,
          S, C, groups, total, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* values, const void* seg, int64_t B, int64_t N,
                   int64_t S, int C, int cols_per_thread, void* out,
                   cudaStream_t stream) {
  switch (cols_per_thread) {
    case 1:
      return launch<T, 1>(values, seg, B, N, S, C, out, stream);
    case 8:
      return launch<T, 8>(values, seg, B, N, S, C, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// values (B, N, C) float32 (is_double 0) or float64 (1) and seg (B, N)
// int64 on `device`, both contiguous; writes out (B, S, C) of the values'
// type, each thread summing cols_per_thread (1 or 8) columns of a slot.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int segment_sum_launch(const void* values, const void* seg,
                                  int64_t B, int64_t N, int64_t S, int C,
                                  int is_double, int cols_per_thread,
                                  void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || N < 0 || S < 0 || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = is_double ? launch<double>(values, seg, B, N, S, C, cols_per_thread,
                                   out, st)
                  : launch<float>(values, seg, B, N, S, C, cols_per_thread,
                                  out, st);
  return static_cast<int>(err);
}
