// knn5: streamed masked 5-nearest-neighbour search for the scan-to-map stage.
//
// Replaces the Pallas TPU kernel light_loam_tpu/ops/pallas_knn.py
// (knn_pallas -> _knn_impl -> _knn_kernel, with _select_k): for each query
// point, the k = 5 reference points of smallest squared distance
// d = max(|q|^2 + |r|^2 - 2 q.r, 0) among the masked-in ones, ascending, ties
// to the lower reference index.  Count-aware: [query_count, ref_count] is read
// from a device int32 pair, rows at or past query_count write (1e30, 0), and
// only references below ref_count are visited.  Slots left without a live
// neighbour keep (1e30, 0).
//
// What bounds it on an H100: the contraction depth is 3, so there is no
// matrix product for the tensor cores; the work is Q*N scalar distance
// evaluations plus a compare per pair (FP32 pipes and instruction throughput), while
// the bytes are small (16 B per reference point, read once per block).
//
// Design: one thread per query in a block of 128 queries.  The block stages
// tiles of the reference cloud through shared memory as float4 (x, y, z,
// |r|^2), every thread of a warp reading the same word (a broadcast), so
// device memory is read once per block and tile.  The running top-5 lives in
// registers and a candidate enters by a strict-< insertion; references are
// scanned in ascending index order, which reproduces the first-index tie rule
// of the reference's knn_tiled/_select_k.  Distances use the same Gram form
// as pallas_knn.py so the rounding stays close to the reference's.  A masked
// reference gets |r|^2 = +inf, so its distance is +inf and never enters the
// top-5, which starts at 1e30.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int K = 5;
constexpr int BLOCK = 128;
constexpr int TILE = 1024;
constexpr float BIG = 1e30f;

__global__ void __launch_bounds__(BLOCK)
knn5_kernel(const float* __restrict__ query, const float* __restrict__ ref,
            const unsigned char* __restrict__ mask,
            const int* __restrict__ counts, int Q, int N,
            float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[TILE];

  const int qc = min(counts[0], Q);
  const int rc = min(counts[1], N);
  const int first_row = static_cast<int>(blockIdx.x) * BLOCK;
  const int row = first_row + static_cast<int>(threadIdx.x);
  const bool live = row < qc;

  float qx = 0.f, qy = 0.f, qz = 0.f, q2 = 0.f;
  if (live) {
    qx = query[3 * row];
    qy = query[3 * row + 1];
    qz = query[3 * row + 2];
    q2 = qx * qx + qy * qy + qz * qz;
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = BIG;
    bi[s] = 0;
  }

  // a block whose first row is dead has no live row: skip the sweep
  const int n_ref = first_row < qc ? rc : 0;
  for (int t0 = 0; t0 < n_ref; t0 += TILE) {
    const int tn = min(TILE, n_ref - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < tn; j += BLOCK) {
      const int g = t0 + j;
      const float x = ref[3 * g], y = ref[3 * g + 1], z = ref[3 * g + 2];
      const float r2 = mask[g] ? x * x + y * y + z * z : CUDART_INF_F;
      tile[j] = make_float4(x, y, z, r2);
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < tn; ++j) {
        const float4 p = tile[j];
        const float cross = qx * p.x + qy * p.y + qz * p.z;
        const float d = fmaxf((q2 + p.w) - 2.0f * cross, 0.0f);
        if (d < bd[K - 1]) {
          bd[K - 1] = d;
          bi[K - 1] = t0 + j;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (bd[s] < bd[s - 1]) {
              const float td = bd[s];
              bd[s] = bd[s - 1];
              bd[s - 1] = td;
              const int ti = bi[s];
              bi[s] = bi[s - 1];
              bi[s - 1] = ti;
            }
          }
        }
      }
    }
  }

  if (row < Q) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[K * row + s] = bd[s];
      out_i[K * row + s] = bi[s];
    }
  }
}

}  // namespace

// query (Q,3) f32, ref (N,3) f32, mask (N,) bool, counts (2,) int32
// [query_count, ref_count], all on `device`; writes out_d (Q,5) f32 and
// out_i (Q,5) int32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int knn5_launch(const void* query, const void* ref,
                           const void* mask, const void* counts, int Q, int N,
                           void* out_d, void* out_i, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q <= 0) return 0;
  const int grid = (Q + BLOCK - 1) / BLOCK;
  knn5_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(ref),
      static_cast<const unsigned char*>(mask),
      static_cast<const int*>(counts), Q, N, static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
