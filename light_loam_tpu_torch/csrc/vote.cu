// compat_votes: graph-vote incompatibility counts per correspondence chunk.
//
// Replaces the Pallas TPU kernel light_loam_tpu/ops/pallas_vote.py
// (compat_votes_pallas -> _votes_impl -> _vote_kernel): for each of R chunks
// of K correspondences (src_i, tgt_i), with Euclidean distances in Gram form
// ds_ij = sqrt(max(|s_i|^2 + |s_j|^2 - 2 s_i.s_j, 0)) and the same over tgt,
// gap = ds - dt and score = exp(-gap^2 / res^2), row i's vote is the number
// of j != i with score < threshold and both ends valid
// (laserOdometry.cpp:228-252).  Votes are written as float counts.
//
// What bounds it on an H100: per chunk K^2 pairs, each two 3-term dot
// products, two square roots and an exponential -- the SFU (sqrt, exp) and
// FP32 pipes; the bytes (7 floats per point in, 1 out) are negligible.  On
// the odometry path R = 10 chunks of K = 163, so only 10 blocks run and the
// card is mostly idle; filling it (several blocks per chunk) is later work.
//
// Design: one block per chunk.  Each thread owns one row i at a time and
// loops over j; the j side streams through shared memory in tiles of 256
// points (x, y, z, |x|^2 for src and tgt, plus validity), so any K works with
// a fixed 9 KB of shared memory.  The Gram form, sqrtf(fmaxf(d2, 0)) and
// expf (not __expf) follow the reference kernel, so borderline
// score-vs-threshold pairs round as closely as the FMA contraction allows.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int TILE = 256;

__global__ void __launch_bounds__(BLOCK)
compat_votes_kernel(const float* __restrict__ src,
                    const float* __restrict__ tgt,
                    const float* __restrict__ valid, int K, float threshold,
                    float inv_res_sq, float* __restrict__ votes) {
  __shared__ float s_x[TILE], s_y[TILE], s_z[TILE], s_n[TILE];
  __shared__ float t_x[TILE], t_y[TILE], t_z[TILE], t_n[TILE];
  __shared__ float s_v[TILE];

  const long base = static_cast<long>(blockIdx.x) * K;
  const float* S = src + 3 * base;
  const float* T = tgt + 3 * base;
  const float* V = valid + base;

  for (int i0 = 0; i0 < K; i0 += BLOCK) {
    const int i = i0 + threadIdx.x;
    const bool row = i < K;
    float sx = 0.f, sy = 0.f, sz = 0.f, sn = 0.f;
    float tx = 0.f, ty = 0.f, tz = 0.f, tn = 0.f, vi = 0.f;
    if (row) {
      sx = S[3 * i];
      sy = S[3 * i + 1];
      sz = S[3 * i + 2];
      tx = T[3 * i];
      ty = T[3 * i + 1];
      tz = T[3 * i + 2];
      sn = sx * sx + sy * sy + sz * sz;
      tn = tx * tx + ty * ty + tz * tz;
      vi = V[i];
    }
    int count = 0;
    for (int j0 = 0; j0 < K; j0 += TILE) {
      const int jn = min(TILE, K - j0);
      __syncthreads();
      for (int jj = threadIdx.x; jj < jn; jj += BLOCK) {
        const int j = j0 + jj;
        const float ax = S[3 * j], ay = S[3 * j + 1], az = S[3 * j + 2];
        const float bx = T[3 * j], by = T[3 * j + 1], bz = T[3 * j + 2];
        s_x[jj] = ax;
        s_y[jj] = ay;
        s_z[jj] = az;
        s_n[jj] = ax * ax + ay * ay + az * az;
        t_x[jj] = bx;
        t_y[jj] = by;
        t_z[jj] = bz;
        t_n[jj] = bx * bx + by * by + bz * bz;
        s_v[jj] = V[j];
      }
      __syncthreads();
      if (row) {
        for (int jj = 0; jj < jn; ++jj) {
          if (!(vi * s_v[jj] > 0.f) || j0 + jj == i) continue;
          const float ds2 =
              (sn + s_n[jj]) - 2.0f * (sx * s_x[jj] + sy * s_y[jj] + sz * s_z[jj]);
          const float dt2 =
              (tn + t_n[jj]) - 2.0f * (tx * t_x[jj] + ty * t_y[jj] + tz * t_z[jj]);
          const float gap = sqrtf(fmaxf(ds2, 0.0f)) - sqrtf(fmaxf(dt2, 0.0f));
          const float score = expf(-(gap * gap) * inv_res_sq);
          count += score < threshold;
        }
      }
    }
    if (row) votes[base + i] = static_cast<float>(count);
  }
}

}  // namespace

// src, tgt (R,K,3) f32 and valid (R,K) f32 on `device`; writes votes (R,K)
// f32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int compat_votes_launch(const void* src, const void* tgt,
                                   const void* valid, int R, int K,
                                   float threshold, float inv_res_sq,
                                   void* votes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R <= 0 || K <= 0) return 0;
  compat_votes_kernel<<<R, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const float*>(valid), K, threshold, inv_res_sq,
      static_cast<float*>(votes));
  return static_cast<int>(cudaGetLastError());
}
