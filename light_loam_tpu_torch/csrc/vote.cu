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
// What bounds it on an H100: issue rate and latency, not bytes.  The bytes
// are 7 floats in and 1 out per point; the work is K^2 pairs per chunk, each
// two 3-term dot products, two IEEE square roots and (rarely, see below) an
// exponential.  On the paths R = 10 and K = 163 (odometry) or 829 (mapping
// vote), so one block per chunk would leave 122 of the 132 SMs idle and the
// dependent sqrt chains of 8 warps per SM stalled.
//
// Design:
//  * Fill the card.  The grid is R x row_blocks flattened: block b serves
//    chunk b / row_blocks and rows (b % row_blocks) * 8 * RPW onwards.  Each
//    of its 8 warps owns RPW whole rows, held in registers; its 32 lanes
//    stride over j, so consecutive lanes read consecutive shared-memory
//    words.  Each row's count is summed with __reduce_add_sync and stored
//    once: no atomics, so the result is deterministic.  RPW rows per warp
//    reuse each staged j point RPW times and give RPW independent chains.
//    The wrapper (ops/cuda_vote.py vote_geometry) picks RPW and row_blocks.
//  * The chunk's j side is staged in dynamic shared memory once per block,
//    structure of arrays: x, y, z, |x|^2 of src and of tgt and validity,
//    36 B per point (29.8 KB at K = 829).  Past 1024 points it streams
//    through in tiles of 1024 (36 KB), so any K works.  Larger tiles cost
//    occupancy: staging all 6000 points of a chunk (211 KB, one block per
//    SM) took 2.2x as long on an H100 as tiles of 1024; and 36 KB stays
//    under the 48 KB a launch may take without opting in.
//  * exp is taken off almost every pair without changing a decision.  With
//    a = -(gap^2) * inv_res_sq, the pair counts iff expf(a) < threshold.
//    CUDA's expf is accurate to 2 ulp, so for a normal result
//    |expf(a) - e^a| <= 2^-22 e^a.  The wrapper passes a band
//    [a_lo, a_hi] = ln(threshold) -/+ 1e-5, rounded outwards to float32.
//    If a < a_lo: expf(a) <= e^a (1 + 2^-22) < threshold e^-1e-5 (1 + 2^-22)
//    < threshold, so the pair counts.  If a > a_hi: expf(a) >= e^a (1 -
//    2^-22) > threshold e^1e-5 (1 - 2^-22) > threshold, so it does not.
//    Only inside the band (and for NaN) is expf called and compared as
//    before.  For a threshold whose log is not finite or is below -80 the
//    band is the whole line.
//  * Per pair the arithmetic is the earlier one-block-per-chunk kernel's,
//    expression for expression: the Gram form, sqrtf(fmaxf(d2, 0)), expf
//    (not __expf), no fast-math, so every decision, and every count, is
//    the same bit for bit.
//  * No tensor cores: the contraction depth is 3 and the distances need
//    full float32 (TF32 cross terms at ~1e4 m^2 corrupt metre-scale gaps;
//    see light_loam_tpu_torch/__init__.py).  No TMA: a chunk starts at
//    byte 12 K r of the (R, K, 3) array, not 16-byte aligned for odd K,
//    and 30 KB per block from L2 is cheap next to the K^2 pair work.
//  * Symmetry (ds, dt symmetric, so half the pairs would do) is not used:
//    it needs column counts across blocks, i.e. atomics or a second pass.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int FLOATS_PER_POINT = 9;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return x * x + y * y + z * z;
}

template <int RPW>
__global__ void __launch_bounds__(THREADS)
compat_votes_kernel(const float* __restrict__ src,
                    const float* __restrict__ tgt,
                    const float* __restrict__ valid, int K, int row_blocks,
                    int tile, float threshold, float inv_res_sq, float a_lo,
                    float a_hi, float* __restrict__ votes) {
  extern __shared__ float smem[];
  float* s_x = smem;
  float* s_y = s_x + tile;
  float* s_z = s_y + tile;
  float* s_n = s_z + tile;
  float* t_x = s_n + tile;
  float* t_y = t_x + tile;
  float* t_z = t_y + tile;
  float* t_n = t_z + tile;
  float* s_v = t_n + tile;

  const int chunk = blockIdx.x / row_blocks;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x % row_blocks) * (WARPS * RPW) +
                   (threadIdx.x >> 5) * RPW;
  const long base = static_cast<long>(chunk) * K;
  const float* S = src + 3 * base;
  const float* T = tgt + 3 * base;
  const float* V = valid + base;

  float sx[RPW], sy[RPW], sz[RPW], sn[RPW];
  float tx[RPW], ty[RPW], tz[RPW], tn[RPW], vi[RPW];
  int count[RPW];
  bool live = false;  // a row with validity 0 counts no pair: skip the sweep
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = row0 + r;
    sx[r] = sy[r] = sz[r] = sn[r] = 0.f;
    tx[r] = ty[r] = tz[r] = tn[r] = vi[r] = 0.f;
    count[r] = 0;
    if (i < K) {
      sx[r] = S[3 * i];
      sy[r] = S[3 * i + 1];
      sz[r] = S[3 * i + 2];
      tx[r] = T[3 * i];
      ty[r] = T[3 * i + 1];
      tz[r] = T[3 * i + 2];
      sn[r] = sq_norm(sx[r], sy[r], sz[r]);
      tn[r] = sq_norm(tx[r], ty[r], tz[r]);
      vi[r] = V[i];
    }
    live |= vi[r] != 0.f;
  }

  for (int j0 = 0; j0 < K; j0 += tile) {
    const int jn = min(tile, K - j0);
    if (j0 > 0) __syncthreads();  // the previous tile is consumed
    for (int jj = threadIdx.x; jj < jn; jj += THREADS) {
      const int j = j0 + jj;
      const float ax = S[3 * j], ay = S[3 * j + 1], az = S[3 * j + 2];
      const float bx = T[3 * j], by = T[3 * j + 1], bz = T[3 * j + 2];
      s_x[jj] = ax;
      s_y[jj] = ay;
      s_z[jj] = az;
      s_n[jj] = sq_norm(ax, ay, az);
      t_x[jj] = bx;
      t_y[jj] = by;
      t_z[jj] = bz;
      t_n[jj] = sq_norm(bx, by, bz);
      s_v[jj] = V[j];
    }
    __syncthreads();
    if (!live) continue;
    for (int jj = lane; jj < jn; jj += 32) {
      const float vj = s_v[jj];
      const float ax = s_x[jj], ay = s_y[jj], az = s_z[jj], an = s_n[jj];
      const float bx = t_x[jj], by = t_y[jj], bz = t_z[jj], bn = t_n[jj];
      const int j = j0 + jj;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (!(vi[r] * vj > 0.f) || j == row0 + r) continue;
        const float ds2 =
            (sn[r] + an) - 2.0f * (sx[r] * ax + sy[r] * ay + sz[r] * az);
        const float dt2 =
            (tn[r] + bn) - 2.0f * (tx[r] * bx + ty[r] * by + tz[r] * bz);
        const float gap = sqrtf(fmaxf(ds2, 0.0f)) - sqrtf(fmaxf(dt2, 0.0f));
        const float a = -(gap * gap) * inv_res_sq;
        if (a < a_lo) {
          ++count[r];
        } else if (!(a > a_hi)) {
          count[r] += expf(a) < threshold;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int total = __reduce_add_sync(0xffffffffu, count[r]);
    if (lane == 0 && row0 + r < K) {
      votes[base + row0 + r] = static_cast<float>(total);
    }
  }
}

template <int RPW>
cudaError_t launch(const float* src, const float* tgt, const float* valid,
                   int R, int K, int row_blocks, int tile, int smem_bytes,
                   float threshold, float inv_res_sq, float a_lo, float a_hi,
                   float* votes, cudaStream_t stream) {
  if (static_cast<long>(row_blocks) * WARPS * RPW < K) {
    return cudaErrorInvalidValue;  // some row would have no warp
  }
  compat_votes_kernel<RPW><<<R * row_blocks, THREADS, smem_bytes, stream>>>(
      src, tgt, valid, K, row_blocks, tile, threshold, inv_res_sq, a_lo, a_hi,
      votes);
  return cudaGetLastError();
}

}  // namespace

// src, tgt (R,K,3) f32 and valid (R,K) f32 on `device`; writes votes (R,K)
// f32.  The geometry (rows_per_warp 1 or 2, row_blocks per chunk, the
// j tile and its shared-memory bytes) and the exp band [a_lo, a_hi] come
// from the wrapper.  Launches on `stream`; returns cudaGetLastError().
extern "C" int compat_votes_launch(const void* src, const void* tgt,
                                   const void* valid, int R, int K,
                                   float threshold, float inv_res_sq,
                                   float a_lo, float a_hi, int rows_per_warp,
                                   int row_blocks, int tile, int smem_bytes,
                                   void* votes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R <= 0 || K <= 0) return 0;
  if (row_blocks <= 0 || tile <= 0 ||
      static_cast<long>(smem_bytes) <
          static_cast<long>(tile) * FLOATS_PER_POINT * 4L ||
      static_cast<long>(R) * row_blocks > 0x7fffffffL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* s = static_cast<const float*>(src);
  const float* t = static_cast<const float*>(tgt);
  const float* v = static_cast<const float*>(valid);
  float* out = static_cast<float*>(votes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_per_warp) {
    case 1:
      err = launch<1>(s, t, v, R, K, row_blocks, tile, smem_bytes, threshold,
                      inv_res_sq, a_lo, a_hi, out, st);
      break;
    case 2:
      err = launch<2>(s, t, v, R, K, row_blocks, tile, smem_bytes, threshold,
                      inv_res_sq, a_lo, a_hi, out, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
