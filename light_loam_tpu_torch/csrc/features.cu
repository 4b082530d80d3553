// feature_picks: the curvature and the greedy per-sector picks of the
// feature stage, one range-image ring per thread block.
//
// Replaces no Pallas kernel: the JAX package leaves the picks to XLA
// (light_loam_tpu/ops/features.py select_features, a fixed sequence of
// masked argmax/argmin steps over the whole grid).  Op by op in PyTorch
// the same sequence is 6 sectors x (20 corner + 4 flat) = 144 dependent
// picks of ~50 whole-grid kernels each: ~8,400 nodes of the features graph
// a sweep, each ~2 us of the card's time whatever it computes.  Here one
// block makes one ring's picks in the reference's order
// (src/scanRegistration.cpp:225-368): the rings are independent, the
// picks within a ring are not.
//
// What it computes, for ring r of an (R, H) range image, the values of
// light_loam_tpu_torch/ops/cuda_features.py select_features over
// compute_curvature bit for bit:
//  * curv[c]: per axis -10 x[c] plus the taps at offsets -5..-1, 1..5 in
//    that order (zero beyond the ring's ends), then (x^2 + y^2) + z^2;
//    d2[c]: (dx^2 + dy^2) + dz^2 of the step to column c + 1 (0 at the
//    last column).  Each product and sum is rounded on its own
//    (__fmul_rn, __fadd_rn, __fsub_rn), as PyTorch rounds each op: an FMA
//    would move the last bit, and the curvature decides the picks and
//    their ties.
//  * The ring is active if seg = counts[r] - 11 >= n_sectors; sector j
//    spans [5 + seg j / n_sectors, 5 + seg (j + 1) / n_sectors - 1].
//    Sectors in order; in each, n_corner picks of the largest eligible
//    curvature (in the sector, not yet picked, above the threshold), then
//    n_flat picks of the smallest (below it); ties go to the lowest
//    column, as torch.argmax / argmin.  A corner pick is labelled 2 while
//    its rank is below max_sharp, else 1; a flat pick -1.  Its order key
//    is j (n_corner + n_flat + 8) + rank, flats after the corners; an
//    unpicked column keeps 0 and INT32_MAX.  A pick then suppresses itself
//    and, on each side, up to `radius` columns while each step from the
//    pick outward stays within gap_sq (across sector bounds, never across
//    rings); the last flat pick of a sector suppresses only itself
//    (ref:327-331).  Columns masked out or pre-suppressed (the occlusion
//    filter) are never picked.
//
// What bounds it on an H100: the chain of 144 dependent picks a ring, not
// bytes (a 64 x 2304 image is 1.9 MB in, 0.7 MB out: ~0.8 us at 3.35
// TB/s) or operations (~60 FLOP a column).
//
// Design:
//  * One block of 128 threads per ring, blockIdx.x = ring: B vmapped lanes
//    of R rings are B R blocks of one launch.  All threads compute the
//    ring's curvature and steps into shared memory; warp 0 alone makes the
//    picks; all threads write the labels and keys out, coalesced.
//  * Shared memory holds per column the curvature where a corner may still
//    be picked (else -inf), the same for a flat (else +inf), d2, the key
//    and the label: 17 B a column, 39,168 B at H = 2304 (opting in above
//    48 KB).  Suppressing a column sets both candidates to their sentinel,
//    so a pick is one scan of one array.
//  * A pick: lane l scans the sector's columns l, l + 32, ... keeping the
//    first extreme; a butterfly of shuffles gives every lane the warp's
//    extreme, the lowest column on ties.  A sector with nothing eligible
//    left ends its picks of that kind: suppression only removes
//    candidates.  The suppression walk is one ballot a side: lane l tests
//    the step to the (l + 1)-th column out, and the run of passing steps
//    from the pick is suppressed (so the radius is at most 32).
//  * Nothing is read to the host and nothing allocated: the launch goes on
//    the caller's stream and is captured into the features graph.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int KEY_NONE = 0x7fffffff;  // order key of an unpicked column
constexpr int BYTES_PER_COLUMN = 17;  // corner, flat, d2, key, label
constexpr long MAX_SMEM = 227L * 1024;
constexpr int MAX_RADIUS = 32;         // one lane a column of the window side

struct Picks {
  int H, n_sectors, max_sharp, n_corner, n_flat, radius;
  float threshold, gap_sq;
};

// Column c can be picked neither as a corner nor as a flat any more.
__device__ __forceinline__ void suppress(float* corner, float* flat, int c) {
  corner[c] = -CUDART_INF_F;
  flat[c] = CUDART_INF_F;
}

// The warp's extreme (largest if MAX, else smallest) of the lanes'
// (best, at), the lowest column on ties; every lane gets it.
template <bool MAX>
__device__ __forceinline__ void warp_extreme(float& best, int& at) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(FULL, best, o);
    const int c = __shfl_xor_sync(FULL, at, o);
    if ((MAX ? v > best : v < best) || (v == best && c < at)) {
      best = v;
      at = c;
    }
  }
}

// The length of the run of set bits from bit 0 of a ballot.
__device__ __forceinline__ int run_length(unsigned ballot) {
  return ballot == FULL ? 32 : __ffs(~ballot) - 1;
}

// The pick at column `at` suppresses itself and, on each side, the columns
// up to the first step larger than gap_sq, at most `radius` (<= 32) of them
// (the reference's two break loops, ref:288-311).  Lane l tests the step
// to the (l + 1)-th column out: d2[at + l] for column at + 1 + l, d2[at -
// 1 - l] for column at - 1 - l.
__device__ void suppress_window(float* corner, float* flat, const float* d2,
                                int at, const Picks& p, int lane) {
  if (lane == 0) suppress(corner, flat, at);
  const int cu = at + 1 + lane, cd = at - 1 - lane;
  const bool in = lane < p.radius;
  const unsigned pass_u =
      __ballot_sync(FULL, in && cu < p.H && d2[cu - 1] <= p.gap_sq);
  const unsigned pass_d =
      __ballot_sync(FULL, in && cd >= 0 && d2[cd] <= p.gap_sq);
  if (lane < run_length(pass_u)) suppress(corner, flat, cu);
  if (lane < run_length(pass_d)) suppress(corner, flat, cd);
}

// Warp 0's picks over one active ring: sectors in order, corners first.
__device__ void pick_ring(float* corner, float* flat, const float* d2,
                          int* key, signed char* lab, long long seg,
                          const Picks& p, int lane) {
  const int stride = p.n_corner + p.n_flat + 8;
  for (int j = 0; j < p.n_sectors; ++j) {
    // a count past H (never from the range image) ends at the ring's end
    const long long first = 5 + seg * j / p.n_sectors;
    const long long last = min(5 + seg * (j + 1) / p.n_sectors - 1,
                               static_cast<long long>(p.H - 1));
    if (first > last) continue;
    const int sp = static_cast<int>(first), ep = static_cast<int>(last);
    for (int rank = 0; rank < p.n_corner; ++rank) {
      float best = -CUDART_INF_F;
      int at = KEY_NONE;
      for (int c = sp + lane; c <= ep; c += 32) {
        const float v = corner[c];
        if (v > best) {
          best = v;
          at = c;
        }
      }
      warp_extreme<true>(best, at);
      if (!(best > -CUDART_INF_F)) break;
      if (lane == 0) {
        lab[at] = rank < p.max_sharp ? 2 : 1;
        key[at] = j * stride + rank;
      }
      suppress_window(corner, flat, d2, at, p, lane);
      __syncwarp();
    }
    for (int rank = 0; rank < p.n_flat; ++rank) {
      float best = CUDART_INF_F;
      int at = KEY_NONE;
      for (int c = sp + lane; c <= ep; c += 32) {
        const float v = flat[c];
        if (v < best) {
          best = v;
          at = c;
        }
      }
      warp_extreme<false>(best, at);
      if (!(best < CUDART_INF_F)) break;
      if (lane == 0) {
        lab[at] = -1;
        key[at] = j * stride + p.n_corner + rank;
      }
      if (rank < p.n_flat - 1) {
        suppress_window(corner, flat, d2, at, p, lane);
      } else if (lane == 0) {
        suppress(corner, flat, at);
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(THREADS)
feature_picks_kernel(const float* __restrict__ xyz,
                     const unsigned char* __restrict__ mask,
                     const int* __restrict__ counts,
                     const unsigned char* __restrict__ pre, Picks p,
                     signed char* __restrict__ label,
                     int* __restrict__ okey) {
  extern __shared__ float smem[];
  const int H = p.H;
  float* corner = smem;
  float* flat = corner + H;
  float* d2 = flat + H;
  int* key = reinterpret_cast<int*>(d2 + H);
  signed char* lab = reinterpret_cast<signed char*>(key + H);
  const long long ring = blockIdx.x;
  const long long row = ring * H;
  const float* X = xyz + 3 * row;

  for (int c = threadIdx.x; c < H; c += THREADS) {
    float ax = __fmul_rn(-10.0f, X[3 * c]);
    float ay = __fmul_rn(-10.0f, X[3 * c + 1]);
    float az = __fmul_rn(-10.0f, X[3 * c + 2]);
    for (int off = -5; off <= 5; ++off) {
      if (off == 0) continue;
      const int n = c + off;
      const bool in = n >= 0 && n < H;
      ax = __fadd_rn(ax, in ? X[3 * n] : 0.0f);
      ay = __fadd_rn(ay, in ? X[3 * n + 1] : 0.0f);
      az = __fadd_rn(az, in ? X[3 * n + 2] : 0.0f);
    }
    const float curv = __fadd_rn(
        __fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)), __fmul_rn(az, az));
    const int nx = c + 1 < H ? c + 1 : c;
    const float dx = __fsub_rn(X[3 * nx], X[3 * c]);
    const float dy = __fsub_rn(X[3 * nx + 1], X[3 * c + 1]);
    const float dz = __fsub_rn(X[3 * nx + 2], X[3 * c + 2]);
    d2[c] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz));
    const bool open = mask[row + c] && !(pre != nullptr && pre[row + c]);
    corner[c] = open && curv > p.threshold ? curv : -CUDART_INF_F;
    flat[c] = open && curv < p.threshold ? curv : CUDART_INF_F;
    key[c] = KEY_NONE;
    lab[c] = 0;
  }
  __syncthreads();
  const long long seg = static_cast<long long>(counts[ring]) - 11;
  if (threadIdx.x < 32 && seg >= p.n_sectors) {
    pick_ring(corner, flat, d2, key, lab, seg, p, threadIdx.x);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += THREADS) {
    label[row + c] = lab[c];
    okey[row + c] = key[c];
  }
}

}  // namespace

// xyz (rings,H,3) f32, mask (rings,H) bool, counts (rings,) i32 and, unless
// null, pre (rings,H) bool, all contiguous on `device`; writes label
// (rings,H) int8 and okey (rings,H) i32.  Launches on `stream`; returns
// cudaGetLastError().  Launches nothing and returns cudaErrorInvalidValue
// for a radius over MAX_RADIUS, rings too wide for a block's shared memory
// (BYTES_PER_COLUMN * H > MAX_SMEM), no sector or a negative count.
extern "C" int feature_picks_launch(const void* xyz, const void* mask,
                                    const void* counts, const void* pre,
                                    int rings, int H, int n_sectors,
                                    int max_sharp, int n_corner, int n_flat,
                                    int radius, float threshold, float gap_sq,
                                    void* label, void* okey, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long smem = static_cast<long>(BYTES_PER_COLUMN) * H;
  if (rings < 0 || H < 0 || n_sectors < 1 || max_sharp < 0 ||
      n_corner < 0 || n_flat < 0 || radius < 0 || radius > MAX_RADIUS ||
      smem > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rings == 0 || H == 0) return 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(feature_picks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Picks p;
  p.H = H;
  p.n_sectors = n_sectors;
  p.max_sharp = max_sharp;
  p.n_corner = n_corner;
  p.n_flat = n_flat;
  p.radius = radius;
  p.threshold = threshold;
  p.gap_sq = gap_sq;
  feature_picks_kernel<<<rings, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const unsigned char*>(mask),
      static_cast<const int*>(counts), static_cast<const unsigned char*>(pre),
      p, static_cast<signed char*>(label), static_cast<int*>(okey));
  return cudaGetLastError();
}
