// knn5: masked 5-nearest-neighbour search for the scan-to-map stage, with the
// reference sweep split across blocks.
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
// What bounds it on an H100: FP32 issue.  Per (query, reference) pair the
// work is about 8 FLOP (the 3-term dot, |q|^2 + |r|^2, the -2 q.r FMA, the
// clamp) plus a compare and one shared-memory broadcast load; the bytes are
// 12-13 B per live point and 40 B per output row.  At the mapping stage's
// live counts (corner 1280 x 12288, surf 5120 x 24576 pairs) that is 1.9 and
// 15 us at 67 TFLOP/s, against ~0.3 and ~0.7 MB of traffic.
//
// Why split the sweep: with one thread per query and nothing else, the
// corner search has 1280 live queries, i.e. 10 blocks of 128 for 132 SMs,
// each thread walking 12288 references in a dependent compare chain.  So the
// grid is (query blocks) x (S reference segments).  The kernel reads rc from
// `counts` and cuts the live range [0, rc) into S segments of ceil(rc / S)
// references, so every segment holds live references once rc > (S - 1)^2
// (a split of the capacity N would leave most of them dead: at the corner
// shape rc is 12288 of 32768).  Segment lengths are not rounded to the
// staging tile: at S = 32 and rc = 12288 that would leave 8 segments empty.
// The wrapper (ops/cuda_knn.py knn_geometry) picks S from the capacities
// (Q, N) alone, so a call never reads the counts on the host.  Blocks hold
// QB = 128 queries: 64 was never faster at either mapping shape (PERF.md).
//
// Per segment: one query per thread, the segment's references staged through
// shared memory as float4 (x, y, z, |r|^2) in tiles of 256 and read as
// broadcasts, a register top-5 filled by strict-< insertion in ascending
// index order.  The per-pair expression, the staged |r|^2 (+inf for a masked
// reference) and q2 are written exactly as in the unsplit kernel and compiled
// with the same flags (no fast-math, default FMA contraction), so every
// distance is the same float.  What a short segment changes is how often a
// thread inserts (about 5 ln(L / 5) times in L references), and with 32 lanes
// some lane of a warp inserts at most positions: an insertion inside the
// pair loop, predicated or branched, costs several times the distance
// itself and was paid at nearly every pair.  So the loop only filters: a
// group of 8 distances is computed straight-line (the loads and FMA chains
// overlap), and each one below tau, the 5th entry at the last flush, joins
// the thread's queue in shared memory by a predicated 8-byte store (three
// instructions, inline PTX).  When some lane's queue may
// not hold another group, the warp flushes: each thread inserts its queued
// candidates in index order by the strict-< rule against its current list.
// A candidate not queued has d >= tau >= the current 5th entry, so the
// strict-< insertion would have rejected it: the list is the one the
// sequential scan builds.  The queue holds the unclamped x; the flush takes
// d = max(x, 0), and the filter is "not x >= tau", which a NaN x passes as
// it passes the unsplit kernel's clamp (to d = 0).
//
// Merge.  Each segment's list goes to scratch (S, Q, 5) f32 + i32, each
// block's lists as one contiguous coalesced copy (20-byte lists written at a
// stride of S lists, a partial sector each, held the stores back).  A second
// kernel, one warp per query, takes the top-5 of the union of the S lists
// under the lexicographic order on (d, index), by five rounds of a warp-wide
// minimum.
//
// Why that reproduces the single ascending scan, ties included.  d is never
// NaN (fmaxf returns the non-NaN operand), so (d, index) pairs are totally
// ordered and, the indices being distinct, all different.  (1) A strict-<
// insertion over references in ascending index order keeps the list sorted by
// d with equal d in arrival order, i.e. ascending index: after each step it
// holds the 5 lexicographically smallest pairs with d < 1e30 seen so far,
// padded with (1e30, 0) (a pair enters only if d < the 5th entry <= 1e30).
// So the scan's result is L(X) = the 5 lexicographically smallest real pairs
// of the whole live range X, padded.  (2) The segments partition X, and each
// segment list is L(X_s) by (1).  A pair p in L(X) has at most 4 real pairs
// of X below it, so at most 4 of X_s: p is in L(X_s).  Hence L(X) is the
// lexicographic top-5 of the union of the segment lists (which holds every
// member of L(X) and nothing outside X), and the merge takes exactly that.
// The merge drops paddings and writes (1e30, 0) for slots the real pairs do
// not fill.  It reads each list from a fixed place, so the result does not
// depend on the order in which blocks finish.
//
// What bounds it now (H100, PERF.md): the filter loop's instruction issue
// (per pair the broadcast load, six FP32 operations and the predicated
// append); at the corner shape also occupancy, 320 live blocks of 128
// threads.  Staging and the coalesced list writes overlap the loop.
//
// What is not done, and why:
//  * No tensor cores.  The contraction depth is 3, and the distances must be
//    full float32 and bit-identical to the scalar form: TF32, or a 3xTF32
//    split, rounds differently.
//  * No TMA.  A reference row is 12 B and a mask entry 1 B; the staging is a
//    few KB per block from L2.
//  * No spatial prune (pallas_knn.py:127-136 skips tiles that cannot improve
//    any row of a block).  It depends on the data's order, and the bound
//    would then count only the pairs evaluated; it stays open.
//  * No register blocking (2 or 4 queries per thread, each staged reference
//    used for all): measured on the H100 it was slower at both shapes.

#include <climits>
#include <type_traits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int K = 5;
constexpr int QB = 128;          // queries per block, one a thread
constexpr int TILE = 256;        // float4 references staged per block at once
constexpr int GROUP = 8;         // references between two flush checks
constexpr int QCAP = 16;         // queued candidates per query, at most
constexpr int MAX_SEGMENTS = 32;
constexpr int MERGE_WARPS = 4;   // rows per merge block, one warp each
constexpr int PER_LANE = MAX_SEGMENTS * K / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e30f;

__device__ __forceinline__ int segment_length(int rc, int segments) {
  return (rc + segments - 1) / segments;
}

__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Insert the candidates queued in slots first, first + QB, ... (below
// end) of cand, oldest (lowest index) first, by the unsplit kernel's
// strict-< insertion.  A slot holds (bits of (q2 + |r|^2) - 2 q.r, index):
// the clamp at 0 is applied here, giving the unsplit kernel's d bit for bit.
__device__ __forceinline__ void insert_queued(float (&bd)[K], int (&bi)[K],
                                              const int2* cand, int first,
                                              int end) {
  for (int e = first; e < end; e += QB) {
    const int2 c = cand[e];
    const float d = fmaxf(__int_as_float(c.x), 0.0f);
    if (d < bd[K - 1]) {
      bd[K - 1] = d;
      bi[K - 1] = c.y;
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

// Unless x >= tau (so also for a NaN x, which the clamp turns into d = 0, as
// in the unsplit kernel): store (x, idx) at shared address addr and advance
// it by STEP.  Three instructions, predicated, with no branch.
template <int STEP>
__device__ __forceinline__ void append_unless_above(unsigned& addr, float x,
                                                    float tau, int idx) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ltu.f32 p, %1, %2;\n\t"
      "@p st.shared.v2.b32 [%0], {%3, %4};\n\t"
      "@p add.u32 %0, %0, %5;\n\t}"
      : "+r"(addr)
      : "f"(x), "f"(tau), "r"(__float_as_int(x)), "r"(idx), "n"(STEP)
      : "memory");
}

// Block (x, y): queries [x * QB, x * QB + QB) against reference segment y,
// one query per thread; writes each live query's segment list to
// part_(d|i)[y][row][0..4].
__global__ void __launch_bounds__(QB)
knn5_segment_kernel(const float* __restrict__ query,
                    const float* __restrict__ ref,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ counts, int Q, int N,
                    float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 tile[TILE];
  // query column c's queue: slots c, c + QB, ... (bits of x, index)
  __shared__ int2 cand[QCAP * QB];

  const int qc = min(counts[0], Q);
  const int rc = min(counts[1], N);
  const int first_row = static_cast<int>(blockIdx.x) * QB;
  if (first_row >= qc) return;  // no live row; the merge writes these rows
  const int col = static_cast<int>(threadIdx.x);
  const int row = first_row + col;
  const bool live = row < qc;
  const int segments = static_cast<int>(gridDim.y);
  const int seg = segment_length(rc, segments);
  const int lo = static_cast<int>(min(
      static_cast<long long>(blockIdx.y) * seg, static_cast<long long>(rc)));
  const int hi = static_cast<int>(
      min(static_cast<long long>(lo) + seg, static_cast<long long>(rc)));

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
  // a dead row of a live block runs the loop with its warp (the flush
  // check is warp-wide) and keeps no candidate: d >= 0
  if (!live) bd[K - 1] = -1.0f;
  float tau = bd[K - 1];
  // the queue's first slot and the next free one, as shared-memory byte
  // addresses
  const unsigned first =
      static_cast<unsigned>(__cvta_generic_to_shared(cand + col));
  unsigned slot = first;
  const unsigned full = first + 8u * QB * (QCAP - GROUP);

  // G references from p (indices idx0, ...): all G values x = (q2 + |r|^2)
  // - 2 q.r first, straight-line, so the shared-memory loads and the FMA
  // chains of a group overlap; then each x below tau (the 5th entry at the
  // last flush) joins the queue, in index order.  d = max(x, 0) < tau
  // implies x < tau, so no candidate is lost; the flush decides on d.
  auto scan = [&](auto group, const float4* p, int idx0) {
    constexpr int G = decltype(group)::value;
    float x[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float4 pu = p[u];
      // the unsplit kernel's per-pair expression, before the clamp
      const float cross = qx * pu.x + qy * pu.y + qz * pu.z;
      x[u] = (q2 + pu.w) - 2.0f * cross;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      append_unless_above<8 * QB>(slot, x[u], tau, idx0 + u);
    }
  };
  auto flush = [&]() {
    insert_queued(bd, bi, cand, col,
                      col + static_cast<int>((slot - first) / 8u));
    slot = first;
    tau = bd[K - 1];
  };

  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int tn = min(TILE, hi - t0);
    __syncthreads();
    for (int j = col; j < tn; j += QB) {
      const int g = t0 + j;
      const float x = ref[3 * g], y = ref[3 * g + 1], z = ref[3 * g + 2];
      const float r2 = mask[g] ? x * x + y * y + z * z : CUDART_INF_F;
      tile[j] = make_float4(x, y, z, r2);
    }
    __syncthreads();
    // at most QCAP - GROUP queued before each group of GROUP references
    // (and before the tail, which is shorter), so a group always fits; the
    // flush check is warp-wide, so a warp flushes together
    int j0 = 0;
    for (; j0 + GROUP <= tn; j0 += GROUP) {
      scan(std::integral_constant<int, GROUP>(), tile + j0, t0 + j0);
      if (__any_sync(FULL, slot > full)) flush();
    }
    if (j0 < tn) {
      for (; j0 < tn; ++j0) {
        scan(std::integral_constant<int, 1>(), tile + j0, t0 + j0);
      }
      flush();
    }
  }
  flush();

  // The block's lists are one contiguous range of part_(d|i) (S, Q, 5):
  // write them through shared memory, so that the stores are coalesced.
  // Rows at or past qc carry their initial lists, which the merge ignores.
  __syncthreads();  // every queue is flushed: cand is free
  float* out_d = reinterpret_cast<float*>(cand);
  int* out_i = reinterpret_cast<int*>(cand) + QB * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_d[col * K + s] = bd[s];
    out_i[col * K + s] = bi[s];
  }
  __syncthreads();
  const long long base =
      (static_cast<long long>(blockIdx.y) * Q + first_row) * K;
  const int words = min(QB, Q - first_row) * K;
  for (int w = col; w < words; w += QB) {
    part_d[base + w] = out_d[w];
    part_i[base + w] = out_i[w];
  }
}

// One warp per row: the lexicographic top-5 of the row's S lists, by five
// rounds of a warp-wide lexicographic minimum; rows at or past qc get
// (1e30, 0).
__global__ void __launch_bounds__(32 * MERGE_WARPS)
knn5_merge_kernel(const int* __restrict__ counts, int Q, int segments,
                  const float* __restrict__ part_d,
                  const int* __restrict__ part_i, float* __restrict__ out_d,
                  int* __restrict__ out_i) {
  const int row = static_cast<int>(blockIdx.x) * MERGE_WARPS +
                  static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  if (row >= Q) return;  // the whole warp
  const bool live = row < min(counts[0], Q);
  const int n = segments * K;
  // entries lane, lane + 32, ...: entry e is slot e % 5 of segment e / 5;
  // padding and absent entries are (inf, INT_MAX)
  float ld[PER_LANE];
  int li[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int at = lane + 32 * e;
    ld[e] = CUDART_INF_F;
    li[e] = INT_MAX;
    if (live && at < n) {
      const long long a =
          (static_cast<long long>(at / K) * Q + row) * K + at % K;
      const float d = part_d[a];
      if (d < BIG) {
        ld[e] = d;
        li[e] = part_i[a];
      }
    }
  }
  for (int k = 0; k < K; ++k) {
    float md = ld[0];
    int mi = li[0];
#pragma unroll
    for (int e = 1; e < PER_LANE; ++e) {
      if (lex_less(ld[e], li[e], md, mi)) {
        md = ld[e];
        mi = li[e];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, md, off);
      const int oi = __shfl_xor_sync(FULL, mi, off);
      if (lex_less(od, oi, md, mi)) {
        md = od;
        mi = oi;
      }
    }
    // every lane holds the minimum now; a real index is held once
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      if (li[e] == mi && ld[e] == md) {
        ld[e] = CUDART_INF_F;
        li[e] = INT_MAX;
      }
    }
    if (lane == 0) {
      const bool real = md < BIG;
      out_d[K * row + k] = real ? md : BIG;
      out_i[K * row + k] = real ? mi : 0;
    }
  }
}

}  // namespace

// query (Q,3) f32, ref (N,3) f32, mask (N,) bool, counts (2,) int32
// [query_count, ref_count], all on `device`; writes out_d (Q,5) f32 and
// out_i (Q,5) int32.  The segment count (1 to 32) comes from the wrapper,
// with scratch part_d (segments,Q,5) f32 and part_i (segments,Q,5) int32.
// Launches the segment kernel and the merge on `stream`; returns
// cudaGetLastError().
extern "C" int knn5_launch(const void* query, const void* ref,
                           const void* mask, const void* counts, int Q, int N,
                           int segments, void* part_d, void* part_i,
                           void* out_d, void* out_i, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q <= 0) return 0;
  if (segments < 1 || segments > MAX_SEGMENTS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* c = static_cast<const int*>(counts);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto st = static_cast<cudaStream_t>(stream);
  knn5_segment_kernel<<<dim3((Q + QB - 1) / QB, segments), QB, 0, st>>>(
      static_cast<const float*>(query), static_cast<const float*>(ref),
      static_cast<const unsigned char*>(mask), c, Q, N, pd, pi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  knn5_merge_kernel<<<(Q + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS,
                      0, st>>>(c, Q, segments, pd, pi,
                               static_cast<float*>(out_d),
                               static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
