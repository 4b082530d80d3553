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
// Every output element is written exactly once: no memset, no atomics.
//
// What bounds it on an H100: bytes, one add per value read: the live rows'
// values and slot ids read once and every slot written, 0.05-6 MB at the
// flagship shapes, under 2 us at 3.35 TB/s.  Most of those bytes are the
// zeros of empty slots (the store re-sorts: 262144 slots for ~17k live
// rows).  What holds it above that is latency: a launch costs ~2 us on its
// own, and each dependent round trip to memory ~0.5-1.5 us under the
// load of the whole grid.  So the design keeps every block to two round
// trips (where one binary search per slot cost ~18) and the grid to one
// wave.
//
// Design: the grid is (X, B), X = max(ceil(N / T), ceil(S / T), 1) blocks
// of THREADS threads per lane over tiles of T rows, two rows a thread at
// most.  The wrapper (ops/cuda_segsum.py segsum_geometry) picks T (64 where
// the grid then fits one wave, up to TILE_ROWS), the rows staged at a time
// and the search's probes.  Block x of lane b:
//  1. reads its tile's slot ids seg[t0 - 1 .. t0 + T] into shared memory.
//  2. If seg[t0 - 1] is the dump slot, the tile lies past the lane's live
//     rows (they are a prefix, the dump rows a suffix): the block searches
//     for the live count L, THREADS slot ids at a stride, then probes x
//     THREADS in each later round, each round one __syncthreads_count-like
//     block sum that narrows [lo, hi] to one stride (two rounds at every
//     main-path shape); the largest live probe is seg[L - 1], so the empty
//     tail is [u, S), u = seg[L - 1] + 1.  The blocks from x_b = L / T on
//     split the tail into runs of equal length, zeroed in 16-byte stores;
//     this block writes its run and is done.
//  3. Else row r heads a segment when seg[r] < S and r == 0 or seg[r - 1]
//     != seg[r]: the heads are compacted by warp ballots with their slots
//     and the slot after their previous row's.
//  4. stages the values of its live rows from the first head on with
//     cp.async: 16-byte copies where the source is 16-byte aligned, the
//     unaligned ends (or a whole view at an unaligned offset) element by
//     element; shared memory is offset to the source's alignment.  A tile
//     with a dump row, or the last, holds row L - 1 and knows u: it is
//     block x_b and writes the first run of the tail.
//  5. folds: one thread per (head, column) adds its segment's rows left to
//     right from shared memory, writes the slot, and writes zeros over the
//     empty slots between the previous row's slot and its own (the lane's
//     first head: from slot 0).
//  6. If the tile's last segment runs on past the tile, the block follows
//     it, B_rows slot ids at a time (a block sum counts those equal to its
//     slot, a prefix), then those rows' values through shared memory,
//     folded by one thread a column, until the segment ends.
// So every slot is written once: a live slot by its head, an empty slot
// below u by the next head, one at or above u by its run of the tail.  The
// order of the additions is the row order alone, whatever T, X and B, so
// B lanes in one launch give each lane's bits of its own launch.  float
// and double (the refinement runs in float64 in the comparisons on the
// card).  No fast-math: an add is an IEEE add.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_THREAD = 2;
constexpr int TILE_ROWS = THREADS * ROWS_PER_THREAD;
constexpr int PROBES_MAX = 8;
constexpr int TILE_BYTES = 32768;
// blocks an SM holds (48 registers a thread at most): the grid of a lane
// fits one wave of MIN_BLOCKS x 132 blocks where the wrapper can choose so
constexpr int MIN_BLOCKS = 5;

template <typename I>
__device__ __forceinline__ I imin(I a, I b) {
  return a < b ? a : b;
}

template <typename I>
__device__ __forceinline__ I imax(I a, I b) {
  return a < b ? b : a;
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copies of `bytes` bytes from src (global, aligned to T) to dst
// (shared), where dst and src agree modulo 16, and commit them.
template <typename T>
__device__ void stage(unsigned char* dst, const unsigned char* src,
                      int64_t bytes) {
  constexpr int E = sizeof(T);
  const int64_t mis = reinterpret_cast<uintptr_t>(src) & 15;
  const int64_t head = imin<int64_t>(mis ? 16 - mis : 0, bytes);
  const int64_t body = (bytes - head) & ~int64_t(15);
  for (int64_t i = threadIdx.x * int64_t(E); i < head; i += THREADS * E) {
    copy_async<E>(dst + i, src + i);
  }
  for (int64_t i = threadIdx.x * int64_t(16); i < body; i += THREADS * 16) {
    copy_async16(dst + head + i, src + head + i);
  }
  for (int64_t i = head + body + threadIdx.x * int64_t(E); i < bytes;
       i += THREADS * E) {
    copy_async<E>(dst + i, src + i);
  }
  copy_async_commit();
}

// Zeros over out[begin, end), 16 bytes a store where aligned.
template <typename T>
__device__ void zero_fill(T* out, int64_t begin, int64_t end) {
  constexpr int PER = 16 / sizeof(T);
  const int64_t mis = (reinterpret_cast<uintptr_t>(out + begin) & 15) /
                      sizeof(T);
  const int64_t head = imin<int64_t>(mis ? PER - mis : 0, end - begin);
  for (int64_t i = threadIdx.x; i < head; i += THREADS) out[begin + i] = T(0);
  begin += head;
  const int64_t vecs = (end - begin) / PER;
  float4* o4 = reinterpret_cast<float4*>(out + begin);
  for (int64_t i = threadIdx.x; i < vecs; i += THREADS) {
    o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  begin += vecs * PER;
  for (int64_t i = begin + threadIdx.x; i < end; i += THREADS) out[i] = T(0);
}

// Block x's share of the lane's empty tail [u, S): the blocks x_b .. X - 1
// split it into X - x_b runs of equal length, in order.
template <typename T>
__device__ __forceinline__ void zero_share(T* out, int64_t S, int C,
                                           int64_t u, int64_t xb, int64_t x,
                                           int64_t X) {
  xb = imin(xb, X - 1);
  const int64_t Z = (S - u + X - xb - 1) / (X - xb);
  const int64_t z0 = imin(u + (x - xb) * Z, S);
  const int64_t z1 = imin(z0 + Z, S);
  if (z0 < z1) zero_fill(out, z0 * C, z1 * C);
}

// One search round's loads: probe j of this thread reads seg at lo + (j
// THREADS + tid) step, step = ceil((hi - lo) / (n THREADS)), for j < n
// (S, not live, past hi or past n).  Every block that searches loads the
// same words.
__device__ __forceinline__ int64_t probe_round(const int64_t* sg, int64_t lo,
                                               int64_t hi, int n, int64_t S,
                                               int64_t (&probe)[PROBES_MAX]) {
  const int64_t P = static_cast<int64_t>(n) * THREADS;
  const int64_t step = (hi - lo + P - 1) / P;
#pragma unroll
  for (int j = 0; j < PROBES_MAX; ++j) {
    const int64_t q =
        lo + (static_cast<int64_t>(j) * THREADS + threadIdx.x) * step;
    probe[j] = j < n && q < hi ? __ldg(sg + q) : S;
  }
  return step;
}

// Block-wide sum of one int a thread (a __syncthreads_count of counts);
// `par` alternates the buffer, so one barrier a call suffices.
__device__ __forceinline__ int block_sum(int v, int (&scount)[2][WARPS],
                                         int& par) {
  v = __reduce_add_sync(~0u, v);
  if ((threadIdx.x & 31) == 0) scount[par][threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += scount[par][w];
  par ^= 1;
  return total;
}

template <typename I>
__device__ __forceinline__ I warp_max(I v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = imax(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
segment_sum_kernel(const T* __restrict__ values,
                   const int64_t* __restrict__ seg, int64_t N, int64_t S,
                   int C, int T_rows, int B_rows, int probes,
                   T* __restrict__ out) {
  __shared__ int64_t sseg[TILE_ROWS + 2];  // seg[t0 - 1 .. t0 + rows]
  __shared__ short shead[TILE_ROWS + 1];   // head rows, tile-relative
  __shared__ int64_t sslot[TILE_ROWS];     // each head's slot
  __shared__ int64_t sgap[TILE_ROWS];      // the slot after the row before it
  __shared__ int sheads[ROWS_PER_THREAD][WARPS];
  __shared__ int slive[ROWS_PER_THREAD][WARPS];
  __shared__ int scount[2][WARPS];
  __shared__ int64_t stop[WARPS];
  extern __shared__ __align__(16) unsigned char dyn[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.y;
  const int64_t x = blockIdx.x;
  const int64_t X = gridDim.x;
  const int64_t t0 = x * T_rows;
  const int rows = static_cast<int>(imax<int64_t>(
      0, imin<int64_t>(N - t0, T_rows)));
  const int64_t* sg = seg + b * N;
  const T* vl = values + b * N * C;
  T* ol = out + b * S * C;
  int par = 0;

  // 1. the tile's slot ids, row i THREADS + tid in k[i]; seg[t0 - 1] (-1
  // at the lane's start, S past its end) and seg[t0 + rows] (S past the end)
  int64_t k[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = i * THREADS + tid;
    k[i] = r < rows ? __ldg(sg + t0 + r) : S;
  }
  int64_t edge = 0;
  if (tid == 0) edge = t0 == 0 ? -1 : t0 <= N ? __ldg(sg + t0 - 1) : S;
  if (tid == 1) edge = t0 + rows < N ? __ldg(sg + t0 + rows) : S;

#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = i * THREADS + tid;
    if (r < rows) sseg[1 + r] = k[i];
  }
  if (tid == 0) sseg[0] = edge;
  if (tid == 1) sseg[rows + 1] = edge;
  __syncthreads();

  // 2. The empty tail [u, S) goes to the blocks from x_b = min(L / T, X -
  // 1) on, L the lane's live count.  When seg[t0 - 1] == S the tile lies
  // past the live rows: the block searches for L and u = seg[L - 1] + 1,
  // zeroes its share of the tail and is done.
  if (sseg[0] >= S) {
    // the first round: one slot id a thread
    int64_t probe[PROBES_MAX];
    int64_t step = probe_round(sg, 0, N, 1, S, probe);
    int64_t lo = 0, hi = N, top = -1;
    for (;;) {
      int live = 0;
#pragma unroll
      for (int j = 0; j < PROBES_MAX; ++j) {
        if (probe[j] < S) {
          ++live;
          top = imax(top, probe[j]);
        }
      }
      // the live probes are the first c: L lies past the last of them
      const int64_t c = block_sum(live, scount, par);
      if (c == 0) {
        hi = lo;
      } else {
        const int64_t a = lo + (c - 1) * step;
        hi = imin(a + step, hi);
        lo = a + 1;
      }
      if (lo >= hi) break;
      step = probe_round(sg, lo, hi, probes, S, probe);
    }
    top = warp_max(top);
    if (lane == 0) stop[warp] = top;
    __syncthreads();
    int64_t last = -1;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) last = imax(last, stop[w]);
    // the largest live probe is seg[L - 1]
    zero_share(ol, S, C, lo > 0 ? last + 1 : 0, lo / T_rows, x, X);
    return;
  }

  // 3. heads, compacted in row order with their slots and gaps
  unsigned ballot[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int r = i * THREADS + tid;
    const bool live = r < rows && k[i] < S;
    ballot[i] = __ballot_sync(~0u, live && sseg[r] != k[i]);
    const unsigned alive = __ballot_sync(~0u, live);
    if (lane == 0) {
      sheads[i][warp] = __popc(ballot[i]);
      slive[i][warp] = __popc(alive);
    }
  }
  __syncthreads();
  int nheads = 0, live_rows = 0;  // the live rows are a prefix of the tile
  int before[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w == warp) before[i] = nheads;
      nheads += sheads[i][w];
      live_rows += slive[i][w];
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    if (ballot[i] >> lane & 1u) {
      const int r = i * THREADS + tid;
      const int h = before[i] + __popc(ballot[i] & ((1u << lane) - 1u));
      shead[h] = static_cast<short>(r);
      sslot[h] = k[i];
      sgap[h] = sseg[r] + 1;
    }
  }
  if (tid == 0) shead[nheads] = static_cast<short>(live_rows);
  __syncthreads();

  // 4. stage the values of rows [first head, live_rows)
  const int first = shead[0];
  const unsigned char* vsrc =
      reinterpret_cast<const unsigned char*>(vl + (t0 + first) * C);
  T* sv = reinterpret_cast<T*>(dyn + (reinterpret_cast<uintptr_t>(vsrc) & 15));
  T* sacc = reinterpret_cast<T*>(dyn + 16 + static_cast<int64_t>(B_rows) *
                                                 C * sizeof(T));
  if (nheads > 0) {
    stage<T>(reinterpret_cast<unsigned char*>(sv), vsrc,
             static_cast<int64_t>(live_rows - first) * C * sizeof(T));
  }

  // The rows before t0 are live, so x_b >= x, and x_b == x unless every
  // row of the tile is live and more blocks follow; then L = t0 +
  // live_rows.
  if (live_rows < T_rows || x == X - 1) {
    zero_share(ol, S, C, sseg[live_rows] + 1, x, x, X);
  }

  copy_async_wait();
  __syncthreads();

  // 5. one thread per (head, column)
  const int64_t s_last = nheads > 0 ? sslot[nheads - 1] : -1;
  const bool runs_on = nheads > 0 && live_rows == rows &&
                       sseg[rows + 1] == s_last;
  int h = tid / C, c = tid - h * C;
  const int dh = THREADS / C, dc = THREADS - dh * C;
  for (; h < nheads; h += dh, c += dc) {
    if (c >= C) {
      c -= C;
      if (++h >= nheads) break;
    }
    const int r0 = shead[h], r1 = shead[h + 1];
    const int64_t s = sslot[h];
    T acc = T(0);
    for (int r = r0; r < r1; ++r) acc += sv[(r - first) * C + c];
    if (h == nheads - 1 && runs_on) {
      sacc[c] = acc;
    } else {
      ol[s * C + c] = acc;
    }
    for (int64_t g = sgap[h]; g < s; ++g) ol[g * C + c] = T(0);
  }

  // 6. the last segment past the tile, B_rows rows at a time
  if (runs_on) {
    for (int64_t p = t0 + rows;; p += B_rows) {
      int64_t kk[ROWS_PER_THREAD];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        const int r = i * THREADS + tid;
        kk[i] = r < B_rows && p + r < N ? __ldg(sg + p + r) : S;
      }
      int same = 0;
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) same += kk[i] == s_last;
      const int m = block_sum(same, scount, par);
      if (m == 0) break;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(vl + p * C);
      T* cv = reinterpret_cast<T*>(dyn + (reinterpret_cast<uintptr_t>(src) & 15));
      stage<T>(reinterpret_cast<unsigned char*>(cv), src,
               static_cast<int64_t>(m) * C * sizeof(T));
      copy_async_wait();
      __syncthreads();
      for (int cc = tid; cc < C; cc += THREADS) {
        T acc = sacc[cc];
        for (int r = 0; r < m; ++r) acc += cv[r * C + cc];
        sacc[cc] = acc;
      }
      if (m < B_rows) break;
    }
    for (int cc = tid; cc < C; cc += THREADS) ol[s_last * C + cc] = sacc[cc];
  }
}

template <typename T>
cudaError_t launch(const void* values, const void* seg, int64_t B, int64_t N,
                   int64_t S, int C, int rows, int buf_rows, int64_t blocks,
                   int probes, void* out, cudaStream_t stream) {
  const int64_t width = static_cast<int64_t>(C) * sizeof(T);
  if (rows < 1 || buf_rows < rows || buf_rows > TILE_ROWS ||
      (buf_rows + 1) * width > TILE_BYTES || probes < 1 ||
      probes > PROBES_MAX || blocks < 1 || blocks > 0x7fffffffL ||
      blocks * rows < N || B > 65535) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = 16 + static_cast<size_t>(buf_rows + 1) * width;
  segment_sum_kernel<T>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(B)),
         THREADS, smem, stream>>>(
          static_cast<const T*>(values), static_cast<const int64_t*>(seg), N,
          S, C, rows, buf_rows, probes, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// values (B, N, C) float32 (is_double 0) or float64 (1) and seg (B, N)
// int64 on `device`, both contiguous; writes out (B, S, C) of the values'
// type.  rows (a tile), buf_rows (staged at a time), blocks (per lane) and
// probes (per thread in a later search round) come from
// ops/cuda_segsum.py segsum_geometry.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int segment_sum_launch(const void* values, const void* seg,
                                  int64_t B, int64_t N, int64_t S, int C,
                                  int is_double, int rows, int buf_rows,
                                  int64_t blocks, int probes, void* out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 0 || N < 0 || S < 0 || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = is_double ? launch<double>(values, seg, B, N, S, C, rows, buf_rows,
                                   blocks, probes, out, st)
                  : launch<float>(values, seg, B, N, S, C, rows, buf_rows,
                                  blocks, probes, out, st);
  return static_cast<int>(err);
}
