// lm_solve: every Levenberg-Marquardt iteration of one odometry solve in
// one launch, one thread block per solve.
//
// Replaces no Pallas kernel: the JAX package leaves lm_solve
// (light_loam_tpu/solver/gauss_newton.py) to XLA, which fuses the loop.
// Op by op in PyTorch the same loop is ~590 kernels an iteration (slerp,
// rotation matrices, skew products, Huber weights, einsums, the Cholesky),
// each over 768 or 1536 factors of a few KB; inside a CUDA graph each such
// node still costs ~1.5-1.9 us of the card's time whatever it computes,
// and the odometry's 6 x 8 iterations a sweep were ~28,000 nodes, ~40 ms.
//
// What it computes: light_loam_tpu_torch/solver/gauss_newton.py _lm_loop
// with FactorSet(edge, plane), in float32, expression for expression but
// for FMA contraction and the order of the sums:
//   p' = slerp(I, q, s) cp + s t; edge r = ((p'-a) x (p'-b)) / |a-b|,
//   plane r = (p'-j) . n, with weight * mask baked into r and J;
//   Ceres's Huber rho (delta), IRLS weight rho'(|r|^2) * mask;
//   H (21 sums), g (6 sums); (H + lam diag(H) + 1e-9 I) delta = -g by a
//   6x6 Cholesky and two triangular solves; a failed (non-positive or NaN
//   pivot) or non-finite solve takes a zero step; q <- normalize(q (x)
//   Exp(dtheta)), t <- t + dt; the cost 0.5 sum rho * mask at the new
//   pose; accept iff it falls and the active factors reach min_factors;
//   lam x 1/3 on accept, x 4 on reject.  Output (q, t, cost) per lane.
//
// What bounds it on an H100: latency, not bytes or operations.  The work
// is ~2 x 2304 factors x ~300 FLOP an iteration (~1.4 MFLOP), the inputs
// ~115 KB read once; one SM does that in a few microseconds.  What costs
// is the chain: each iteration is two passes over the factors, each ending
// in a block-wide sum, and a serial 6x6 solve between them.
//
// Design:
//  * One block of 512 threads per solve (blockIdx.x = lane: B vmapped
//    lanes are B blocks of one launch).  Thread i owns factors i, i + 512,
//    ... (edges first, then planes), so a warp diverges at most at the
//    boundary between the families.
//  * The inputs are read from device memory once, into structure-of-arrays
//    form with the per-factor constants (weight x mask, mask, 1/|a-b|),
//    13 floats an edge and 12 a plane (113,664 bytes at 768 + 1536 factors),
//    in dynamic shared memory when the wrapper finds they fit (opting in
//    above 48 KB), else in a global scratch buffer the wrapper allocates.
//    Every pass reads them from there.
//  * Each pass ends in one block sum: warp shuffles, then one row of
//    partial sums per warp in shared memory, added in warp order by one
//    thread per value.  The order is fixed, so a run repeats itself bit
//    for bit, and a lane's result does not depend on the other lanes.
//  * Thread 0 builds the damped system, factors and solves it, updates
//    the pose and decides acceptance; the pose, cost and lambda pass to
//    the other threads through shared memory.
//  * Nothing is read to the host: q0, t0 and every factor are device
//    tensors, the outputs are written by thread 0, and the launch goes on
//    the caller's stream, so it is captured into a CUDA graph like any
//    other kernel.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int EDGE_FLOATS = 13;   // cp 3, a 3, b 3, s, weight x mask, mask, 1/|a-b|
constexpr int PLANE_FLOATS = 12;  // cp 3, j 3, n 3, s, weight x mask, mask
constexpr int NH = 21;            // lower triangle of H
constexpr int NHG = NH + 6;       // and g
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* q0;
  const float* t0;
  const float* e_cp;
  const float* e_a;
  const float* e_b;
  const float* e_s;
  const float* e_w;
  const unsigned char* e_m;
  const float* p_cp;
  const float* p_j;
  const float* p_n;
  const float* p_s;
  const float* p_w;
  const unsigned char* p_m;
  int ne, np, n_iter;
  float min_factors;
  float delta, delta_sq, two_delta, lambda0;
  float* q_out;
  float* t_out;
  float* cost_out;
  float* scratch;   // B x lane_floats, when the inputs are not staged
  int staged;
};

// torch.clamp semantics: NaN passes through (fminf / fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The pose of one pass and the parts of slerp(I, q, s) that do not depend
// on s (core/quaternion.py quat_slerp_identity).
struct Pose {
  float q[4], t[3];
  float sign, theta, safe_sin;
  bool small;
};

__device__ Pose make_pose(const float* q, const float* t) {
  Pose P;
  for (int i = 0; i < 4; ++i) P.q[i] = q[i];
  for (int i = 0; i < 3; ++i) P.t[i] = t[i];
  const float w = clamp_to(q[3], -1.f, 1.f);
  P.sign = w < 0.f ? -1.f : 1.f;
  P.theta = acosf(clamp_to(fabsf(w), 0.f, 1.f));
  const float sin_theta = sinf(P.theta);
  P.small = sin_theta < 1e-6f;
  P.safe_sin = P.small ? 1.f : sin_theta;
  return P;
}

// p' = slerp(I, q, s) cp + s t, and the rotation matrix of the slerp when
// R != nullptr (solver/residuals.py _transform_with_jac).
__device__ void transform(const Pose& P, const float cp[3], float s,
                          float p[3], float* R) {
  float c_id, c_q;
  if (P.small) {
    c_id = 1.f - s;
    c_q = s;
  } else {
    c_id = sinf((1.f - s) * P.theta) / P.safe_sin;
    c_q = sinf(s * P.theta) / P.safe_sin;
  }
  const float k = c_q * P.sign;
  float x = k * P.q[0], y = k * P.q[1], z = k * P.q[2];
  float w = c_id + k * P.q[3];
  const float n = clamp_min(sqrtf(x * x + y * y + z * z + w * w), 1e-12f);
  x /= n;
  y /= n;
  z /= n;
  w /= n;
  const float v[3] = {x, y, z};
  float c1[3], c2[3];
  cross(v, cp, c1);
  cross(v, c1, c2);
  for (int i = 0; i < 3; ++i) {
    p[i] = cp[i] + 2.f * (w * c1[i] + c2[i]) + s * P.t[i];
  }
  if (R != nullptr) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    R[0] = 1.f - 2.f * (yy + zz);
    R[1] = 2.f * (xy - wz);
    R[2] = 2.f * (xz + wy);
    R[3] = 2.f * (xy + wz);
    R[4] = 1.f - 2.f * (xx + zz);
    R[5] = 2.f * (yz - wx);
    R[6] = 2.f * (xz - wy);
    R[7] = 2.f * (yz + wx);
    R[8] = 1.f - 2.f * (xx + yy);
  }
}

// Ceres's HuberLoss (gauss_newton.py _huber_rho): rho(s2) and rho'(s2).
__device__ __forceinline__ void huber(const Params& prm, float s2,
                                      float& rho, float& drho) {
  const float sqrt_s = sqrtf(clamp_min(s2, 1e-24f));
  const bool small = s2 <= prm.delta_sq;
  rho = small ? s2 : prm.two_delta * sqrt_s - prm.delta_sq;
  drho = small ? 1.f : prm.delta / sqrt_s;
}

// One factor's weighted residual r (D entries) and Jacobian J (D x 6),
// from the staged columns F (column c of factor f at F[c * n + f]).
template <bool EDGE>
__device__ void residual(const Pose& P, const float* F, int n, int f,
                         float r[3], float J[3][6], bool with_jac) {
  const float cp[3] = {F[f], F[n + f], F[2 * n + f]};
  const float s = F[9 * n + f];
  const float w = F[10 * n + f];
  float p[3], R[9];
  transform(P, cp, s, p, with_jac ? R : nullptr);
  // Jp = [-(R [cp]x) s | s I]: row i of R [cp]x is R_i x cp
  float Jrot[3][3];
  if (with_jac) {
    for (int i = 0; i < 3; ++i) {
      float rc[3];
      cross(&R[3 * i], cp, rc);
      for (int j = 0; j < 3; ++j) Jrot[i][j] = -rc[j] * s;
    }
  }
  if (EDGE) {
    const float a[3] = {F[3 * n + f], F[4 * n + f], F[5 * n + f]};
    const float b[3] = {F[6 * n + f], F[7 * n + f], F[8 * n + f]};
    const float inv_norm = F[12 * n + f];
    const float u[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
    const float v[3] = {p[0] - b[0], p[1] - b[1], p[2] - b[2]};
    float uv[3];
    cross(u, v, uv);
    for (int i = 0; i < 3; ++i) r[i] = uv[i] * inv_norm * w;
    if (with_jac) {
      // d(u x v)/dp' = [b - a]x
      const float e[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      const float D[3][3] = {
          {0.f, -e[2] * inv_norm, e[1] * inv_norm},
          {e[2] * inv_norm, 0.f, -e[0] * inv_norm},
          {-e[1] * inv_norm, e[0] * inv_norm, 0.f}};
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
          J[i][j] = (D[i][0] * Jrot[0][j] + D[i][1] * Jrot[1][j] +
                     D[i][2] * Jrot[2][j]) * w;
          J[i][3 + j] = D[i][j] * s * w;
        }
      }
    }
  } else {
    const float jx = F[3 * n + f], jy = F[4 * n + f], jz = F[5 * n + f];
    const float nn[3] = {F[6 * n + f], F[7 * n + f], F[8 * n + f]};
    r[0] = ((p[0] - jx) * nn[0] + (p[1] - jy) * nn[1] + (p[2] - jz) * nn[2]) *
           w;
    if (with_jac) {
      for (int j = 0; j < 3; ++j) {
        J[0][j] = (nn[0] * Jrot[0][j] + nn[1] * Jrot[1][j] +
                   nn[2] * Jrot[2][j]) * w;
        J[0][3 + j] = nn[j] * s * w;
      }
    }
  }
}

// Adds one factor's robustified contribution to H (lower triangle) and g.
template <int D>
__device__ __forceinline__ void accumulate(const Params& prm, const float r[3],
                                           const float J[3][6], float m,
                                           float acc[NHG]) {
  float s2 = 0.f;
  for (int i = 0; i < D; ++i) s2 += r[i] * r[i];
  float rho, drho;
  huber(prm, s2, rho, drho);
  const float ww = drho * m;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    int k = 0;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const float jw = J[i][d] * ww;
#pragma unroll
      for (int e = 0; e <= d; ++e) acc[k++] += jw * J[i][e];
      acc[NH + d] += jw * r[i];
    }
  }
}

// Sums v[0..N) over the block in a fixed order; every thread gets the sums
// in out[0..N) after the call.
template <int N>
__device__ void block_sum(float (&v)[N], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_down_sync(FULL, v[k], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// sum rho * mask of each family at pose P: (edges, planes).
__device__ void cost_pass(const Params& prm, const Pose& P, const float* E,
                          const float* Pl, float acc[2]) {
  float J[3][6];
  float r[3];
  acc[0] = acc[1] = 0.f;
  const int total = prm.ne + prm.np;
  for (int f = threadIdx.x; f < total; f += THREADS) {
    float rho, drho;
    if (f < prm.ne) {
      residual<true>(P, E, prm.ne, f, r, J, false);
      huber(prm, r[0] * r[0] + r[1] * r[1] + r[2] * r[2], rho, drho);
      acc[0] += rho * E[11 * prm.ne + f];
    } else {
      const int g = f - prm.ne;
      residual<false>(P, Pl, prm.np, g, r, J, false);
      huber(prm, r[0] * r[0], rho, drho);
      acc[1] += rho * Pl[11 * prm.np + g];
    }
  }
}

__device__ void normal_pass(const Params& prm, const Pose& P, const float* E,
                            const float* Pl, float acc[NHG]) {
  float J[3][6];
  float r[3];
#pragma unroll
  for (int k = 0; k < NHG; ++k) acc[k] = 0.f;
  const int total = prm.ne + prm.np;
  for (int f = threadIdx.x; f < total; f += THREADS) {
    if (f < prm.ne) {
      residual<true>(P, E, prm.ne, f, r, J, true);
      accumulate<3>(prm, r, J, E[11 * prm.ne + f], acc);
    } else {
      const int g = f - prm.ne;
      residual<false>(P, Pl, prm.np, g, r, J, true);
      accumulate<1>(prm, r, J, Pl[11 * prm.np + g], acc);
    }
  }
}

// (H + lam diag(H) + 1e-9 I) delta = -g by Cholesky (LAPACK potf2's order)
// and two triangular solves; false if a pivot is not positive or the
// step is not finite.
__device__ bool solve6(const float* hg, float lam, float delta[6]) {
  float L[6][6];
  int k = 0;
  for (int d = 0; d < 6; ++d) {
    for (int e = 0; e <= d; ++e) L[d][e] = hg[k++];
    L[d][d] = (L[d][d] + lam * L[d][d]) + 1e-9f;
  }
  for (int j = 0; j < 6; ++j) {
    float s = L[j][j];
    for (int c = 0; c < j; ++c) s -= L[j][c] * L[j][c];
    if (!(s > 0.f)) return false;
    const float d = sqrtf(s);
    L[j][j] = d;
    for (int i = j + 1; i < 6; ++i) {
      float v = L[i][j];
      for (int c = 0; c < j; ++c) v -= L[i][c] * L[j][c];
      L[i][j] = v / d;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float v = -hg[NH + i];
    for (int c = 0; c < i; ++c) v -= L[i][c] * y[c];
    y[i] = v / L[i][i];
  }
  bool finite = true;
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
    for (int c = i + 1; c < 6; ++c) v -= L[c][i] * delta[c];
    delta[i] = v / L[i][i];
    finite &= isfinite(delta[i]);
  }
  return finite;
}

// q (x) Exp(phi), normalized (core/quaternion.py quat_exp, quat_multiply,
// quat_normalize).
__device__ void retract(const float q[4], const float phi[3], float out[4]) {
  const float angle =
      sqrtf(phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2] + 1e-24f);
  const float half = 0.5f * angle;
  const bool small = angle < 1e-8f;
  const float k = small ? 0.5f : sinf(half) / angle;
  const float x2 = k * phi[0], y2 = k * phi[1], z2 = k * phi[2];
  const float w2 = cosf(half);
  const float x1 = q[0], y1 = q[1], z1 = q[2], w1 = q[3];
  float o[4] = {w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2};
  const float n = clamp_min(
      sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]), 1e-12f);
  for (int i = 0; i < 4; ++i) out[i] = o[i] / n;
}

__global__ void __launch_bounds__(THREADS) lm_solve_kernel(const Params prm) {
  extern __shared__ float staged[];
  __shared__ float red[WARPS * NHG];
  __shared__ float sums[NHG];
  __shared__ float s_q[4], s_t[3], s_qn[4], s_tn[3];
  __shared__ float s_cost, s_lam;
  __shared__ bool s_solvable;

  const int b = blockIdx.x;
  const int ne = prm.ne, np = prm.np;
  const long lane_floats = EDGE_FLOATS * static_cast<long>(ne) +
                           PLANE_FLOATS * static_cast<long>(np);
  float* E = prm.staged ? staged : prm.scratch + b * lane_floats;
  float* Pl = E + EDGE_FLOATS * ne;

  // stage the lane's factors, structure of arrays, with their constants
  float count = 0.f;
  for (int f = threadIdx.x; f < ne; f += THREADS) {
    const long i = static_cast<long>(b) * ne + f;
    float a[3], bb[3];
    for (int c = 0; c < 3; ++c) {
      E[c * ne + f] = prm.e_cp[3 * i + c];
      a[c] = prm.e_a[3 * i + c];
      bb[c] = prm.e_b[3 * i + c];
      E[(3 + c) * ne + f] = a[c];
      E[(6 + c) * ne + f] = bb[c];
    }
    const float m = prm.e_m[i] ? 1.f : 0.f;
    const float de[3] = {a[0] - bb[0], a[1] - bb[1], a[2] - bb[2]};
    E[9 * ne + f] = prm.e_s[i];
    E[10 * ne + f] = prm.e_w[i] * m;
    E[11 * ne + f] = m;
    E[12 * ne + f] =
        1.f / clamp_min(sqrtf(de[0] * de[0] + de[1] * de[1] + de[2] * de[2]),
                        1e-12f);
    count += m;
  }
  for (int f = threadIdx.x; f < np; f += THREADS) {
    const long i = static_cast<long>(b) * np + f;
    for (int c = 0; c < 3; ++c) {
      Pl[c * np + f] = prm.p_cp[3 * i + c];
      Pl[(3 + c) * np + f] = prm.p_j[3 * i + c];
      Pl[(6 + c) * np + f] = prm.p_n[3 * i + c];
    }
    const float m = prm.p_m[i] ? 1.f : 0.f;
    Pl[9 * np + f] = prm.p_s[i];
    Pl[10 * np + f] = prm.p_w[i] * m;
    Pl[11 * np + f] = m;
    count += m;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) s_q[i] = prm.q0[4 * b + i];
    for (int i = 0; i < 3; ++i) s_t[i] = prm.t0[3 * b + i];
  }
  __syncthreads();

  // the cost at (q0, t0) and the active factors
  {
    float acc[3];
    cost_pass(prm, make_pose(s_q, s_t), E, Pl, acc);
    acc[2] = count;
    block_sum<3>(acc, red, sums);
    if (threadIdx.x == 0) {
      s_cost = 0.5f * sums[0] + 0.5f * sums[1];
      s_lam = prm.lambda0;
      s_solvable = sums[2] >= prm.min_factors;
    }
    __syncthreads();
  }

  for (int it = 0; it < prm.n_iter; ++it) {
    float acc[NHG];
    normal_pass(prm, make_pose(s_q, s_t), E, Pl, acc);
    block_sum<NHG>(acc, red, sums);
    if (threadIdx.x == 0) {
      float delta[6];
      if (!solve6(sums, s_lam, delta)) {
        for (int i = 0; i < 6; ++i) delta[i] = 0.f;
      }
      retract(s_q, delta, s_qn);
      for (int i = 0; i < 3; ++i) s_tn[i] = s_t[i] + delta[3 + i];
    }
    __syncthreads();

    float cacc[2];
    cost_pass(prm, make_pose(s_qn, s_tn), E, Pl, cacc);
    block_sum<2>(cacc, red, sums);
    if (threadIdx.x == 0) {
      const float new_cost = 0.5f * sums[0] + 0.5f * sums[1];
      if (new_cost < s_cost && s_solvable) {
        for (int i = 0; i < 4; ++i) s_q[i] = s_qn[i];
        for (int i = 0; i < 3; ++i) s_t[i] = s_tn[i];
        s_cost = new_cost;
        s_lam = s_lam * (1.f / 3.f);
      } else {
        s_lam = s_lam * 4.f;
      }
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) prm.q_out[4 * b + i] = s_q[i];
    for (int i = 0; i < 3; ++i) prm.t_out[3 * b + i] = s_t[i];
    prm.cost_out[b] = s_cost;
  }
}

}  // namespace

// B lanes of one solve each: q0 (B,4), t0 (B,3); edges cp, a, b (B,Ne,3),
// s, weight (B,Ne) f32 and mask (B,Ne) bool; planes cp, j, n (B,Np,3), s,
// weight (B,Np) f32 and mask (B,Np) bool; all contiguous on `device`.
// Writes q (B,4), t (B,3), cost (B,).  smem_bytes > 0 stages each lane's
// factors in that much dynamic shared memory (at least 4 (13 Ne + 12 Np)
// bytes); 0 stages them in `scratch`, B (13 Ne + 12 Np) floats.  Launches
// on `stream`; returns cudaGetLastError().
extern "C" int lm_solve_launch(
    const void* q0, const void* t0, const void* e_cp, const void* e_a,
    const void* e_b, const void* e_s, const void* e_w, const void* e_m,
    const void* p_cp, const void* p_j, const void* p_n, const void* p_s,
    const void* p_w, const void* p_m, int B, int ne, int np, int n_iter,
    int min_factors, float delta, float delta_sq, float two_delta,
    float lambda0, void* q_out, void* t_out, void* cost_out, void* scratch,
    int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  const long need =
      4L * (EDGE_FLOATS * static_cast<long>(ne) +
            PLANE_FLOATS * static_cast<long>(np));
  if (ne < 0 || np < 0 || n_iter < 0 || smem_bytes < 0 ||
      (smem_bytes > 0 && smem_bytes < need) ||
      (smem_bytes == 0 && need > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(lm_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Params prm;
  prm.q0 = static_cast<const float*>(q0);
  prm.t0 = static_cast<const float*>(t0);
  prm.e_cp = static_cast<const float*>(e_cp);
  prm.e_a = static_cast<const float*>(e_a);
  prm.e_b = static_cast<const float*>(e_b);
  prm.e_s = static_cast<const float*>(e_s);
  prm.e_w = static_cast<const float*>(e_w);
  prm.e_m = static_cast<const unsigned char*>(e_m);
  prm.p_cp = static_cast<const float*>(p_cp);
  prm.p_j = static_cast<const float*>(p_j);
  prm.p_n = static_cast<const float*>(p_n);
  prm.p_s = static_cast<const float*>(p_s);
  prm.p_w = static_cast<const float*>(p_w);
  prm.p_m = static_cast<const unsigned char*>(p_m);
  prm.ne = ne;
  prm.np = np;
  prm.n_iter = n_iter;
  prm.min_factors = static_cast<float>(min_factors);
  prm.delta = delta;
  prm.delta_sq = delta_sq;
  prm.two_delta = two_delta;
  prm.lambda0 = lambda0;
  prm.q_out = static_cast<float*>(q_out);
  prm.t_out = static_cast<float*>(t_out);
  prm.cost_out = static_cast<float*>(cost_out);
  prm.scratch = static_cast<float*>(scratch);
  prm.staged = smem_bytes > 0;
  lm_solve_kernel<<<B, THREADS, smem_bytes, static_cast<cudaStream_t>(
                                               stream)>>>(prm);
  return cudaGetLastError();
}
