// FitzHugh-Nagumo log density, gradient, metric and metric derivative for
// Hopper (sm_90a): the RK4 sensitivity system of every chain in one launch.
//
// Replaces the JAX package's autodiff through its fixed-step RK4 lax.scan,
// riemannhamiltonianmontecarlo_tpu/models/fhn.py: integrate_rk4 (:55-85) under
// jax.grad (:149-156), jacfwd (:129-134) and jacfwd of jacfwd (:169-182).
// There is no Pallas kernel behind it.  Python wrapper, checks, the launch
// geometry's mirror and the plain-PyTorch twin: ops/fhn_sens.py.
//
// What it computes, for theta = (a, b, c) and y = (V, R):
//   dV/dt = c (V - V^3/3 + R),   dR/dt = -(V - a + b R) / c,   y(t0) = (v0, r0),
// integrated with (num_obs - 1) * substeps RK4 steps of h, together with
// S = dy/dtheta (2 x 3, order >= 1) and T = d2y/dtheta2 (2 x 6 by symmetry,
// order 2), whose right-hand sides are the derivatives of the one above
// (the authors' FitzHughNagumoSens1.m / Sens2.m systems).  RK4 applied to
// the augmented system is the exact derivative of RK4 applied to y, so this
// is jacfwd through the integrator up to rounding.  At each observation
// time t (t0 included, where S = T = 0), with e = data_t - y_t:
//   logp  = -1/2 sum |e|^2 / var - (a + b + c) / gamma_scale,
//           -inf where a theta <= 0 or the trajectory is not finite;
//   grad  = sum e . S / var - 1 / gamma_scale, the whole vector 0 where logp
//           is masked and each entry that is not finite 0 (jax.grad through
//           the jnp.where of fhn.py:126-127, then :152-154);
//   G     = sum S^T S / var + diag(2 / theta^2);
//   dG[k] = sum (T[., k] S + S T[., k]) / var, - 4 / theta_k^3 at [k][k][k].
// Outputs: logp (C,) always, grad (C, 3) and G (C, 3, 3) from order 1, dG
// (C, 3, 3, 3) at order 2; nothing per time point reaches device memory.
//
// What bounds it on an H100: neither bytes nor operations.  It reads 12
// bytes of theta and 8 * num_obs bytes of data and writes at most 160 bytes
// a chain; its operations at 200 x 5 and 256 chains are 0.23 GFLOP at order
// 2 (3.4 us at 67 TFLOP/s).  Each chain walks one sequence of 995 RK4 steps,
// and a step's longest chain of dependent operations in this source runs
// through V: 25 of them (ops/fhn_sens.py::_CHAIN_PER_STEP), 50.3 us at 4
// cycles each and 1,980 MHz, whatever the chain count or the layout (the
// source's critical path; the cubic written as FMAs would shorten it).
// With one thread per chain (the earlier design) order 0 sat at 0.75 of that
// path (67 us), but at orders 1 and 2 one thread issued every instruction of
// y, S and T, 170 and 541 a step (SASS), and its warp, alone on its
// scheduler, waited on its own issue (122 and 507 us).  Spread over lanes, a
// lane's step is 114 and 306 instructions: 84 and 223 us at 256 chains (0.59
// and 0.22 of the critical path; H100, kernel_ab.py).  Order 2 is still bound
// by one warp's issue.
// What the design does about it:
//   * a chain is a group of lanes of one warp, a power of two wide, so a
//     group is a fixed slice of its warp and shuffles take a static mask:
//       order 0: 1 lane, y alone (nothing to split);
//       order 1: 4 lanes; lane j < 3 integrates y and the column S_j, lane 3
//         repeats lane 2's work and writes nothing (the observation sums are
//         ~1% of the work, so giving them to lane 3 would save nothing);
//       order 2: 8 lanes; lane p < 6 owns the pair (i, j) = PAIRS[p] of T and
//         integrates y, S_i, S_j (all T_ij's right-hand side reads) and T_ij;
//         lanes 6 and 7 repeat lane 5 and write nothing.  (The other layout
//         measured, 4 lanes with lane k integrating y, all of S and T[., k],
//         issues 500 instructions a step: 332 us at 256 chains, 335 at
//         4,224, where this one's 8 warps an SM share 4 schedulers: 397.)
//     y is replicated, computed by the same instructions in every lane of a
//     group, so the lanes agree on it bit for bit;
//   * the lanes talk only at observation times: order 1 passes each column
//     to the lane before it (G[j][j+1]); order 2 broadcasts S_0, S_1, S_2
//     from the lanes of (0,0), (1,1), (2,2), and lane (i, j) sums T_ij S_c.
//     dG[k][i][j] = sum T_ik S_j + sum T_jk S_i is put together from those
//     sums by shuffles once, after the integration;
//   * which lane writes which output entry is owner() below, one lane each,
//     mirrored in Python (ops/fhn_sens.py::lane_outputs) and held against
//     this source on the card (chip_smoke.py phase 2);
//   * the order is the template parameter, so an order-0 or order-1 call does
//     none of the higher orders' work and holds none of their registers;
//   * up to kStagedMaxObs observations the (num_obs, 2) data is staged once
//     per block in shared memory (8 num_obs bytes, at most 48 KB); all lanes
//     read the same observation at the same time (a broadcast).  Past it the
//     data streams from device memory (Staged = false): each observation is
//     loaded (__ldg, one broadcast request a warp) an observation interval
//     before the sums read it, its cache line prefetched into L1
//     kPrefetchObs observations ahead, and a block takes no shared memory,
//     whatever num_obs.  Streaming every series was 2-4% slower at 200
//     observations, orders 1-2, and 27% at order 1 on 4,224 chains; a tile
//     of 256 observations refilled as the integration crossed it, 4-8%
//     slower there and 2-7% slower than streaming at 8,192 and 50,000
//     (kernel_ab.py, PERF.md);
//   * blocks of one warp (32, 8 or 4 chains by order), so 256 chains spread
//     over 8, 32 or 64 SMs;
//   * every step is taken: no early exit on a non-finite state, so a chain
//     that overflows gives the same non-finite entries as the twin, and no
//     data-dependent branch anywhere, masks only.  A lane past the last
//     chain integrates the last chain again and writes nothing, so every
//     lane of a warp takes part in every shuffle and no shuffle leaves its
//     chain's group: a chain's outputs do not depend on its neighbours.
//
// No division inside the loop.  An IEEE float division checks its operands
// and calls a slow-path routine for a NaN or infinite one; a chain whose
// trajectory has overflowed (a divergent proposal) then holds its whole warp
// on that path at every step: with the JAX model's V^3/3.0 and (...)/c the
// order-0 call took 0.93 ms at 256 chains with such a chain in the batch;
// with products it takes 0.07 ms, with the chain or without (H100,
// chip_smoke.py phase 10).
// So V^3/3 is V*V*V times float(1/3), and every /c a product with 1/c,
// computed once per chain; each differs from the division by at most one
// rounding.
//
// No branch inside the loop either.  A term that only some lanes' columns or
// pairs have is chosen by the lane's role masks (bits() / keep() below): a
// logic operation on the float's bits, never a multiplication by 0 (0 * inf
// is NaN where the twin adds 0) and never a ternary on the role, which nvcc
// compiled into branches inside the RK4 loop (21 of them at order 2): the
// lanes of a group hold different roles, so the warp ran every side in turn
// and the scheduler lost the instruction-level parallelism across the
// branches (order 2: 511-515 us against 226-228 with the masks, H100,
// kernel_ab.py).
// The step constants are the JAX model's (h, h/2 and h/6 in double,
// then rounded to float).  nvcc contracts multiply-adds into FMAs (no
// fast-math), so results differ from the twin in the last bits.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 32;          // one warp a block
constexpr int kStagedMaxObs = 6144;   // the most observations staged: 2 * 4 * 6144 bytes = 48 KB of shared data
constexpr int kPrefetchObs = 32;      // streamed: observations ahead of the data's L1 prefetch, two 128-byte lines
constexpr int kPairs = 6;      // (i, j), i <= j: 00 01 02 11 12 22
constexpr int kEntries = 40;   // a chain's output entries: logp, grad 3, G 9, dG 27
constexpr unsigned kWarpMask = 0xffffffffu;
constexpr float kThird = 1.0f / 3.0f;

__host__ __device__ constexpr int pair_of(int i, int j) {
  return i > j ? pair_of(j, i) : i == 0 ? j : i == 1 ? 2 + j : 5;
}
__host__ __device__ constexpr int pair_first(int p) { return p < 3 ? 0 : p < 5 ? 1 : 2; }
__host__ __device__ constexpr int pair_second(int p) { return p < 3 ? p : p < 5 ? p - 2 : 2; }

// Lanes of a chain's group, and how many of them own work, by order.
__host__ __device__ constexpr int lanes_per_chain(int order) { return order == 0 ? 1 : order == 1 ? 4 : 8; }
__host__ __device__ constexpr int working_lanes(int order) { return order == 0 ? 1 : order == 1 ? 3 : kPairs; }

// The lane of a chain's group that writes output entry e, -1 for an entry
// past the order.  Entries: logp 0, grad[i] 1 + i, G[i][j] 4 + 3 i + j,
// dG[k][i][j] 13 + 9 k + 3 i + j.  Order 1: lane j writes grad[j], G[j][j]
// and G[j][j+1 mod 3] both ways; order 2: lane p = (i, j) writes G and every
// dG[k] at (i, j) and (j, i), and grad[i] where i == j.
__host__ __device__ constexpr int owner(int order, int e) {
  if (e == 0) return 0;
  if (order == 0 || (order == 1 && e >= 13)) return -1;
  if (e < 4) return order == 1 ? e - 1 : pair_of(e - 1, e - 1);
  const int i = e < 13 ? (e - 4) / 3 : (e - 13) % 9 / 3, j = (e - 4) % 3;
  if (order == 2) return pair_of(i, j);
  return i == j || j == (i + 1) % 3 ? i : j;
}

struct Geometry {
  int lanes, chains_per_block, blocks;
  size_t shared_bytes;  // the block's copy of the data where it is staged, else none
};

__host__ __device__ constexpr bool staged(int num_obs) { return num_obs <= kStagedMaxObs; }

__host__ __device__ constexpr Geometry geometry(int order, int num_chains, int num_obs) {
  const int lanes = lanes_per_chain(order), chains = kThreads / lanes;
  return {lanes, chains, (num_chains + chains - 1) / chains,
          staged(num_obs) ? sizeof(float) * 2 * num_obs : 0};
}

// What one lane integrates: y, then the sensitivity columns it owns (order 1:
// S_j; order 2: S_i and S_j of its pair), then its second sensitivity T_ij.
template <int Order>
struct Aug {
  float v, r;
  float sv[Order >= 1 ? Order : 1], sr[Order >= 1 ? Order : 1];
  float tv, tr;  // order 2
};

struct Theta {
  float a, b, c, inv_c, inv_c2, inv_c3;
};

// A lane's place in its chain: the theta index of each column it integrates
// (order 2: its pair (i, j), i <= j) and the masks that choose its terms.
struct Role {
  int col[2];
  // all ones where the column is theta_a / _b / _c, else zero; all ones where
  // the pair is (a, c), (b, c), (c, c): the terms of d2f_R/dtheta2
  unsigned is_a[2], is_b[2], is_c[2];
  unsigned hess_ac, hess_bc, hess_cc;
};

__device__ __forceinline__ unsigned all_if(bool b) { return b ? ~0u : 0u; }
__device__ __forceinline__ Role make_role(int i, int j) {
  return {{i, j}, {all_if(i == 0), all_if(j == 0)}, {all_if(i == 1), all_if(j == 1)}, {all_if(i == 2), all_if(j == 2)},
          all_if(i == 0 && j == 2), all_if(i == 1 && j == 2), all_if(i == 2 && j == 2)};
}

// The bits of x where mask is all ones, +0.0f where it is zero: a select by
// the lane's role that is one logic operation, never a branch.
__device__ __forceinline__ unsigned bits(float x, unsigned mask) { return __float_as_uint(x) & mask; }
__device__ __forceinline__ float keep(float x, unsigned mask) { return __uint_as_float(bits(x, mask)); }

// out = y + s * k, field by field.
template <int Order>
__device__ __forceinline__ void axpy(const Aug<Order>& y, float s, const Aug<Order>& k, Aug<Order>& out) {
  out.v = y.v + s * k.v;
  out.r = y.r + s * k.r;
#pragma unroll
  for (int q = 0; q < Order; ++q) out.sv[q] = y.sv[q] + s * k.sv[q], out.sr[q] = y.sr[q] + s * k.sr[q];
  if constexpr (Order == 2) out.tv = y.tv + s * k.tv, out.tr = y.tr + s * k.tr;
}

// acc = acc + w * k (w = 1 or 2: the RK4 weights k1 + 2 k2 + 2 k3 + k4).
template <int Order>
__device__ __forceinline__ void accumulate(Aug<Order>& acc, float w, const Aug<Order>& k) {
  axpy<Order>(acc, w, k, acc);
}

// k = the lane's part of the augmented right-hand side at y.
template <int Order>
__device__ __forceinline__ void rhs(const Theta& th, const Role& role, const Aug<Order>& y, Aug<Order>& k) {
  const float v = y.v, r = y.r;
  const float v2 = v * v;
  const float cubic = v - v * v * v * kThird + r;
  const float lin = v - th.a + th.b * r;
  k.v = th.c * cubic;
  k.r = -lin * th.inv_c;
  if constexpr (Order >= 1) {
    // Jacobian df/dy = [[c (1 - V^2), c], [-1/c, -b/c]]; df/dtheta = [[0, 0, cubic], [1/c, -R/c, lin/c^2]].
    const float jvv = th.c * (1.0f - v2), jrr = -th.b * th.inv_c;
    const float fr_b = -r * th.inv_c, fr_c = lin * th.inv_c2;
#pragma unroll
    for (int q = 0; q < Order; ++q) {
      const float fr =
          __uint_as_float(bits(th.inv_c, role.is_a[q]) | bits(fr_b, role.is_b[q]) | bits(fr_c, role.is_c[q]));
      k.sv[q] = jvv * y.sv[q] + th.c * y.sr[q] + keep(cubic, role.is_c[q]);
      k.sr[q] = -th.inv_c * y.sv[q] + jrr * y.sr[q] + fr;
    }
    if constexpr (Order == 2) {
      // The pair (i, j) = (col[0], col[1]); S_i and S_j are columns 0 and 1.
      // V: d2f/dV2 = -2 c V; d2f/(dy dc) . S_j = (1 - V^2) SV_j + SR_j (0 for a, b).
      // R: d2f/(dy dtheta_i) . S_j = 0, -SR_j / c, (SV_j + b SR_j) / c^2 for i = a, b, c;
      //    d2f/dtheta2 = -1/c^2 at (a, c), R/c^2 at (b, c), -2 lin / c^3 at (c, c).
      const float fvv = -2.0f * th.c * v;
      const float q_i = (1.0f - v2) * y.sv[0] + y.sr[0], q_j = (1.0f - v2) * y.sv[1] + y.sr[1];
      const float row_b_i = -y.sr[0] * th.inv_c, row_c_i = (y.sv[0] + th.b * y.sr[0]) * th.inv_c2;
      const float row_b_j = -y.sr[1] * th.inv_c, row_c_j = (y.sv[1] + th.b * y.sr[1]) * th.inv_c2;
      // mix(i, j) + mix(j, i): only the terms whose theta index is a parameter the row depends on
      const float mix_v = keep(q_i, role.is_c[1]) + keep(q_j, role.is_c[0]);
      const float mix_r = __uint_as_float(bits(row_b_j, role.is_b[0]) | bits(row_c_j, role.is_c[0])) +
                          __uint_as_float(bits(row_b_i, role.is_b[1]) | bits(row_c_i, role.is_c[1]));
      const float hess_r = __uint_as_float(bits(-th.inv_c2, role.hess_ac) | bits(r * th.inv_c2, role.hess_bc) |
                                           bits(-2.0f * lin * th.inv_c3, role.hess_cc));
      k.tv = jvv * y.tv + th.c * y.tr + fvv * y.sv[0] * y.sv[1] + mix_v;
      k.tr = -th.inv_c * y.tv + jrr * y.tr + mix_r + hess_r;
    }
  }
}

template <int Order>
__device__ __forceinline__ void rk4_step(const Theta& th, const Role& role, Aug<Order>& y, float h, float half_h,
                                         float sixth_h) {
  Aug<Order> k, stage, acc;
  rhs<Order>(th, role, y, k);  // k1
  acc = k;
  axpy<Order>(y, half_h, k, stage);
  rhs<Order>(th, role, stage, k);  // k2
  accumulate<Order>(acc, 2.0f, k);
  axpy<Order>(y, half_h, k, stage);
  rhs<Order>(th, role, stage, k);  // k3
  accumulate<Order>(acc, 2.0f, k);
  axpy<Order>(y, h, k, stage);
  rhs<Order>(th, role, stage, k);  // k4
  accumulate<Order>(acc, 1.0f, k);
  axpy<Order>(y, sixth_h, acc, y);
}

// A lane's running sums over the observation times, in registers.
//   order 1: grad = sum e . S_j, g = sum S_j . S_j, g_next = sum S_j . S_{j+1};
//   order 2: grad = sum e . S_i, g = sum S_i . S_j, part[c] = sum T_ij . S_c.
template <int Order>
struct Sums {
  float sq = 0.0f;
  bool finite = true;
  float grad = 0.0f, g = 0.0f, g_next = 0.0f;
  float part[Order == 2 ? 3 : 1] = {};

  __device__ __forceinline__ void observe(const Aug<Order>& y, const Role& role, int lanes, float data_v,
                                         float data_r) {
    const float ev = data_v - y.v, er = data_r - y.r;
    sq += ev * ev + er * er;
    finite = finite && isfinite(y.v) && isfinite(y.r);
    if constexpr (Order >= 1) {
      grad += ev * y.sv[0] + er * y.sr[0];
      g += y.sv[0] * y.sv[Order - 1] + y.sr[0] * y.sr[Order - 1];
    }
    if constexpr (Order == 1) {
      // S_{j+1 mod 3} from the lane that integrates it (lane 3 takes lane 0's and ignores it)
      const int next = (role.col[0] + 1) % 3;
      const float nv = __shfl_sync(kWarpMask, y.sv[0], next, lanes), nr = __shfl_sync(kWarpMask, y.sr[0], next, lanes);
      g_next += y.sv[0] * nv + y.sr[0] * nr;
    }
    if constexpr (Order == 2) {
      // S_c from the lane of the pair (c, c), which integrates it as its column 0
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float sv = __shfl_sync(kWarpMask, y.sv[0], pair_of(c, c), lanes);
        const float sr = __shfl_sync(kWarpMask, y.sr[0], pair_of(c, c), lanes);
        part[c] += y.tv * sv + y.tr * sr;
      }
    }
  }
};

__device__ __forceinline__ float pick(const float (&x)[3], int i) { return i == 0 ? x[0] : i == 1 ? x[1] : x[2]; }

template <int Order, bool Staged>
__global__ void __launch_bounds__(kThreads)
    fhn_sensitivities_kernel(const float* __restrict__ theta, const float* __restrict__ data, int num_chains,
                             int num_obs, int substeps, float h, float half_h, float sixth_h, float noise_var,
                             float gamma_scale, float v0, float r0, float* __restrict__ logp,
                             float* __restrict__ grad, float* __restrict__ metric, float* __restrict__ dmetric) {
  constexpr int kLanes = lanes_per_chain(Order);
  extern __shared__ float obs[];  // (num_obs, 2), the block's copy of the data, where Staged
  if constexpr (Staged) {
    for (int e = threadIdx.x; e < 2 * num_obs; e += kThreads) obs[e] = data[e];
    __syncthreads();
  }
  const int lane = threadIdx.x % kLanes;
  const int slot = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  // A group past the last chain integrates the last chain again and writes
  // nothing: no lane leaves before the shuffles.
  const bool live = slot < num_chains;
  const int chain = live ? slot : num_chains - 1;

  const float a = theta[3 * chain], b = theta[3 * chain + 1], c = theta[3 * chain + 2];
  const float inv_c = 1.0f / c, inv_c2 = inv_c * inv_c;
  const Theta th{a, b, c, inv_c, inv_c2, inv_c2 * inv_c};
  const int work = lane < working_lanes(Order) ? lane : working_lanes(Order) - 1;  // spare lanes repeat the last
  const Role role = Order == 2 ? make_role(pair_first(work), pair_second(work)) : make_role(work, work);

  Aug<Order> y;
  y.v = v0, y.r = r0;
#pragma unroll
  for (int q = 0; q < Order; ++q) y.sv[q] = 0.0f, y.sr[q] = 0.0f;
  y.tv = 0.0f, y.tr = 0.0f;

  Sums<Order> sums;
  if constexpr (Staged) {
    sums.observe(y, role, kLanes, obs[0], obs[1]);
    for (int t = 1; t < num_obs; ++t) {
      for (int s = 0; s < substeps; ++s) rk4_step<Order>(th, role, y, h, half_h, sixth_h);
      sums.observe(y, role, kLanes, obs[2 * t], obs[2 * t + 1]);
    }
  } else {
    // Observation t + 1 is loaded while the steps to t run; its line comes into L1 kPrefetchObs earlier.
    sums.observe(y, role, kLanes, __ldg(data), __ldg(data + 1));
    const int last = num_obs - 1;
    float next_v = __ldg(data + 2), next_r = __ldg(data + 3);
    for (int t = 1; t < num_obs; ++t) {
      const float obs_v = next_v, obs_r = next_r;
      const size_t ahead = 2 * static_cast<size_t>(min(t + 1, last));
      next_v = __ldg(data + ahead), next_r = __ldg(data + ahead + 1);
      asm volatile("prefetch.global.L1 [%0];" ::"l"(data + 2 * static_cast<size_t>(min(t + kPrefetchObs, last))));
      for (int s = 0; s < substeps; ++s) rk4_step<Order>(th, role, y, h, half_h, sixth_h);
      sums.observe(y, role, kLanes, obs_v, obs_r);
    }
  }

  // Every lane of the group decides these from the same y and theta.
  const bool valid = a > 0.0f && b > 0.0f && c > 0.0f && sums.finite;
  const bool writes = live && lane < working_lanes(Order);
  if (writes && owner(Order, 0) == lane)
    logp[chain] = valid ? -0.5f * sums.sq / noise_var - (a + b + c) / gamma_scale : -CUDART_INF_F;
  if constexpr (Order >= 1) {
    const float t3[3] = {a, b, c};
    const int i = role.col[0];
    const float gi = sums.grad / noise_var - 1.0f / gamma_scale;
    const float ti = pick(t3, i);
    const float g_ii = sums.g / noise_var + 2.0f / (ti * ti);
    // off the diagonal, order 1: G[i][i+1] (both ways); order 2: G[i][j] (both ways)
    const float g_off = (Order == 1 ? sums.g_next : sums.g) / noise_var;
#pragma unroll
    for (int e = 1; e < 4; ++e)
      if (writes && owner(Order, e) == lane) grad[3 * chain + e - 1] = valid && isfinite(gi) ? gi : 0.0f;
#pragma unroll
    for (int e = 4; e < 13; ++e)
      if (writes && owner(Order, e) == lane) metric[9 * chain + e - 4] = (e - 4) % 4 == 0 ? g_ii : g_off;
    if constexpr (Order == 2) {
      // dG[k][i][j] = sum T_ik S_j + sum T_jk S_i: part[j] of the lane of (i, k) plus part[i] of the lane of (j, k).
      const int j = role.col[1];
      float dg[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int from_i = pair_of(i, k), from_j = pair_of(j, k);
        float at_i[3], at_j[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          at_i[q] = __shfl_sync(kWarpMask, sums.part[q], from_i, kLanes);
          at_j[q] = __shfl_sync(kWarpMask, sums.part[q], from_j, kLanes);
        }
        const float tk = t3[k];
        dg[k] = (pick(at_i, j) + pick(at_j, i)) / noise_var + (i == k && j == k ? -4.0f / (tk * tk * tk) : 0.0f);
      }
#pragma unroll
      for (int e = 13; e < kEntries; ++e)
        if (writes && owner(Order, e) == lane) dmetric[27 * chain + e - 13] = dg[(e - 13) / 9];
    }
  }
}

template <int Order>
cudaError_t launch(const float* theta, const float* data, int num_chains, int num_obs, int substeps, double h,
                   float noise_var, float gamma_scale, float v0, float r0, float* logp, float* grad,
                   float* metric, float* dmetric, cudaStream_t stream) {
  const Geometry geo = geometry(Order, num_chains, num_obs);
  const auto go = [&](auto kernel) {
    kernel<<<geo.blocks, kThreads, geo.shared_bytes, stream>>>(
        theta, data, num_chains, num_obs, substeps, static_cast<float>(h), static_cast<float>(0.5 * h),
        static_cast<float>(h / 6.0), noise_var, gamma_scale, v0, r0, logp, grad, metric, dmetric);
    return cudaGetLastError();
  };
  return staged(num_obs) ? go(fhn_sensitivities_kernel<Order, true>) : go(fhn_sensitivities_kernel<Order, false>);
}

bool bad_call(int order, int num_chains, int num_obs) {
  return order < 0 || order > 2 || num_chains < 1 || num_obs < 2;
}

}  // namespace

// order 0: logp; 1: + grad, metric; 2: + dmetric.  Pointers past the order may be null.
extern "C" int rhmc_fhn_sensitivities(int order, const void* theta, const void* data, int num_chains,
                                      int num_obs, int substeps, double h, float noise_var, float gamma_scale,
                                      float v0, float r0, void* logp, void* grad, void* metric, void* dmetric,
                                      void* stream) {
  if (bad_call(order, num_chains, num_obs) || substeps < 1) return cudaErrorInvalidValue;
  if (!logp || (order >= 1 && (!grad || !metric)) || (order == 2 && !dmetric)) return cudaErrorInvalidValue;
  const auto* th = static_cast<const float*>(theta);
  const auto* d = static_cast<const float*>(data);
  auto* lp = static_cast<float*>(logp);
  auto* gr = static_cast<float*>(grad);
  auto* g = static_cast<float*>(metric);
  auto* dg = static_cast<float*>(dmetric);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (order) {
    case 0: return launch<0>(th, d, num_chains, num_obs, substeps, h, noise_var, gamma_scale, v0, r0, lp, gr, g, dg, s);
    case 1: return launch<1>(th, d, num_chains, num_obs, substeps, h, noise_var, gamma_scale, v0, r0, lp, gr, g, dg, s);
    default: return launch<2>(th, d, num_chains, num_obs, substeps, h, noise_var, gamma_scale, v0, r0, lp, gr, g, dg, s);
  }
}

// out[0..4]: lanes per chain, chains per block, threads per block, blocks,
// shared bytes.  No launch; for the wrapper's mirror.
extern "C" int rhmc_fhn_launch_geometry(int order, int num_chains, int num_obs, int* out) {
  if (bad_call(order, num_chains, num_obs)) return cudaErrorInvalidValue;
  const Geometry geo = geometry(order, num_chains, num_obs);
  out[0] = geo.lanes, out[1] = geo.chains_per_block, out[2] = kThreads, out[3] = geo.blocks;
  out[4] = static_cast<int>(geo.shared_bytes);
  return cudaSuccess;
}

// out[0..39]: the lane of a chain's group that writes each output entry
// (logp, grad, G, dG flattened in that order), -1 past the order.  For the
// wrapper's mirror.
extern "C" int rhmc_fhn_output_owners(int order, int* out) {
  if (order < 0 || order > 2) return cudaErrorInvalidValue;
  for (int e = 0; e < kEntries; ++e) out[e] = owner(order, e);
  return cudaSuccess;
}
