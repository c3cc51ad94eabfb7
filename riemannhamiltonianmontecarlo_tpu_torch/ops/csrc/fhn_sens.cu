// FitzHugh-Nagumo log density, gradient, metric and metric derivative for
// Hopper (sm_90a): the RK4 sensitivity system of every chain in one launch.
//
// Replaces the JAX package's autodiff through its fixed-step RK4 lax.scan,
// riemannhamiltonianmontecarlo_tpu/models/fhn.py: integrate_rk4 (:55-85) under
// jax.grad (:149-156), jacfwd (:129-134) and jacfwd of jacfwd (:169-182).
// There is no Pallas kernel behind it.  Python wrapper, checks and the
// plain-PyTorch twin: ops/fhn_sens.py.
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
// 2 (860 an RK4 step and 186 an observation a chain, counted from this
// source by ops/fhn_sens.py::operations), 3.4 us at 67 TFLOP/s.  What binds
// is the one sequence of 995 RK4 steps each chain has to walk: a chain of
// dependent operations through V and R at every stage (orders 0 and 1), and
// at order 2 also the issue of one thread's instructions.  On the H100 a
// call takes 0.07 / 0.13 / 0.52 ms at orders 0 / 1 / 2 whether it holds 32
// chains or 4,224 (one warp on each SM), 115-255 times its FLOP bound
// (chip_smoke.py phase 10).  What the design does about it:
//   * one thread per chain, its augmented state (2 numbers at order 0, 8 at
//     order 1, 20 at order 2) and its running sums in registers for the
//     whole integration: no memory traffic inside the loop but the data;
//   * the order is a template parameter, so an order-0 or order-1 call does
//     none of the higher orders' work and holds none of their registers;
//   * the (num_obs, 2) data is staged once per block in shared memory; all
//     threads read the same observation at the same time (a broadcast);
//   * blocks of 32 threads, so a few hundred chains spread over that many
//     SMs and no two warps of a batch of up to 4,224 chains share one;
//   * every step is taken: no early exit on a non-finite state, so a chain
//     that overflows gives the same non-finite entries as the twin, and no
//     data-dependent branch anywhere, masks only.
// Spreading one chain's sensitivity columns over several lanes would cut
// the instructions a thread issues; not done here.
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
// rounding.  The step constants are the JAX model's (h, h/2 and h/6 in
// double, then rounded to float).  nvcc contracts multiply-adds into FMAs
// (no fast-math), so results differ from the twin in the last bits.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxObs = 6144;  // 2 * 4 * 6144 bytes = 48 KB of shared data
constexpr int kPairs = 6;      // (i, j), i <= j: 00 01 02 11 12 22
constexpr float kThird = 1.0f / 3.0f;

__host__ __device__ constexpr int pair_of(int i, int j) {
  return i > j ? pair_of(j, i) : i == 0 ? j : i == 1 ? 2 + j : 5;
}

// The augmented state: y, then S (order >= 1), then T (order 2).
template <int Order>
struct Aug {
  float v, r;
  float sv[Order >= 1 ? 3 : 1], sr[Order >= 1 ? 3 : 1];
  float tv[Order >= 2 ? kPairs : 1], tr[Order >= 2 ? kPairs : 1];
};

struct Theta {
  float a, b, c, inv_c, inv_c2, inv_c3;
};

// out = y + s * k, field by field.
template <int Order>
__device__ __forceinline__ void axpy(const Aug<Order>& y, float s, const Aug<Order>& k, Aug<Order>& out) {
  out.v = y.v + s * k.v;
  out.r = y.r + s * k.r;
  if constexpr (Order >= 1) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out.sv[j] = y.sv[j] + s * k.sv[j], out.sr[j] = y.sr[j] + s * k.sr[j];
  }
  if constexpr (Order >= 2) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) out.tv[p] = y.tv[p] + s * k.tv[p], out.tr[p] = y.tr[p] + s * k.tr[p];
  }
}

// acc = acc + w * k (w = 1 or 2: the RK4 weights k1 + 2 k2 + 2 k3 + k4).
template <int Order>
__device__ __forceinline__ void accumulate(Aug<Order>& acc, float w, const Aug<Order>& k) {
  axpy<Order>(acc, w, k, acc);
}

// k = the augmented right-hand side at y.
template <int Order>
__device__ __forceinline__ void rhs(const Theta& th, const Aug<Order>& y, Aug<Order>& k) {
  const float v = y.v, r = y.r;
  const float v2 = v * v;
  const float cubic = v - v * v * v * kThird + r;
  const float lin = v - th.a + th.b * r;
  k.v = th.c * cubic;
  k.r = -lin * th.inv_c;
  if constexpr (Order >= 1) {
    // Jacobian df/dy = [[c (1 - V^2), c], [-1/c, -b/c]]; df/dtheta = [[0, 0, cubic], [1/c, -R/c, lin/c^2]].
    const float jvv = th.c * (1.0f - v2), jrr = -th.b * th.inv_c;
    const float fr[3] = {th.inv_c, -r * th.inv_c, lin * th.inv_c2};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      k.sv[j] = jvv * y.sv[j] + th.c * y.sr[j] + (j == 2 ? cubic : 0.0f);
      k.sr[j] = -th.inv_c * y.sv[j] + jrr * y.sr[j] + fr[j];
    }
    if constexpr (Order >= 2) {
      // V: d2f/dV2 = -2 c V; d2f/(dy dc) . S_j = (1 - V^2) SV_j + SR_j (0 for a, b).
      // R: d2f/(dy dtheta_i) . S_j = 0, -SR_j / c, (SV_j + b SR_j) / c^2 for i = a, b, c;
      //    d2f/dtheta2 = -1/c^2 at (a, c), R/c^2 at (b, c), -2 lin / c^3 at (c, c).
      const float fvv = -2.0f * th.c * v;
      float q[3], row_b[3], row_c[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        q[j] = (1.0f - v2) * y.sv[j] + y.sr[j];
        row_b[j] = -y.sr[j] * th.inv_c;
        row_c[j] = (y.sv[j] + th.b * y.sr[j]) * th.inv_c2;
      }
      const float hess_r[kPairs] = {0.0f, 0.0f, -th.inv_c2, 0.0f, r * th.inv_c2, -2.0f * lin * th.inv_c3};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = i; j < 3; ++j) {
          const int p = pair_of(i, j);
          // mix(i, j) + mix(j, i): only the terms whose theta index is a parameter the row depends on
          const float mix_v = (j == 2 ? (i == 2 ? q[2] + q[2] : q[i]) : 0.0f);
          const float mix_r = (i == 0 ? 0.0f : i == 1 ? row_b[j] : row_c[j]) +
                              (j == 0 ? 0.0f : j == 1 ? row_b[i] : row_c[i]);
          k.tv[p] = jvv * y.tv[p] + th.c * y.tr[p] + fvv * y.sv[i] * y.sv[j] + mix_v;
          k.tr[p] = -th.inv_c * y.tv[p] + jrr * y.tr[p] + mix_r + hess_r[p];
        }
      }
    }
  }
}

template <int Order>
__device__ __forceinline__ void rk4_step(const Theta& th, Aug<Order>& y, float h, float half_h, float sixth_h) {
  Aug<Order> k, stage, acc;
  rhs<Order>(th, y, k);  // k1
  acc = k;
  axpy<Order>(y, half_h, k, stage);
  rhs<Order>(th, stage, k);  // k2
  accumulate<Order>(acc, 2.0f, k);
  axpy<Order>(y, half_h, k, stage);
  rhs<Order>(th, stage, k);  // k3
  accumulate<Order>(acc, 2.0f, k);
  axpy<Order>(y, h, k, stage);
  rhs<Order>(th, stage, k);  // k4
  accumulate<Order>(acc, 1.0f, k);
  axpy<Order>(y, sixth_h, acc, y);
}

// Running sums over the observation times, in registers.
template <int Order>
struct Sums {
  float sq = 0.0f;
  bool finite = true;
  float grad[3] = {0.0f, 0.0f, 0.0f};
  float g[kPairs] = {};
  float dg[Order >= 2 ? 3 : 1][kPairs] = {};

  __device__ __forceinline__ void observe(const Aug<Order>& y, float data_v, float data_r) {
    const float ev = data_v - y.v, er = data_r - y.r;
    sq += ev * ev + er * er;
    finite = finite && isfinite(y.v) && isfinite(y.r);
    if constexpr (Order >= 1) {
#pragma unroll
      for (int i = 0; i < 3; ++i) grad[i] += ev * y.sv[i] + er * y.sr[i];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = i; j < 3; ++j) g[pair_of(i, j)] += y.sv[i] * y.sv[j] + y.sr[i] * y.sr[j];
    }
    if constexpr (Order >= 2) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = i; j < 3; ++j)
            dg[k][pair_of(i, j)] += y.tv[pair_of(i, k)] * y.sv[j] + y.sv[i] * y.tv[pair_of(j, k)] +
                                    y.tr[pair_of(i, k)] * y.sr[j] + y.sr[i] * y.tr[pair_of(j, k)];
    }
  }
};

template <int Order>
__global__ void __launch_bounds__(kThreads)
    fhn_sensitivities_kernel(const float* __restrict__ theta, const float* __restrict__ data, int num_chains,
                             int num_obs, int substeps, float h, float half_h, float sixth_h, float noise_var,
                             float gamma_scale, float v0, float r0, float* __restrict__ logp,
                             float* __restrict__ grad, float* __restrict__ metric, float* __restrict__ dmetric) {
  extern __shared__ float obs[];  // (num_obs, 2), the block's copy of the data
  for (int e = threadIdx.x; e < 2 * num_obs; e += kThreads) obs[e] = data[e];
  __syncthreads();
  const int chain = blockIdx.x * kThreads + threadIdx.x;
  if (chain >= num_chains) return;  // no barrier or shuffle follows

  const float a = theta[3 * chain], b = theta[3 * chain + 1], c = theta[3 * chain + 2];
  const float inv_c = 1.0f / c, inv_c2 = inv_c * inv_c;
  const Theta th{a, b, c, inv_c, inv_c2, inv_c2 * inv_c};

  Aug<Order> y;
  y.v = v0, y.r = r0;
  if constexpr (Order >= 1) {
#pragma unroll
    for (int j = 0; j < 3; ++j) y.sv[j] = 0.0f, y.sr[j] = 0.0f;
  }
  if constexpr (Order >= 2) {
#pragma unroll
    for (int p = 0; p < kPairs; ++p) y.tv[p] = 0.0f, y.tr[p] = 0.0f;
  }

  Sums<Order> sums;
  sums.observe(y, obs[0], obs[1]);
  for (int t = 1; t < num_obs; ++t) {
    for (int s = 0; s < substeps; ++s) rk4_step<Order>(th, y, h, half_h, sixth_h);
    sums.observe(y, obs[2 * t], obs[2 * t + 1]);
  }

  const bool valid = a > 0.0f && b > 0.0f && c > 0.0f && sums.finite;
  logp[chain] = valid ? -0.5f * sums.sq / noise_var - (a + b + c) / gamma_scale : -CUDART_INF_F;
  if constexpr (Order >= 1) {
    const float t3[3] = {a, b, c};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float gi = sums.grad[i] / noise_var - 1.0f / gamma_scale;
      grad[3 * chain + i] = valid && isfinite(gi) ? gi : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        metric[9 * chain + 3 * i + j] = sums.g[pair_of(i, j)] / noise_var + (i == j ? 2.0f / (t3[i] * t3[i]) : 0.0f);
    }
    if constexpr (Order >= 2) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            dmetric[27 * chain + 9 * k + 3 * i + j] =
                sums.dg[k][pair_of(i, j)] / noise_var +
                (i == k && j == k ? -4.0f / (t3[k] * t3[k] * t3[k]) : 0.0f);
    }
  }
}

template <int Order>
cudaError_t launch(const float* theta, const float* data, int num_chains, int num_obs, int substeps, double h,
                   float noise_var, float gamma_scale, float v0, float r0, float* logp, float* grad,
                   float* metric, float* dmetric, cudaStream_t stream) {
  const int blocks = (num_chains + kThreads - 1) / kThreads;
  const size_t shared = sizeof(float) * 2 * num_obs;
  fhn_sensitivities_kernel<Order><<<blocks, kThreads, shared, stream>>>(
      theta, data, num_chains, num_obs, substeps, static_cast<float>(h), static_cast<float>(0.5 * h),
      static_cast<float>(h / 6.0), noise_var, gamma_scale, v0, r0, logp, grad, metric, dmetric);
  return cudaGetLastError();
}

}  // namespace

// order 0: logp; 1: + grad, metric; 2: + dmetric.  Pointers past the order may be null.
extern "C" int rhmc_fhn_sensitivities(int order, const void* theta, const void* data, int num_chains,
                                      int num_obs, int substeps, double h, float noise_var, float gamma_scale,
                                      float v0, float r0, void* logp, void* grad, void* metric, void* dmetric,
                                      void* stream) {
  if (num_chains < 1 || num_obs < 2 || num_obs > kMaxObs || substeps < 1) return cudaErrorInvalidValue;
  if (order < 0 || order > 2 || !logp || (order >= 1 && (!grad || !metric)) || (order == 2 && !dmetric))
    return cudaErrorInvalidValue;
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
