// The Holmes-Held Gibbs step's two loops for Hopper (sm_90a).
//
// Neither replaces a Pallas kernel: both replace JAX control flow of
// riemannhamiltonianmontecarlo_tpu/samplers/gibbs.py and ops/gig.py, so that
// a Gibbs step is a fixed sequence of launches that a CUDA graph can hold.
//   G1 rhmc_gibbs_sweep <- the sequential z / B sweep, a lax.scan over the N
//      data points (samplers/gibbs.py:102-124).  Python wrapper, checks and
//      plain-PyTorch version: samplers/gibbs.py (gibbs_sweep_cuda,
//      gibbs_sweep_plain).
//   G2 rhmc_gig_round   <- one round of the GIG rejection sampler, the body of
//      a lax.while_loop with both squeeze series (ops/gig.py:42-115, :143-168).
//      Wrapper and plain version: ops/gig.py (gig_round_cuda, gig_round_plain).
//
// Both mirror their plain versions operation by operation as PyTorch's CUDA
// kernels round them: every product and sum that the plain version computes
// as its own tensor op is rounded on its own here too (__fmul_rn / __fadd_rn
// / __fsub_rn, which nvcc never contracts into an FMA), a tensor divided by a
// Python scalar is a product with the scalar's float reciprocal (as PyTorch's
// CUDA division by a CPU scalar is), a Python scalar divided by a tensor is
// the tensor's reciprocal times the scalar (Tensor.__rtruediv__), ndtr is
// (1 + erf(x sqrt(1/2))) / 2 (torch.special.ndtr) and ndtri is the Cephes
// polynomial of ATen's calc_ndtri, copied below.  Only the sweep's dot
// product B . x_j is summed in another order (the plain version's is
// cuBLAS's gemv).  So results agree with the plain version to rounding,
// except where a value within rounding of a threshold takes the other branch
// (chip_smoke.py phase 3 counts such elements).
//
// G1, what bounds it on an H100: the sequence.  Each chain walks N dependent
// steps (z_j's mean reads B, which every earlier step updated), and a step's
// longest chain of dependent operations -- the dot, the conditional mean, the
// truncated normal's ndtr and ndtri, the rank-one update of B -- is 43
// operations on the central path at D = 15 (chip_smoke.py::
// sweep_dependent_operations, each library call counted as one): ~60 us at
// N = 690 and 1,980 MHz, against ~17 us to move its bytes once at 3.35 TB/s
// (1024 chains, D = 15).  Measured, a step takes ~0.9 us (0.63 ms a sweep
// at (1024, 690, 15) on an H100): the library calls (erff, logf, sqrtf, the
// IEEE divisions) are tens of dependent instructions each, and the lanes of
// a warp that take ndtri's two branches run them one after the other.  The
// step's memory traffic is not what it waits on: against the first form
// (below), a variant reading chain-minor copies of its inputs (every load one
// 128-byte line) took the same time, and one staging chunks of steps in
// shared memory with cp.async, double-buffered, took longer, its copies
// issued by the same warp that runs the chain (PERF.md).  What the design
// does:
//   * one thread per chain, B in registers, D a compile-time constant for
//     every D <= 48, so nothing is masked: 0.63 ms a sweep at (1024, 690,
//     15) where a first form, D at run time with every entry of a capacity
//     of 16 masked by it, took 1.11 ms (PERF.md).  A group
//     of lanes per chain would make the D-long dot a shuffle tree (~5 shuffles
//     at ~30 cycles each) where one thread's tree of 4 partial sums is ~6
//     FMAs; the truncated normal is one lane's work either way;
//   * blocks of one warp, so 1024 chains are 32 warps on 32 SMs, each warp
//     with a scheduler and an L1 of its own.  A sweep takes about as long
//     for 32 chains as for 4,224, a warp on each of the card's 528
//     schedulers (kernel_ab.py --kernels gibbs, PERF.md);
//   * the public layouts as they are, no copy: S (C, D, N), lambda, h and
//     z_old (C, N), the uniforms (N, C).  A thread's rows are contiguous in
//     j, so a 32-byte sector serves 8 consecutive steps from L1;
//   * the next step's x_j row, lambda, h and z_old and the central uniform
//     are loaded into registers while the current step computes, S's and
//     the rows' sectors 8 steps ahead are prefetched into L1 and the
//     uniforms' lines 4 steps ahead into L2, so their latency leaves the
//     dependent chain (without the prefetches a sweep took longer, most
//     at D = 25);
//   * the two paths of the truncated normal are branches: a chain takes the
//     tail path (a > 3, three Rayleigh rounds) at few steps of a sweep, if
//     any, so only those pay for the tail's logs and square roots.
// No thread talks to another, so a thread past the last chain returns.
//
// G2, what bounds it: bytes.  A round reads every element's `ok` flag and,
// for an element not yet accepted, its r and three draws, and writes lambda
// and `ok` where it accepts; an accepted element returns at once, so the
// rounds after most elements are decided (most of a step's 64) read little
// more than the flags.  One thread per element, blocks of 256; each thread
// runs its own squeeze series until it decides or reaches the cap of bodies,
// so no element waits for another's series.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kSweepThreads = 32;  // G1: one warp a block, one chain a thread
constexpr int kRoundThreads = 256;  // G2: one element a thread
constexpr int kMaxDim = 48;  // ops/hopper_linalg.py::MAX_DIM
constexpr int kTailRounds = 3;  // ops/truncnorm.py::RETRY_ROUNDS
constexpr int kRowAhead = 8;  // G1: steps ahead of the L1 prefetch of the (C, N) and (C, D, N) rows
constexpr int kUniformAhead = 4;  // G1: steps ahead of the L2 prefetch of the (N, C) uniforms

// Constants as the plain versions' Python doubles reach a float32 tensor op.
constexpr float kTailSplit = 3.0f;  // ops/truncnorm.py::TAIL_SPLIT
constexpr float kLowClamp = -12.0f;
constexpr float kUMin = static_cast<float>(1e-30);
constexpr float kUMax = static_cast<float>(1.0 - 1e-7);
constexpr float kEMin = static_cast<float>(1e-7);  // ops/truncnorm.py::_E_MIN
constexpr float kEScale = static_cast<float>(1.0 - 1e-7);
constexpr float kSqrtHalf = static_cast<float>(0.70710678118654752440);  // M_SQRT1_2
constexpr float kGapMin = static_cast<float>(1e-12);  // the clamp of lambda_j - h_j
constexpr float kFourThirds = static_cast<float>(4.0 / 3.0);
constexpr float kLamMin = static_cast<float>(1e-12);
constexpr float kRootSqMin = static_cast<float>(1e-30);
constexpr double kPi = 3.14159265358979323846;
constexpr float kPi2 = static_cast<float>(kPi * kPi);
constexpr float kNegPi2 = static_cast<float>(-(kPi * kPi));
// 0.5 log 2 + 2.5 log pi, summed in double as the Python expression is
constexpr float kLeftConst = static_cast<float>(0.5 * 0.69314718055994530942 + 2.5 * 1.14472988584940017414);
constexpr float kLamSafeMin = static_cast<float>(1e-20);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// torch.clamp / torch.maximum: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp(float v, float lo, float hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ float maximum(float a, float b) { return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b); }

// -- ndtri: the Cephes polynomial of ATen's calc_ndtri (ATen/native/Math.h), in float --

__constant__ float kP0[5] = {-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
                             1.39312609387279679503E1, -1.23916583867381258016E0};
__constant__ float kQ0[9] = {1.00000000000000000000E0,  1.95448858338141759834E0,  4.67627912898881538453E0,
                             8.63602421390890590575E1,  -2.25462687854119370527E2, 2.00260212380060660359E2,
                             -8.20372256168333339912E1, 1.59056225126211695515E1,  -1.18331621121330003142E0};
__constant__ float kP1[9] = {4.05544892305962419923E0,  3.15251094599893866154E1,  5.71628192246421288162E1,
                             4.40805073893200834700E1,  1.46849561928858024014E1,  2.18663306850790267539E0,
                             -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4};
__constant__ float kQ1[9] = {1.00000000000000000000E0,  1.57799883256466749731E1,  4.53907635128879210584E1,
                             4.13172038254672030440E1,  1.50425385692907503408E1,  2.50464946208309415979E0,
                             -1.42182922854787788574E-1, -3.80806407691578277194E-2, -9.33259480895457427372E-4};
__constant__ float kP2[9] = {3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
                             1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
                             3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9};
__constant__ float kQ2[9] = {1.00000000000000000000E0, 6.02427039364742014255E0, 3.67983563856160859403E0,
                             1.37702099489081330271E0, 2.16236993594496635890E-1, 1.34204006088543189037E-2,
                             3.28014464682127739104E-4, 2.89247864745380683936E-6, 6.79019408009981274425E-9};

template <int Len>
__device__ __forceinline__ float polevl(float x, const float (&a)[Len]) {
  float result = 0.0f;
#pragma unroll
  for (int i = 0; i < Len; ++i) result = result * x + a[i];
  return result;
}

__device__ __forceinline__ float ndtri(float y0) {
  // double constants rounded to float, as the template's T{...} rounds them
  constexpr float s2pi = static_cast<float>(2.50662827463100050242E0);
  constexpr float exp_m2 = static_cast<float>(0.13533528323661269189);  // exp(-2)
  if (y0 == 0.0f) return -CUDART_INF_F;
  if (y0 == 1.0f) return CUDART_INF_F;
  if (y0 < 0.0f || y0 > 1.0f) return CUDART_NAN_F;
  bool code = true;
  float y = y0;
  if (y > 1.0f - exp_m2) {
    y = 1.0f - y;
    code = false;
  }
  if (y > exp_m2) {
    y = y - 0.5f;
    const float y2 = y * y;
    const float x = y + y * (y2 * polevl(y2, kP0) / polevl(y2, kQ0));
    return x * s2pi;
  }
  float x = sqrtf(-2.0f * logf(y));
  const float x0 = x - logf(x) / x;
  const float z = 1.0f / x;
  const float x1 = x < 8.0f ? z * polevl(z, kP1) / polevl(z, kQ1) : z * polevl(z, kP2) / polevl(z, kQ2);
  x = x0 - x1;
  return code ? -x : x;
}

// -- G1: the sweep -----------------------------------------------------------------

// z ~ N(0, 1) conditioned on z > a, from the step's uniforms: ops/truncnorm.py::std_truncnorm_above.
__device__ __forceinline__ float std_truncnorm_above(float a, float u_central, const float* __restrict__ u_e,
                                                     const float* __restrict__ u_tail, size_t round_stride) {
  if (a > kTailSplit) {
    // Tail: Rayleigh candidates sqrt(a^2 - 2 log e), the first accepted one wins, else the last.
    const float a_t = clamp_min(a, kTailSplit);
    for (int r = 0;; ++r) {
      const float e = clamp_min(add(mul(__ldg(u_e + r * round_stride), kEScale), kEMin), kEMin);
      const float cand = sqrtf(add(mul(-2.0f, logf(e)), mul(a_t, a_t)));
      if (r == kTailRounds - 1 || __ldg(u_tail + r * round_stride) <= a_t / cand) return cand;
    }
  }
  // Central: inverse CDF on [ndtr(a), 1).
  const float a_c = clamp(a, kLowClamp, kTailSplit);
  const float lo = mul(add(1.0f, erff(mul(a_c, kSqrtHalf))), 0.5f);
  const float u = add(lo, mul(u_central, sub(1.0f, lo)));
  return maximum(ndtri(clamp(u, kUMin, kUMax)), a_c);
}

__device__ __forceinline__ void prefetch_l1(const float* p) { asm volatile("prefetch.global.L1 [%0];" ::"l"(p)); }
__device__ __forceinline__ void prefetch_l2(const float* p) { asm volatile("prefetch.global.L2 [%0];" ::"l"(p)); }

// Per chain c, for j = 0..N-1 in order (samplers/gibbs.py::gibbs_sweep_plain):
//   w = h_j / max(lambda_j - h_j, 1e-12), std = sqrt(lambda_j (w + 1)), s = +-std by the label,
//   m = (1 + w) (B . x_j) - w z_old_j, z_j = m + s TN_above(-m / s), B += (z_j - z_old_j) / lambda_j S[c, :, j].
template <int Dim>
__global__ void __launch_bounds__(kSweepThreads) gibbs_sweep_kernel(
    const float* __restrict__ x, const float* __restrict__ t, const float* __restrict__ lam,
    const float* __restrict__ h, const float* __restrict__ z_old, const float* __restrict__ s,
    const float* __restrict__ b_in, const float* __restrict__ u_central, const float* __restrict__ u_e,
    const float* __restrict__ u_tail, int num_chains, int num_data, float* __restrict__ b_out,
    float* __restrict__ z_out) {
  const int c = blockIdx.x * kSweepThreads + threadIdx.x;
  if (c >= num_chains) return;
  const size_t n = num_data, cn = static_cast<size_t>(num_chains);
  const float* lam_c = lam + c * n;
  const float* h_c = h + c * n;
  const float* z_old_c = z_old + c * n;
  const float* s_c = s + c * Dim * n;
  float* z_c = z_out + c * n;
  const size_t round_stride = n * cn;  // between the tail rounds of u_e / u_tail

  float b[Dim], x_next[Dim], s_j[Dim];
#pragma unroll
  for (int i = 0; i < Dim; ++i) {
    b[i] = b_in[c * Dim + i];
    x_next[i] = __ldg(x + i);
  }
  float lam_next = __ldg(lam_c), h_next = __ldg(h_c), z_old_next = __ldg(z_old_c);
  float uc_next = __ldg(u_central + c), t_next = __ldg(t);

  for (int j = 0; j < num_data; ++j) {
    // B . x_j: four partial sums (the D-long dot is on the dependent chain)
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < Dim; ++i) part[i % 4] = fmaf(b[i], x_next[i], part[i % 4]);
    const float dot = (part[0] + part[1]) + (part[2] + part[3]);
    const float lam_j = lam_next, h_j = h_next, z_old_j = z_old_next, uc_j = uc_next, t_j = t_next;

    // What step j+1 starts from, and S[c, :, j] for the end of this step.
    const int jn = j + 1 < num_data ? j + 1 : j;
#pragma unroll
    for (int i = 0; i < Dim; ++i) {
      x_next[i] = __ldg(x + jn * Dim + i);
      s_j[i] = __ldg(s_c + i * n + j);
    }
    lam_next = __ldg(lam_c + jn), h_next = __ldg(h_c + jn), z_old_next = __ldg(z_old_c + jn);
    uc_next = __ldg(u_central + jn * cn + c), t_next = __ldg(t + jn);
    if (j + kRowAhead < num_data) {
      prefetch_l1(lam_c + j + kRowAhead), prefetch_l1(h_c + j + kRowAhead), prefetch_l1(z_old_c + j + kRowAhead);
#pragma unroll
      for (int i = 0; i < Dim; ++i) prefetch_l1(s_c + i * n + j + kRowAhead);
    }
    if (j + kUniformAhead < num_data) prefetch_l2(u_central + (j + kUniformAhead) * cn + c);

    // The step's constants (none of them on B's chain).
    const float w = h_j / clamp_min(sub(lam_j, h_j), kGapMin);
    const float sd = sqrtf(mul(lam_j, add(w, 1.0f)));
    const float signed_sd = t_j == 1.0f ? sd : -sd;
    const float bound_scale = -(1.0f / signed_sd);
    const float neg_w_z_old = mul(-w, z_old_j);

    const float m = add(neg_w_z_old, mul(add(1.0f, w), dot));
    const float z_std = std_truncnorm_above(mul(m, bound_scale), uc_j, u_e + j * cn + c, u_tail + j * cn + c,
                                            round_stride);
    const float z_j = add(m, mul(signed_sd, z_std));
    z_c[j] = z_j;
    const float delta = mul(sub(z_j, z_old_j), 1.0f / lam_j);
#pragma unroll
    for (int i = 0; i < Dim; ++i) b[i] = add(b[i], mul(delta, s_j[i]));
  }
#pragma unroll
  for (int i = 0; i < Dim; ++i) b_out[c * Dim + i] = b[i];
}

// Calls f(std::integral_constant<int, d>) for 1 <= d <= kMaxDim: one instantiation of G1 per width.
template <int Dim = 1, typename F>
cudaError_t with_sweep_width(int d, F&& f) {
  if constexpr (Dim < kMaxDim) {
    if (d != Dim) return with_sweep_width<Dim + 1>(d, f);
  }
  return f(std::integral_constant<int, Dim>{});
}

// -- G2: one GIG rejection round ------------------------------------------------------

// The rightmost series (lambda > 4/3), ops/gig.py::_rightmost_terms.  Returns accepted; *decided.
__device__ __forceinline__ bool rightmost_accept(float u, float lam, int max_bodies, bool* decided) {
  const float x_log = mul(-0.5f, lam);  // log X, X = exp(-lambda / 2)
  float z = 1.0f, j = 1.0f;
  for (int body = 0; body < max_bodies; ++body, j += 2.0f) {
    const float n1 = j + 1.0f, n2 = j + 2.0f;  // subtract term 2, 4, ...; add term 3, 5, ...
    const float z_sub = sub(z, mul(n1 * n1, expf(mul(x_log, n1 * n1 - 1.0f))));
    const float z_add = add(z_sub, mul(n2 * n2, expf(mul(x_log, n2 * n2 - 1.0f))));
    if (z_sub > u) return *decided = true;
    if (z_add < u) {
      *decided = true;
      return false;
    }
    z = z_add;
  }
  return false;
}

// The leftmost series (lambda <= 4/3) in the transformed domain, ops/gig.py::_leftmost_terms.
__device__ __forceinline__ bool leftmost_accept(float u, float lam, int max_bodies, bool* decided) {
  const float lam_safe = clamp_min(lam, kLamSafeMin);
  const float inv_2lam = 1.0f / mul(2.0f, lam_safe);
  const float h = add(sub(sub(kLeftConst, mul(2.5f, logf(lam_safe))), mul(inv_2lam, kPi2)), mul(0.5f, lam_safe));
  const float log_u = logf(u);
  const float x_log = mul(inv_2lam, kNegPi2);  // log X
  const float k = mul(lam_safe, 1.0f / kPi2);
  float z = 1.0f, j = 1.0f;
  for (int body = 0; body < max_bodies; ++body, j += 2.0f) {
    const float n2 = j + 2.0f;
    const float z_sub = sub(z, mul(k, expf(mul(x_log, j * j - 1.0f))));
    const float z_add = add(z_sub, mul(n2 * n2, expf(mul(x_log, n2 * n2 - 1.0f))));
    const float log_sub = z_sub > 0.0f ? logf(z_sub) : -CUDART_INF_F;
    const float log_add = z_add > 0.0f ? logf(z_add) : -CUDART_INF_F;
    if (add(h, log_sub) > log_u) return *decided = true;
    if (add(h, log_add) < log_u) {
      *decided = true;
      return false;
    }
    z = z_add;
  }
  return false;
}

// ops/gig.py::gig_round_plain for one element: a candidate from the round's three
// draws, accepted where its squeeze series decides to accept and it is finite.
__global__ void __launch_bounds__(kRoundThreads) gig_round_kernel(
    const float* __restrict__ r, const float* __restrict__ y0_normal, const float* __restrict__ u_side,
    const float* __restrict__ u, float* __restrict__ lam, unsigned char* __restrict__ ok, long long count,
    int max_bodies) {
  const long long e = blockIdx.x * static_cast<long long>(kRoundThreads) + threadIdx.x;
  if (e >= count || ok[e]) return;
  const float r_e = r[e], n_e = y0_normal[e];
  const float y0 = mul(n_e, n_e);
  const float four_r = mul(4.0f, r_e);
  // y = 4 r y0 / (y0 + sqrt(y0 (y0 + 4r)))^2, the rationalized proposal (no cancellation at small r)
  const float root = add(y0, sqrtf(mul(y0, add(y0, four_r))));
  const float y = mul(four_r, y0) / clamp_min(mul(root, root), kRootSqMin);
  // y0 = 0 gives y = 0 and lambda = r / 0 = inf: rejected below as not finite, redrawn next round.
  float cand = u_side[e] <= 1.0f / add(1.0f, y) ? r_e / y : mul(r_e, y);
  cand = clamp_min(cand, kLamMin);
  bool decided = false;
  const float u_e = u[e];
  const bool accepted = cand > kFourThirds ? rightmost_accept(u_e, cand, max_bodies, &decided)
                                           : leftmost_accept(u_e, cand, max_bodies, &decided);
  if (decided && accepted && isfinite(cand)) {
    lam[e] = cand;
    ok[e] = 1;
  }
}

}  // namespace

// B (C, D) and z (C, N) after the sweep.  x (N, D); t (N,) labels; lambda, h,
// z_old (C, N); s (C, D, N); b_in (C, D); u_central (N, C); u_e, u_tail (3, N, C).
extern "C" int rhmc_gibbs_sweep(const void* x, const void* t, const void* lam, const void* h, const void* z_old,
                                const void* s, const void* b_in, const void* u_central, const void* u_e,
                                const void* u_tail, int num_chains, int num_data, int dim, void* b_out, void* z_out,
                                void* stream) {
  if (num_chains < 1 || num_data < 1 || dim < 1 || dim > kMaxDim) return cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* st = static_cast<cudaStream_t>(stream);
  auto* bo = static_cast<float*>(b_out);
  auto* zo = static_cast<float*>(z_out);
  const int blocks = (num_chains + kSweepThreads - 1) / kSweepThreads;
  return with_sweep_width(dim, [&](auto width) {
    gibbs_sweep_kernel<decltype(width)::value><<<blocks, kSweepThreads, 0, st>>>(
        f(x), f(t), f(lam), f(h), f(z_old), f(s), f(b_in), f(u_central), f(u_e), f(u_tail), num_chains, num_data, bo,
        zo);
    return cudaGetLastError();
  });
}

// One rejection round over `count` elements: lambda and ok (bool, one byte) updated in place.
extern "C" int rhmc_gig_round(const void* r, const void* y0_normal, const void* u_side, const void* u, void* lam,
                              void* ok, long long count, int max_bodies, void* stream) {
  if (count < 1 || max_bodies < 1) return cudaErrorInvalidValue;
  const long long blocks = (count + kRoundThreads - 1) / kRoundThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gig_round_kernel<<<static_cast<unsigned>(blocks), kRoundThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(y0_normal), static_cast<const float*>(u_side),
      static_cast<const float*>(u), static_cast<float*>(lam), static_cast<unsigned char*>(ok), count, max_bodies);
  return cudaGetLastError();
}
