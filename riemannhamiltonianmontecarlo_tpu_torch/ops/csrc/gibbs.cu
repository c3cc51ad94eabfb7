// The Holmes-Held Gibbs step's two loops for Hopper (sm_90a).
//
// Neither replaces a Pallas kernel: both replace JAX control flow of
// riemannhamiltonianmontecarlo_tpu/samplers/gibbs.py and ops/gig.py, so that
// a Gibbs step is a fixed sequence of launches that a CUDA graph can hold.
//   G1 rhmc_gibbs_sweep <- the sequential z / B sweep, a lax.scan over the N
//      data points (samplers/gibbs.py:112-124).  Python wrapper, checks and
//      plain-PyTorch version: samplers/gibbs.py (gibbs_sweep_cuda,
//      gibbs_sweep_plain).
//   G2 rhmc_gig_half    <- the whole GIG draw, the rejection lax.while_loop
//      with both squeeze series (ops/gig.py:125-176, body :143-168, series
//      :42-115).  Wrapper and plain version: ops/gig.py (sample_gig_half_cuda,
//      sample_gig_half_plain).
//   rhmc_gig_round, one rejection round from given draws (gig_round_cuda,
//      gig_round_plain), shares G2's round function and is off the Gibbs
//      step: it checks the round's arithmetic on its own.
//
// All mirror their plain versions operation by operation as PyTorch's CUDA
// kernels round them: every product and sum that the plain version computes
// as its own tensor op is rounded on its own here too (__fmul_rn / __fadd_rn
// / __fsub_rn, which nvcc never contracts into an FMA), a tensor divided by a
// Python scalar is a product with the scalar's float reciprocal (as PyTorch's
// CUDA division by a CPU scalar is), a Python scalar divided by a tensor is
// the tensor's reciprocal times the scalar (Tensor.__rtruediv__), ndtr is
// (1 + erf(x sqrt(1/2))) / 2 (torch.special.ndtr) and ndtri is the Cephes
// polynomial of ATen's calc_ndtri, copied below.  Only the sweep's dot
// products are summed in another order (the plain version's B . x_j is
// cuBLAS's gemv; here B_j . x_{j+1} + delta_j S_j . x_{j+1}, below).  So
// results agree with the plain version to rounding, except where a value
// within rounding of a threshold takes the other branch (chip_smoke.py
// phase 3 counts such elements).
//
// G1, what bounds it on an H100: the sequence.  Each chain walks N dependent
// steps (z_j's mean reads B, which every earlier step updated), and a step's
// chain of dependent operations -- the conditional mean, the truncated
// normal's ndtr and ndtri, delta -- is 36 operations on the central path
// (chip_smoke.py::sweep_dependent_operations, each library call counted as
// one): ~50 us at N = 690 and 1,980 MHz, against ~17 us to move its bytes
// once at 3.35 TB/s (1024 chains, D = 15).  A warp issues in order, so what
// it runs between two of the chain's operations adds to the step unless the
// compiler can interleave it, and it can only within a basic block: every
// IEEE division and square root (a slow path behind a branch), every branch
// of ndtri and every loop closes one.  One thread a chain, the dot on the
// chain, took ~1,800 cycles a step, its loop 671 SASS instructions with 73
// branches at D = 15 (kernel_ab.py --kernels gibbs, PERF.md).  What the
// design does:
//   * a chain on a group of `lanes` lanes of one warp (the wrapper chooses:
//     the most that keep the launch within two warps a scheduler, so 32 at
//     1024 chains, 8 at 4,224, 4 at 8,448 on an H100, and at least as many
//     as keep B's entries a lane within kEntMax), B's entries spread over
//     the group in registers, their count a lane at compile time (one
//     instantiation for each of 1..kEntMax; D itself comes at run time); the
//     scalar chain runs in every lane of the group with the same bits, so no
//     lane waits on another for it;
//   * the dot off the chain, by looking ahead: while step j's chain runs, the
//     group sums R = B_j . x_{j+1} and Q = S[:, j] . x_{j+1}, neither of which
//     reads z_j, over straight-line shuffles (a loop of them was a block the
//     warp waited on), and after it p_{j+1} = R + delta_j Q is one FMA; B's
//     update is off the chain too;
//   * every input of a step in registers a step before its use (S's column,
//     x_{j+1}, the uniform, the step's constants), the constants computed a
//     step ahead from inputs loaded two ahead (an empty asm keeps their
//     divisions there: nvcc would sink them onto the next step's chain); on
//     a whole warp a chain, a prologue writes the chain's constants for
//     every step to a scratch first, 32 steps at once, and a step reads its
//     six from one line (at 1024 chains ~20% faster than computing them in
//     the loop; with fewer lanes, more chains, their scratch outgrew L2 and
//     was slower);
//   * S's row sectors prefetched into L1 once every 8 steps (a prefetch a
//     step, each a lookup per lane's line, made 8,448 chains wait on L1),
//     the uniforms' lines 4 steps ahead into L2;
//   * ndtri with one branch, the central path against the tail: its early
//     returns, which cannot fire on the clamped u, left out, and the tail's
//     two rational functions one set of FMAs with the coefficients chosen.
//     Computing both paths and selecting was slower: the tail's two logs,
//     square root and three divisions on every step cost more than a branch
//     that a chain takes at ~27% of its steps;
//   * the truncated normal's Rayleigh tail (a > 3) a branch: few steps take it.
// A group past the last chain runs the last chain and writes nothing.
// Past 32 kEntMax entries, the wide layout: a chain on a block of W warps.  What bounds it is the same
// sequence plus the gather of S's column: a step reads one float from each of D rows of S that lie N floats
// apart, D cache lines through the SM's L1 a step, and the warps of a chain meet once a step to add their
// parts of the next dot.  An earlier form, a warp a chain with B in shared memory and one pass over B after
// each step's chain, took 3.6x the register layout's time at D 1,088 (PERF.md).  What the design does:
//   * B's entries in the registers of all the block's lanes (thread t owns t, t + 32 W, ...; at most kEntMax
//     each, W <= kWideWarps so that 255 registers a thread stay open), so no pass over memory: the register
//     layout's look-ahead runs in every lane as before, each warp's R and Q are summed over its lanes by
//     shuffles, and the warps' sums meet in shared memory, added in warp order, so every warp holds the same
//     bits;
//   * every warp runs the scalar chain itself on the same inputs, so all hold the same delta_j and none waits
//     for a hand-over; a warp writes its sums and arrives on an mbarrier before its chain, and waits on it
//     after, so the only serial work a step is the chain and one wait and sum across the warps;
//   * S's rows one sector ahead through L1 as on the register layout, each thread its own rows, so the D
//     lines of a step are spread over W warps' load queues;
//   * the step constants from a prologue of the whole block into the scratch, as on 32 lanes.
// Past the registers (D > kWideWarps 32 kEntMax), the same structure on kMemoryWarps warps with B in the block's
// shared memory (past the card's opt-in limit, in b_out): a pass over a thread's entries before each step's
// chain applies the last step's update and sums its parts of R and Q.  The three forms sum in one order, so at
// one W they give the same bits.  On an H100 at 64 chains, N 300 (kernel_ab.py --kernels gibbs, PERF.md): 3.4x
// the earlier form's speed at D 2,049, and at D 1,088 on 8 warps faster than the register layout; the time grows
// ~1 cycle a row of S and step, which points at the gather.  Slower there, and not kept: S's rows staged in
// shared memory by bulk copies, and one warp running the chain and handing delta_j over through an mbarrier.

// G2, what bounds it: operations, and how many rounds an element runs.  An
// element runs rejection rounds until its first accepted candidate (at most
// 64), each a Philox4x32-10 block (counter: the element's global index and
// the round; key: one int64 the caller drew), Box-Muller, the proposal and
// its squeeze series; its bytes are r in and lambda out (8 B an element:
// 1.7 us at (1024, 690) and 3.35 TB/s, against ~4.3 us for ~144 operations
// an element-round at 67 TFLOP/s, chip_smoke.py phase 3).  Elements take 1 to
// ~40 rounds (mean ~2.8 at r^2 log-uniform on [1e-4, 25]), so a warp of one
// element a lane would run as long as its slowest: a lane whose element is
// decided takes the warp's next (32 x 8 elements a warp), so the lanes stay
// busy.  No element waits for another's series, nothing is read by the host.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kSweepThreads = 32;  // G1: a warp; the register layout's blocks are one, a chain on 1 to 32 of its lanes
constexpr int kRoundThreads = 256;  // G2 and the single round: threads a block
// G1: the most entries of B a lane holds in registers (samplers/gibbs.py::SWEEP_ENT_MAX): past it the
// prologue's instantiations spill (8 B at 35 and 36, 254-255 registers), the others from 43 (ptxas
// -Xptxas -v on sm_90a; chip_smoke.py phase 2 holds the report).
constexpr int kEntMax = 34;
constexpr int kTailRounds = 3;  // ops/truncnorm.py::RETRY_ROUNDS
constexpr int kRowAhead = 8;  // G1: steps ahead of the L1 prefetch of S's (C, D, N) rows, one sector
constexpr int kUniformAhead = 4;  // G1: steps ahead of the L2 prefetch of the (N, C) uniforms
// G1's wide layout (samplers/gibbs.py::SWEEP_WIDE_WARPS, SWEEP_MEMORY_WARPS): the most warps a chain with B in
// registers (256 threads, so ptxas may give each 255 registers), and the warps a chain with B in memory.
constexpr int kWideWarps = 8;
constexpr int kMemoryWarps = 16;

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

// polevl with the coefficients of a or b, chosen per lane: the same FMAs as polevl(x, a) or polevl(x, b).
template <int Len>
__device__ __forceinline__ float polevl_either(float x, bool first, const float (&a)[Len], const float (&b)[Len]) {
  float result = 0.0f;
#pragma unroll
  for (int i = 0; i < Len; ++i) result = result * x + (first ? a[i] : b[i]);
  return result;
}

// double constants rounded to float, as the template's T{...} rounds them
constexpr float kS2Pi = static_cast<float>(2.50662827463100050242E0);
constexpr float kExpM2 = static_cast<float>(0.13533528323661269189);  // exp(-2)

// ATen's calc_ndtri for y0 in (0, 1) or NaN, all that the sweep passes it (u clamped to [1e-30, 1 - 1e-7]):
// its three early returns (0, 1 and outside [0, 1]) left out, which changes no result there, and the
// tail's two rational functions (x < 8 and x >= 8) one polevl_either each, the same FMAs as either.
// What is left is one branch, the central path against the tail.
__device__ __forceinline__ float ndtri(float y0) {
  bool code = true;
  float y = y0;
  if (y > 1.0f - kExpM2) {
    y = 1.0f - y;
    code = false;
  }
  if (y > kExpM2) {
    y = y - 0.5f;
    const float y2 = y * y;
    const float x = y + y * (y2 * polevl(y2, kP0) / polevl(y2, kQ0));
    return x * kS2Pi;
  }
  float x = sqrtf(-2.0f * logf(y));
  const float x0 = x - logf(x) / x;
  const float z = 1.0f / x;
  const bool near = x < 8.0f;
  const float x1 = z * polevl_either(z, near, kP1, kP2) / polevl_either(z, near, kQ1, kQ2);
  x = x0 - x1;
  return code ? -x : x;
}

// -- G1: the sweep -----------------------------------------------------------------

// z ~ N(0, 1) conditioned on z > a, from the step's uniforms: ops/truncnorm.py::std_truncnorm_above.
// The central path (inverse CDF on [ndtr(a), 1)) is computed for every lane; a lane with a > 3 then
// takes the tail's Rayleigh candidates sqrt(a^2 - 2 log e), the first accepted one, else the last.
__device__ __forceinline__ float std_truncnorm_above(float a, float u_central, const float* u_e, const float* u_tail,
                                                     size_t round_stride) {
  const float a_c = clamp(a, kLowClamp, kTailSplit);
  const float lo = mul(add(1.0f, erff(mul(a_c, kSqrtHalf))), 0.5f);
  float z = maximum(ndtri(clamp(add(lo, mul(u_central, sub(1.0f, lo))), kUMin, kUMax)), a_c);
  if (a > kTailSplit) {
    const float a_t = clamp_min(a, kTailSplit);
    for (int r = 0;; ++r) {
      const float e = clamp_min(add(mul(__ldg(u_e + r * round_stride), kEScale), kEMin), kEMin);
      const float cand = sqrtf(add(mul(-2.0f, logf(e)), mul(a_t, a_t)));
      if (r == kTailRounds - 1 || __ldg(u_tail + r * round_stride) <= a_t / cand) {
        z = cand;
        break;
      }
    }
  }
  return z;
}

__device__ __forceinline__ void prefetch_l1(const float* p) { asm volatile("prefetch.global.L1 [%0];" ::"l"(p)); }
__device__ __forceinline__ void prefetch_l2(const float* p) { asm volatile("prefetch.global.L2 [%0];" ::"l"(p)); }

// The step constants of one chain and step, as gibbs_sweep_plain computes them before its loop:
// w = h / max(lambda - h, 1e-12), std = sqrt(lambda (w + 1)), s = +-std by the label.
enum StepField { kOnePlusW, kNegWZOld, kBoundScale, kSignedSd, kInvLam, kZOld, kSweepFields };

__device__ __forceinline__ void step_constants(float lam_j, float h_j, float z_old_j, float t_j,
                                               float (&k)[kSweepFields]) {
  const float w = h_j / clamp_min(sub(lam_j, h_j), kGapMin);
  const float sd = sqrtf(mul(lam_j, add(w, 1.0f)));
  const float signed_sd = t_j == 1.0f ? sd : -sd;
  k[kOnePlusW] = add(1.0f, w);
  k[kNegWZOld] = mul(-w, z_old_j);
  k[kBoundScale] = -(1.0f / signed_sd);
  k[kSignedSd] = signed_sd;
  k[kInvLam] = 1.0f / lam_j;
  k[kZOld] = z_old_j;
}

// A chain's step constants of every step into k_c ([j][field]), `stride` threads `stride` steps at once, this
// one from step `first`.  The caller orders the writes before the reads (__syncwarp / __syncthreads).
__device__ __forceinline__ void write_step_constants(const float* lam_c, const float* h_c, const float* z_old_c,
                                                     const float* t, int num_data, float* k_c, int first,
                                                     int stride) {
  for (int j = first; j < num_data; j += stride) {
    float k[kSweepFields];
    step_constants(__ldg(lam_c + j), __ldg(h_c + j), __ldg(z_old_c + j), __ldg(t + j), k);
#pragma unroll
    for (int f = 0; f < kSweepFields; ++f) k_c[j * kSweepFields + f] = k[f];
  }
}

// One step's chain from p_j = B_j . x_j: the conditional mean m, z_j = m + s TN_above(-m / s), and
// delta_j = (z_j - z_old_j) / lambda_j into *delta.  Returns z_j.
__device__ __forceinline__ float chain_step(float p, const float (&k)[kSweepFields], float uc, const float* u_e_j,
                                            const float* u_tail_j, size_t round_stride, float* delta) {
  const float m = add(k[kNegWZOld], mul(k[kOnePlusW], p));
  const float z_std = std_truncnorm_above(mul(m, k[kBoundScale]), uc, u_e_j, u_tail_j, round_stride);
  const float z_j = add(m, mul(k[kSignedSd], z_std));
  *delta = mul(sub(z_j, k[kZOld]), k[kInvLam]);
  return z_j;
}

// The sum of v over a group of `lanes` lanes (a power of 2, the group aligned), in every lane of it.
// Each level adds two partial sums, which commute, so every lane holds the same bits.  The five
// levels are straight-line code, a level past the group adding 0 (v + 0 is v), so that the compiler
// can interleave the shuffles with the step's chain: a loop would be a block of its own, waited for.
__device__ __forceinline__ float group_sum(float v, int lanes) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, off);
    v += off < lanes ? other : 0.0f;
  }
  return v;
}

// Per chain c, for j = 0..N-1 in order (samplers/gibbs.py::gibbs_sweep_plain):
//   m = (1 + w_j) p_j - w_j z_old_j, z_j = m + s_j TN_above(-m / s_j), delta_j = (z_j - z_old_j) / lambda_j,
//   B += delta_j S[c, :, j],
// where p_j = B . x_j, B before step j.  A chain runs on a group of `lanes` lanes of one warp; lane l
// of the group holds B's entries l, l + lanes, ... (Ent of them; past D they are 0) and every lane of
// the group runs the step's scalar chain with the same bits.  The dot leaves the chain by looking
// one step ahead: while step j's chain runs, the group sums R = B_j . x_{j+1} and Q = S[:, j] . x_{j+1}
// (neither depends on z_j), and after it p_{j+1} = R + delta_j Q, one FMA.  Blocks are one warp.
// Every input of a step is loaded a step before it is used, and the step constants are computed a
// step ahead from inputs loaded two steps ahead.  With Prologue (a chain on the whole warp, the block's
// one chain) the warp instead first writes the chain's step constants of every step into `scratch`,
// [chain][j][field], 32 steps at once, and a step reads its six from one line.
template <int Ent, bool Prologue>
__global__ void __launch_bounds__(kSweepThreads) gibbs_sweep_kernel(
    const float* __restrict__ x, const float* __restrict__ t, const float* __restrict__ lam,
    const float* __restrict__ h, const float* __restrict__ z_old, const float* __restrict__ s,
    const float* __restrict__ b_in, const float* __restrict__ u_central, const float* __restrict__ u_e,
    const float* __restrict__ u_tail, int num_chains, int num_data, int dim, int lanes, float* scratch,
    float* __restrict__ b_out, float* __restrict__ z_out) {
  const int per_block = kSweepThreads / lanes;
  const int lane = threadIdx.x % lanes;
  const int c_first = blockIdx.x * per_block;
  const int c_group = c_first + static_cast<int>(threadIdx.x) / lanes;
  const bool owner = c_group < num_chains;  // a group past the last chain runs the last chain, writes nothing
  const int c = owner ? c_group : num_chains - 1;
  const size_t n = num_data, cn = num_chains;
  const size_t round_stride = n * cn;  // between the tail rounds of u_e / u_tail
  const int last = num_data - 1;
  const float* lam_c = lam + c * n;
  const float* h_c = h + c * n;
  const float* z_old_c = z_old + c * n;
  float* k_c = Prologue ? scratch + c * n * kSweepFields : nullptr;  // the chain's constants, [j][field]
  if constexpr (Prologue) {
    write_step_constants(lam_c, h_c, z_old_c, t, num_data, k_c, threadIdx.x, kSweepThreads);
    __syncwarp();  // the block is the warp
  }
  const float* s_c = s + static_cast<size_t>(c) * dim * n;
  // Entry e of a lane is B's lane + e lanes; Ent = ceil(D / lanes), so only the last can lie past D.
  const bool last_valid = lane + (Ent - 1) * lanes < dim;
  auto valid = [&](int e) { return e < Ent - 1 || last_valid; };
  auto load_s = [&](int j, float (&v)[Ent]) {
#pragma unroll
    for (int e = 0; e < Ent; ++e) v[e] = valid(e) ? __ldg(s_c + (lane + e * lanes) * n + j) : 0.0f;
  };
  auto load_x = [&](int j, float (&v)[Ent]) {
#pragma unroll
    for (int e = 0; e < Ent; ++e) v[e] = valid(e) ? __ldg(x + static_cast<size_t>(j) * dim + lane + e * lanes) : 0.0f;
  };
  // The step inputs the constants come from (lambda, h, z_old, t), or the constants themselves.
  constexpr int kRaw = Prologue ? kSweepFields : 4;
  auto load_raw = [&](int j, float (&v)[kRaw]) {
    if constexpr (Prologue) {
#pragma unroll
      for (int f = 0; f < kSweepFields; ++f) v[f] = k_c[j * kSweepFields + f];
    } else {
      v[0] = __ldg(lam_c + j), v[1] = __ldg(h_c + j), v[2] = __ldg(z_old_c + j), v[3] = __ldg(t + j);
    }
  };
  auto constants = [&](const float (&v)[kRaw], float (&k)[kSweepFields]) {
    if constexpr (Prologue) {
#pragma unroll
      for (int f = 0; f < kSweepFields; ++f) k[f] = v[f];
    } else {
      step_constants(v[0], v[1], v[2], v[3], k);
    }
  };

  float b[Ent], s_j[Ent], x_next[Ent];
#pragma unroll
  for (int e = 0; e < Ent; ++e) b[e] = valid(e) ? b_in[static_cast<size_t>(c) * dim + lane + e * lanes] : 0.0f;
  load_x(0, x_next);
  float p = 0.0f;  // p_0 = B_0 . x_0
#pragma unroll
  for (int e = 0; e < Ent; ++e) p = fmaf(b[e], x_next[e], p);
  p = group_sum(p, lanes);
  float raw[kRaw], k[kSweepFields];
  load_raw(0, raw);
  constants(raw, k);
  load_raw(min(1, last), raw);
  load_s(0, s_j);
  load_x(min(1, last), x_next);
  float uc = __ldg(u_central + c);

  for (int j = 0; j < num_data; ++j) {
    const int j1 = min(j + 1, last), j2 = min(j + 2, last);
    // Step j + 1's constants from the inputs loaded last step; its inputs, S[:, j + 1], x_{j + 2} and
    // its uniform loaded now.  The empty asm keeps the constants' divisions in this step: left to
    // itself the compiler moves them down to their use, onto the next step's chain.
    float k_next[kSweepFields];
    constants(raw, k_next);
#pragma unroll
    for (int f = 0; f < kSweepFields; ++f) asm volatile("" : "+f"(k_next[f]));
    load_raw(j2, raw);
    float s_next[Ent], x_after[Ent];
    load_s(j1, s_next);
    load_x(j2, x_after);
    const float uc_next = __ldg(u_central + j1 * cn + c);
    // S's rows one 32-byte sector (8 steps) ahead, once every 8 steps: a prefetch takes as many L1
    // lookups as the lanes' lines, and one a step made a sweep of many chains wait on them.
    const bool sector_start = (j & (kRowAhead - 1)) == 0;
#pragma unroll
    for (int e = 0; e < Ent; ++e)
      if (sector_start && valid(e)) prefetch_l1(s_c + (lane + e * lanes) * n + min(j + kRowAhead, last));
    prefetch_l2(u_central + min(j + kUniformAhead, last) * cn + c);
    // Off the chain: R = B_j . x_{j+1} and Q = S[:, j] . x_{j+1} over the group.
    float r_part = 0.0f, q_part = 0.0f;
#pragma unroll
    for (int e = 0; e < Ent; ++e) {
      r_part = fmaf(b[e], x_next[e], r_part);
      q_part = fmaf(s_j[e], x_next[e], q_part);
    }
    const float r_sum = group_sum(r_part, lanes), q_sum = group_sum(q_part, lanes);

    // The chain.
    float delta;
    const float z_j = chain_step(p, k, uc, u_e + j * cn + c, u_tail + j * cn + c, round_stride, &delta);
    if (owner && lane == 0) z_out[c * n + j] = z_j;
#pragma unroll
    for (int e = 0; e < Ent; ++e) {
      b[e] = add(b[e], mul(delta, s_j[e]));
      s_j[e] = s_next[e];
      x_next[e] = x_after[e];
    }
    p = fmaf(delta, q_sum, r_sum);  // B_{j+1} . x_{j+1}
#pragma unroll
    for (int f = 0; f < kSweepFields; ++f) k[f] = k_next[f];
    uc = uc_next;
  }
  if (owner) {
#pragma unroll
    for (int e = 0; e < Ent; ++e)
      if (valid(e)) b_out[static_cast<size_t>(c) * dim + lane + e * lanes] = b[e];
  }
}

// -- G1's wide layout: a chain on a block of warps -------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// Where the warps of a chain meet a step: each warp's sums (R, Q) of a step, in two steps' slots, and the
// mbarrier on which the block's warps arrive, once each a step, when their sums are written.
struct Exchange {
  float part[2][kMemoryWarps][2];
  unsigned long long bar;
};

// A warp's sums of step `slot`: every lane holds the same bits (group_sum), so every lane stores them to the
// same place (no branch, which would end the basic block that the step's chain interleaves with), and lane
// 0 alone arrives (a predicated instruction, likewise).
__device__ __forceinline__ void exchange_publish(Exchange& ex, int slot, int warp, int lane, float r, float q) {
  ex.part[slot][warp][0] = r;
  ex.part[slot][warp][1] = q;
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(&ex.bar)),
      "r"(lane)
      : "memory");
}

// Waits until every warp has published step `step`'s sums, then adds them in warp order: the same bits in
// every warp.
__device__ __forceinline__ void exchange_sum(Exchange& ex, int step, int warps, float& r, float& q) {
  bar_wait(&ex.bar, static_cast<unsigned>(step & 1));
  const int slot = step & 1;
  r = ex.part[slot][0][0];
  q = ex.part[slot][0][1];
#pragma unroll
  for (int w = 1; w < kMemoryWarps; ++w) {
    if (w < warps) {
      r = add(r, ex.part[slot][w][0]);
      q = add(q, ex.part[slot][w][1]);
    }
  }
}

// p_0 = B_0 . x_0 from each thread's part: a block barrier (before the steps' exchanges start), the warps'
// sums added in warp order.  Uses the slot of step 1, which no warp writes before every warp is past step 0.
__device__ __forceinline__ float block_sum_once(Exchange& ex, float part, int warps) {
  ex.part[1][threadIdx.x / kSweepThreads][0] = group_sum(part, kSweepThreads);
  __syncthreads();
  float p = ex.part[1][0][0];
#pragma unroll
  for (int w = 1; w < kMemoryWarps; ++w)
    if (w < warps) p = add(p, ex.part[1][w][0]);
  return p;
}

// The register layout's sweep on a block of W = blockDim.x / 32 warps a chain (one block each): thread t owns
// B's entries t, t + 32 W, ... (Ent = ceil(D / 32 W) of them, only the last possibly past D), in registers.
// A step, as gibbs_sweep_kernel: the thread's terms of R_j = B_j . x_{j+1} and Q_j = S[:, j] . x_{j+1} (neither
// needs z_j), summed over the warp by shuffles and published; the chain, run by every warp with the same
// bits; then the warps' sums added in warp order, p_{j+1} = R_j + delta_j Q_j and B += delta_j S[:, j].  The
// step constants come from the block's prologue into `scratch`; every input of a step is loaded a step ahead.
template <int Ent>
__global__ void __launch_bounds__(kWideWarps * kSweepThreads) gibbs_sweep_block_kernel(
    const float* __restrict__ x, const float* __restrict__ t, const float* __restrict__ lam,
    const float* __restrict__ h, const float* __restrict__ z_old, const float* __restrict__ s,
    const float* __restrict__ b_in, const float* __restrict__ u_central, const float* __restrict__ u_e,
    const float* __restrict__ u_tail, int num_chains, int num_data, int dim, float* scratch,
    float* __restrict__ b_out, float* __restrict__ z_out) {
  __shared__ Exchange ex;
  const int threads = blockDim.x, warps = threads / kSweepThreads;
  const int tid = threadIdx.x, lane = tid % kSweepThreads, warp = tid / kSweepThreads;
  const int c = blockIdx.x;
  const size_t n = num_data, cn = num_chains;
  const size_t round_stride = n * cn;
  const int last = num_data - 1;
  float* k_c = scratch + c * n * kSweepFields;
  write_step_constants(lam + c * n, h + c * n, z_old + c * n, t, num_data, k_c, tid, threads);
  if (tid == 0) bar_init(&ex.bar, warps);
  __syncthreads();  // the constants and the mbarrier before any use
  const float* s_c = s + static_cast<size_t>(c) * dim * n;
  const bool last_valid = tid + (Ent - 1) * threads < dim;
  auto valid = [&](int e) { return e < Ent - 1 || last_valid; };
  auto row = [&](int e) { return s_c + static_cast<size_t>(tid + e * threads) * n; };
  auto load_s = [&](int j, float (&v)[Ent]) {
#pragma unroll
    for (int e = 0; e < Ent; ++e) v[e] = valid(e) ? __ldg(row(e) + j) : 0.0f;
  };
  auto load_x = [&](int j, float (&v)[Ent]) {
#pragma unroll
    for (int e = 0; e < Ent; ++e) v[e] = valid(e) ? __ldg(x + static_cast<size_t>(j) * dim + tid + e * threads) : 0.0f;
  };
  float b[Ent], s_j[Ent], x_next[Ent];
#pragma unroll
  for (int e = 0; e < Ent; ++e) b[e] = valid(e) ? b_in[static_cast<size_t>(c) * dim + tid + e * threads] : 0.0f;
  load_x(0, x_next);
  float p_part = 0.0f;
#pragma unroll
  for (int e = 0; e < Ent; ++e) p_part = fmaf(b[e], x_next[e], p_part);
  float p = block_sum_once(ex, p_part, warps);  // p_0 = B_0 . x_0
  float k[kSweepFields];
#pragma unroll
  for (int f = 0; f < kSweepFields; ++f) k[f] = k_c[f];
  load_s(0, s_j);
  load_x(min(1, last), x_next);
  float uc = __ldg(u_central + c);

  for (int j = 0; j < num_data; ++j) {
    const int j1 = min(j + 1, last), j2 = min(j + 2, last);
    float k_next[kSweepFields];
#pragma unroll
    for (int f = 0; f < kSweepFields; ++f) k_next[f] = k_c[j1 * kSweepFields + f];
    float s_next[Ent], x_after[Ent];
    load_s(j1, s_next);
    load_x(j2, x_after);
    const float uc_next = __ldg(u_central + j1 * cn + c);
    const bool sector_start = (j & (kRowAhead - 1)) == 0;
#pragma unroll
    for (int e = 0; e < Ent; ++e)
      if (sector_start && valid(e)) prefetch_l1(row(e) + min(j + kRowAhead, last));
    prefetch_l2(u_central + min(j + kUniformAhead, last) * cn + c);
    // Off the chain: this warp's parts of R_j = B_j . x_{j+1} and Q_j = S[:, j] . x_{j+1}.
    float r_part = 0.0f, q_part = 0.0f;
#pragma unroll
    for (int e = 0; e < Ent; ++e) {
      r_part = fmaf(b[e], x_next[e], r_part);
      q_part = fmaf(s_j[e], x_next[e], q_part);
    }
    exchange_publish(ex, j & 1, warp, lane, group_sum(r_part, kSweepThreads), group_sum(q_part, kSweepThreads));

    // The chain, in every warp.
    float delta;
    const float z_j = chain_step(p, k, uc, u_e + j * cn + c, u_tail + j * cn + c, round_stride, &delta);
    if (tid == 0) z_out[c * n + j] = z_j;
    float r_sum, q_sum;
    exchange_sum(ex, j, warps, r_sum, q_sum);
    p = fmaf(delta, q_sum, r_sum);  // B_{j+1} . x_{j+1}
#pragma unroll
    for (int e = 0; e < Ent; ++e) {
      b[e] = add(b[e], mul(delta, s_j[e]));
      s_j[e] = s_next[e];
      x_next[e] = x_after[e];
    }
#pragma unroll
    for (int f = 0; f < kSweepFields; ++f) k[f] = k_next[f];
    uc = uc_next;
  }
#pragma unroll
  for (int e = 0; e < Ent; ++e)
    if (valid(e)) b_out[static_cast<size_t>(c) * dim + tid + e * threads] = b[e];
}

// The wide layout past the registers: the same warps a chain and the same sums in the same order as
// gibbs_sweep_block_kernel, with B in the block's dynamic shared memory after the exchange (Shared) or in b_out
// (the chain's row, updated in place); no thread touches another's entries.  The block's shared memory is its
// dynamic allocation alone (wide_shared_bytes), so the wrapper knows it exactly.  Before each step's chain a
// thread's pass over its entries applies the last step's update, B_j = B_{j-1} + delta_{j-1} S[:, j-1], and sums
// its terms of R_j and Q_j from the updated entries; after the last step a pass applies delta_{N-1} and writes
// b_out.
template <bool Shared>
__global__ void __launch_bounds__(kMemoryWarps * kSweepThreads) gibbs_sweep_memory_kernel(
    const float* __restrict__ x, const float* __restrict__ t, const float* __restrict__ lam,
    const float* __restrict__ h, const float* __restrict__ z_old, const float* __restrict__ s,
    const float* __restrict__ b_in, const float* __restrict__ u_central, const float* __restrict__ u_e,
    const float* __restrict__ u_tail, int num_chains, int num_data, int dim, float* scratch, float* b_out,
    float* __restrict__ z_out) {
  extern __shared__ __align__(16) unsigned char dynamic_shared[];  // the exchange, then (Shared) B's D floats
  Exchange& ex = *reinterpret_cast<Exchange*>(dynamic_shared);
  const int threads = blockDim.x, warps = threads / kSweepThreads;
  const int tid = threadIdx.x, lane = tid % kSweepThreads, warp = tid / kSweepThreads;
  const int c = blockIdx.x;
  const size_t n = num_data, cn = num_chains;
  const size_t round_stride = n * cn;
  const int last = num_data - 1;
  float* k_c = scratch + c * n * kSweepFields;
  write_step_constants(lam + c * n, h + c * n, z_old + c * n, t, num_data, k_c, tid, threads);
  if (tid == 0) bar_init(&ex.bar, warps);
  __syncthreads();
  const float* s_c = s + static_cast<size_t>(c) * dim * n;
  float* b_c =
      Shared ? reinterpret_cast<float*>(dynamic_shared + sizeof(Exchange)) : b_out + static_cast<size_t>(c) * dim;
  float p_part = 0.0f;
  for (int e = tid; e < dim; e += threads) {
    const float b = b_in[static_cast<size_t>(c) * dim + e];
    b_c[e] = b;
    p_part = fmaf(b, __ldg(x + e), p_part);
  }
  float p = block_sum_once(ex, p_part, warps);  // p_0 = B_0 . x_0
  float k[kSweepFields];
#pragma unroll
  for (int f = 0; f < kSweepFields; ++f) k[f] = k_c[f];
  float uc = __ldg(u_central + c);
  float delta = 0.0f;  // delta_{j-1}
  for (int j = 0; j < num_data; ++j) {
    const int j1 = min(j + 1, last);
    const bool sector_start = (j & (kRowAhead - 1)) == 0;
    const float* x1 = x + static_cast<size_t>(j1) * dim;
    float r_part = 0.0f, q_part = 0.0f;
    for (int e = tid; e < dim; e += threads) {
      const float* s_row = s_c + static_cast<size_t>(e) * n;
      float b = b_c[e];
      if (j > 0) {
        b = add(b, mul(delta, __ldg(s_row + j - 1)));
        b_c[e] = b;
      }
      const float x_e = __ldg(x1 + e);
      r_part = fmaf(b, x_e, r_part);
      q_part = fmaf(__ldg(s_row + j), x_e, q_part);
      if (sector_start) prefetch_l1(s_row + min(j + kRowAhead, last));
    }
    exchange_publish(ex, j & 1, warp, lane, group_sum(r_part, kSweepThreads), group_sum(q_part, kSweepThreads));
    float k_next[kSweepFields];
#pragma unroll
    for (int f = 0; f < kSweepFields; ++f) k_next[f] = k_c[j1 * kSweepFields + f];
    const float uc_next = __ldg(u_central + j1 * cn + c);
    prefetch_l2(u_central + min(j + kUniformAhead, last) * cn + c);
    const float z_j = chain_step(p, k, uc, u_e + j * cn + c, u_tail + j * cn + c, round_stride, &delta);
    if (tid == 0) z_out[c * n + j] = z_j;
    float r_sum, q_sum;
    exchange_sum(ex, j, warps, r_sum, q_sum);
    p = fmaf(delta, q_sum, r_sum);  // B_{j+1} . x_{j+1}
#pragma unroll
    for (int f = 0; f < kSweepFields; ++f) k[f] = k_next[f];
    uc = uc_next;
  }
  for (int e = tid; e < dim; e += threads)
    b_out[static_cast<size_t>(c) * dim + e] = add(b_c[e], mul(delta, __ldg(s_c + static_cast<size_t>(e) * n + last)));
}

// Calls f(std::integral_constant<int, e>) for 1 <= e <= kEntMax: one instantiation of G1's layouts with B in
// registers per count of B's entries a lane holds.
template <int Ent = 1, typename F>
cudaError_t with_entries(int e, F&& f) {
  if constexpr (Ent < kEntMax) {
    if (e != Ent) return with_entries<Ent + 1>(e, f);
  }
  return f(std::integral_constant<int, Ent>{});
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

// One rejection round of one element (ops/gig.py::gig_round_plain): a candidate from the round's
// normal draw and two uniforms, accepted where its squeeze series decides to accept and it is finite.
__device__ __forceinline__ bool gig_try(float r_e, float n_e, float u_side, float u, int max_bodies, float* cand_out) {
  const float y0 = mul(n_e, n_e);
  const float four_r = mul(4.0f, r_e);
  // y = 4 r y0 / (y0 + sqrt(y0 (y0 + 4r)))^2, the rationalized proposal (no cancellation at small r)
  const float root = add(y0, sqrtf(mul(y0, add(y0, four_r))));
  const float y = mul(four_r, y0) / clamp_min(mul(root, root), kRootSqMin);
  // y0 = 0 gives y = 0 and lambda = r / 0 = inf: rejected below as not finite, redrawn next round.
  float cand = u_side <= 1.0f / add(1.0f, y) ? r_e / y : mul(r_e, y);
  cand = clamp_min(cand, kLamMin);
  bool decided = false;
  const bool accepted = cand > kFourThirds ? rightmost_accept(u, cand, max_bodies, &decided)
                                           : leftmost_accept(u, cand, max_bodies, &decided);
  *cand_out = cand;
  return decided && accepted && isfinite(cand);
}

// One round over given draws (kept to check the round's arithmetic on its own; no Gibbs step calls it).
__global__ void __launch_bounds__(kRoundThreads) gig_round_kernel(
    const float* __restrict__ r, const float* __restrict__ y0_normal, const float* __restrict__ u_side,
    const float* __restrict__ u, float* __restrict__ lam, unsigned char* __restrict__ ok, long long count,
    int max_bodies) {
  const long long e = blockIdx.x * static_cast<long long>(kRoundThreads) + threadIdx.x;
  if (e >= count || ok[e]) return;
  float cand;
  if (gig_try(r[e], y0_normal[e], u_side[e], u[e], max_bodies, &cand)) {
    lam[e] = cand;
    ok[e] = 1;
  }
}

// -- Philox4x32-10 (Salmon et al. 2011; ops/gig.py::philox4x32) ----------------------------

constexpr unsigned kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;
constexpr int kPhiloxRounds = 10;
constexpr float kTwoPi = static_cast<float>(2.0 * kPi);

__device__ __forceinline__ uint4 philox4x32(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int i = 0; i < kPhiloxRounds; ++i) {
    if (i) k0 += kPhiloxW0, k1 += kPhiloxW1;
    const unsigned hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const unsigned hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// A word's top 23 bits k as (2k + 1) 2^-24: exact, in (0, 1) (ops/gig.py::unit_uniform).
__device__ __forceinline__ float unit_uniform(unsigned w) {
  return static_cast<float>(((w >> 9) << 1) | 1u) * 0x1p-24f;
}

// -- G2: the whole GIG draw ---------------------------------------------------------------

constexpr int kHalfPerLane = 8;  // G2: elements a warp takes, per lane

// lambda ~ GIG(1/2, 1, r^2) for each element (ops/gig.py::sample_gig_half_plain): rounds 0, 1, ... until
// the first accepted candidate, at most max_rounds, else 1.  Round k's numbers are the Philox words
// of the counter (global index, k) under the call's key: the normal by Box-Muller from words 0 and 1
// (sqrt(-2 log u1) cos(2 pi u2), each operation rounded as the plain version's tensor ops), u_side
// from word 2 and u from word 3.  An element's rounds depend on nothing but its index, so any thread
// may run them: each warp owns 32 kHalfPerLane consecutive elements, and a lane whose element is
// decided takes the warp's next one, so the lanes stay busy until the warp's elements run out (a warp
// running one element a lane would wait on its slowest element's rounds).
__global__ void __launch_bounds__(kRoundThreads) gig_half_kernel(const float* __restrict__ r,
                                                                 const long long* __restrict__ key,
                                                                 long long first_index, long long count,
                                                                 int max_rounds, int max_bodies,
                                                                 float* __restrict__ lam) {
  const unsigned lane = threadIdx.x % 32;
  const long long warp_first =
      (blockIdx.x * static_cast<long long>(kRoundThreads) + threadIdx.x) / 32 * (32 * kHalfPerLane);
  if (warp_first >= count) return;  // the whole warp
  const long long warp_end = min(warp_first + 32 * kHalfPerLane, count);
  const unsigned long long k = static_cast<unsigned long long>(__ldg(key));
  long long next = warp_first + 32;  // the warp's first element no lane has taken (the same in every lane)
  long long e = warp_first + lane;
  bool busy = e < warp_end;
  float r_e = busy ? r[e] : 0.0f;
  int round = 0;
  while (__any_sync(0xffffffffu, busy)) {
    bool done = false;
    if (busy) {
      const unsigned long long g = static_cast<unsigned long long>(first_index + e);
      const uint4 w = philox4x32(make_uint4(static_cast<unsigned>(g), static_cast<unsigned>(g >> 32),
                                            static_cast<unsigned>(round), 0u),
                                 static_cast<unsigned>(k), static_cast<unsigned>(k >> 32));
      const float normal = mul(sqrtf(mul(-2.0f, logf(unit_uniform(w.x)))), cosf(mul(unit_uniform(w.y), kTwoPi)));
      float cand;
      if (gig_try(r_e, normal, unit_uniform(w.z), unit_uniform(w.w), max_bodies, &cand)) {
        lam[e] = cand;
        done = true;
      } else if (++round == max_rounds) {
        lam[e] = 1.0f;
        done = true;
      }
    }
    const unsigned finished = __ballot_sync(0xffffffffu, done);
    if (finished) {  // the same in every lane: the decided lanes take the next elements in lane order
      if (done) {
        e = next + __popc(finished & ((1u << lane) - 1u));
        busy = e < warp_end;
        round = 0;
        if (busy) r_e = r[e];
      }
      next += __popc(finished);
    }
  }
}

// The dynamic shared memory of a block of gibbs_sweep_memory_kernel at width D: the warps' exchange, and with B
// in shared memory B's D floats.
size_t wide_shared_bytes(int dim, bool shared_b = true) {
  return sizeof(Exchange) + (shared_b ? sizeof(float) * static_cast<size_t>(dim) : 0);
}

// The dynamic shared memory of the form with B in shared memory past the default 48 KB a block: raised to the
// card's opt-in limit, less the kernel's static shared memory (none), once a device, at an eager launch (an
// attribute is not set inside a stream capture).
cudaError_t allow_wide_shared(int dim, cudaStream_t stream) {
  constexpr size_t kDefaultShared = 48 * 1024;
  constexpr int kDevices = 64;
  static bool raised[kDevices] = {};
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, gibbs_sweep_memory_kernel<true>);
  if (err != cudaSuccess) return err;
  const size_t bytes = attr.sharedSizeBytes + wide_shared_bytes(dim);
  if (bytes <= kDefaultShared) return cudaSuccess;
  int device = 0, optin = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices || bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (raised[device]) return cudaSuccess;
  cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
  err = cudaStreamIsCapturing(stream, &capturing);
  if (err != cudaSuccess) return err;
  if (capturing != cudaStreamCaptureStatusNone) return cudaErrorStreamCaptureUnsupported;
  err = cudaFuncSetAttribute(gibbs_sweep_memory_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) raised[device] = true;
  return err;
}

}  // namespace

// G1's layouts (samplers/gibbs.py::SWEEP_REGISTERS, SWEEP_WIDE_REGISTERS, SWEEP_WIDE_SHARED, SWEEP_WIDE_GLOBAL).
enum SweepLayout { kRegisters = 0, kWideRegisters = 1, kWideShared = 2, kWideGlobal = 3 };

// B (C, D) and z (C, N) after the sweep.  x (N, D); t (N,) labels; lambda, h,
// z_old (C, N); s (C, D, N); b_in (C, D); u_central (N, C); u_e, u_tail (3, N, C).
// layout kRegisters: `lanes` (1, 2, 4, 8, 16 or 32) lanes of a warp a chain with ceil(D / lanes) <= kEntMax
// entries a lane; on 32, the step constants come from the warp's prologue.  The wide layouts, a block of
// lanes / 32 warps a chain: kWideRegisters (at most kWideWarps, ceil(D / lanes) <= kEntMax entries a lane),
// kWideShared (at most kMemoryWarps, B in shared memory: wide_shared_bytes(D) at most the card's opt-in
// limit) or kWideGlobal (at most kMemoryWarps, B in b_out).
// scratch: the floats that rhmc_gibbs_sweep_scratch_floats names, written and read by this launch alone.
extern "C" int rhmc_gibbs_sweep(const void* x, const void* t, const void* lam, const void* h, const void* z_old,
                                const void* s, const void* b_in, const void* u_central, const void* u_e,
                                const void* u_tail, int num_chains, int num_data, int dim, int lanes, int layout,
                                void* scratch, void* b_out, void* z_out, void* stream) {
  if (num_chains < 1 || num_data < 1 || dim < 1 || lanes < 1) return cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* st = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<float*>(scratch);
  auto* bo = static_cast<float*>(b_out);
  auto* zo = static_cast<float*>(z_out);
  const int ent = (dim + lanes - 1) / lanes;
  if (layout == kWideShared || layout == kWideGlobal) {
    if (lanes % kSweepThreads != 0 || lanes > kMemoryWarps * kSweepThreads) return cudaErrorInvalidValue;
    const size_t shared = wide_shared_bytes(dim, layout == kWideShared);
    if (layout == kWideShared) {
      const cudaError_t err = allow_wide_shared(dim, st);
      if (err != cudaSuccess) return err;
    }
    const auto launch = [&](auto kernel) {
      kernel<<<num_chains, lanes, shared, st>>>(f(x), f(t), f(lam), f(h), f(z_old), f(s), f(b_in), f(u_central),
                                                f(u_e), f(u_tail), num_chains, num_data, dim, k, bo, zo);
      return cudaGetLastError();
    };
    return layout == kWideShared ? launch(gibbs_sweep_memory_kernel<true>) : launch(gibbs_sweep_memory_kernel<false>);
  }
  if (ent > kEntMax) return cudaErrorInvalidValue;
  if (layout == kWideRegisters) {
    if (lanes % kSweepThreads != 0 || lanes > kWideWarps * kSweepThreads) return cudaErrorInvalidValue;
    return with_entries(ent, [&](auto entries) {
      gibbs_sweep_block_kernel<decltype(entries)::value><<<num_chains, lanes, 0, st>>>(
          f(x), f(t), f(lam), f(h), f(z_old), f(s), f(b_in), f(u_central), f(u_e), f(u_tail), num_chains, num_data,
          dim, k, bo, zo);
      return cudaGetLastError();
    });
  }
  if (layout != kRegisters || lanes > kSweepThreads || (lanes & (lanes - 1)) != 0) return cudaErrorInvalidValue;
  const int per_block = kSweepThreads / lanes;
  const int blocks = (num_chains + per_block - 1) / per_block;
  return with_entries(ent, [&](auto entries) {
    constexpr int E = decltype(entries)::value;
    const auto launch = [&](auto kernel) {
      kernel<<<blocks, kSweepThreads, 0, st>>>(f(x), f(t), f(lam), f(h), f(z_old), f(s), f(b_in), f(u_central),
                                               f(u_e), f(u_tail), num_chains, num_data, dim, lanes, k, bo, zo);
      return cudaGetLastError();
    };
    if (lanes == kSweepThreads) return launch(gibbs_sweep_kernel<E, true>);
    return launch(gibbs_sweep_kernel<E, false>);
  });
}

// kEntMax, for the wrapper's mirror (SWEEP_ENT_MAX).
extern "C" int rhmc_gibbs_sweep_max_entries() { return kEntMax; }

// The floats of G1's scratch for a launch on `lanes` lanes a chain: on a warp or more (the wide layouts), every
// chain's step constants.
extern "C" long long rhmc_gibbs_sweep_scratch_floats(int num_chains, int num_data, int lanes) {
  if (num_chains < 1 || num_data < 1 || lanes < 1 || lanes > kMemoryWarps * kSweepThreads) return -1;
  return lanes >= kSweepThreads ? static_cast<long long>(kSweepFields) * num_data * num_chains : 0;
}

// The bytes of shared memory a block of the wide layout with B in shared memory takes at width D
// (samplers/gibbs.py::sweep_shared_bytes).
extern "C" long long rhmc_gibbs_sweep_shared_bytes(int dim) {
  return dim < 1 ? -1 : static_cast<long long>(wide_shared_bytes(dim));
}

// lambda for `count` elements of r, their global indices first_index, first_index + 1, ...; key one int64.
extern "C" int rhmc_gig_half(const void* r, const void* key, long long first_index, long long count, int max_rounds,
                             int max_bodies, void* lam, void* stream) {
  if (count < 1 || max_rounds < 1 || max_bodies < 1 || first_index < 0) return cudaErrorInvalidValue;
  constexpr long long per_block = static_cast<long long>(kRoundThreads) * kHalfPerLane;
  const long long blocks = (count + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gig_half_kernel<<<static_cast<unsigned>(blocks), kRoundThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const long long*>(key), first_index, count, max_rounds, max_bodies,
      static_cast<float*>(lam));
  return cudaGetLastError();
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
