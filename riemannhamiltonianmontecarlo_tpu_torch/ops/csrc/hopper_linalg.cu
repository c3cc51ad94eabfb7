// Chain-batched small-matrix Cholesky kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1 rhmc_cholesky           <- riemannhamiltonianmontecarlo_tpu/ops/pallas_linalg.py::cholesky
//                                 (_chol_kernel -> _chol_body)
//   K2 rhmc_chol_solve_logdet  <- riemannhamiltonianmontecarlo_tpu/ops/pallas_linalg.py::chol_solve_logdet
//                                 (_fused_kernel -> _chol_body + _solve_body)
// Python wrappers, checks and plain-PyTorch twins: ops/hopper_linalg.py.
//
// Layout: chains-last, one thread per chain.  G is (D, D, C), b and x are
// (D, C), logdet is (C,), all float32 and contiguous, so entry (i, j) of
// chain c sits at (i*D + j)*C + c.  The 32 threads of a warp hold 32
// neighbouring chains and touch 32 neighbouring floats on every access, so
// each load and store coalesces: the Hopper analog of the TPU kernel's
// chains-on-lanes (D, D, 128) blocks.  The ragged edge is masked
// (c >= C returns), so no identity padding is needed.
//
// What bounds it on an H100: chains share nothing, so a thread runs one
// dependent sequence of D sqrt / divide / rank-1-update steps over the
// D(D+1)/2 entries of its factor.  At the main path's D = 15, C = 4096 that
// is 32 blocks of 128 threads on 132 SMs: most SMs idle, and the active ones
// hold 4 warps each, too few to hide the latency of the dependent
// sqrt/div chain.  It is latency- and occupancy-bound, not bound by bytes
// (C*D*D*4 = 3.7 MB in) nor by FLOPs (~C*D^3/3 = 4.6 MFLOP).  What the design
// does about it: each matrix is read once and written once; the width D is
// a template parameter for the widths the repo uses, so the loops unroll,
// the packed-triangle indices are constants and the factor lives in
// registers (at D = 25 the 325 floats spill to local memory, which is
// interleaved per thread and stays coalesced); the fused K2 never writes
// the factor to memory at all.  Spreading a chain over several threads to
// fill the SMs is later work.
//
// Semantics kept from the TPU kernel:
//   * the algorithm is the same unrolled outer-product elimination, in the
//     same order of operations (column j = rem[:, j] / sqrt(rem[j, j]), then
//     rem -= col col^T), reading only the lower triangle of G;
//   * K1 writes exact zeros to the strict upper triangle: its output comes
//     from torch.empty, so a slot it skipped would hold garbage;
//   * a matrix that is not positive definite gives NaN (sqrt of a negative
//     pivot) or inf in its own chain only: no trap, no early exit, no effect
//     on other chains.  RMHMC's divergence masking relies on it;
//   * K2 returns log|G| = 2 sum log diag L even where its caller drops it.
//
// C interface (bound with ctypes): each entry launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kMaxDim = 48;   // ops/linalg.py UNROLL_MAX_DIM
constexpr int kThreads = 128;

// Row-major packed lower triangle: entry (i, j), j <= i.
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Capacity of the packed triangle: DT when the width is a template
// parameter, kMaxDim for the runtime-width instantiation (DT == 0).
template <int DT>
__host__ __device__ constexpr int cap() { return DT > 0 ? DT : kMaxDim; }

// Load the lower triangle of chain c's G into a[] and factor it in place.
// With DT > 0 every loop has a constant trip count, so `#pragma unroll`
// unrolls it and a[] is indexed by constants only; with DT == 0 the loops
// stay rolled and a[] lives in local memory.
template <int DT>
__device__ __forceinline__ void load_and_factor(const float* __restrict__ g, float* a, int d_rt,
                                                size_t stride, int c) {
  const int d = DT > 0 ? DT : d_rt;
#pragma unroll
  for (int i = 0; i < d; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) a[tri(i, j)] = g[(size_t)(i * d + j) * stride + c];
  }
#pragma unroll
  for (int j = 0; j < d; ++j) {
    const float diag = sqrtf(a[tri(j, j)]);
#pragma unroll
    for (int i = j; i < d; ++i) a[tri(i, j)] = a[tri(i, j)] / diag;
#pragma unroll
    for (int k = j + 1; k < d; ++k) {
#pragma unroll
      for (int i = k; i < d; ++i) a[tri(i, k)] -= a[tri(i, j)] * a[tri(k, j)];
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
    cholesky_kernel(const float* __restrict__ g, float* __restrict__ l, int num_chains, int d_rt) {
  const int d = DT > 0 ? DT : d_rt;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_chains) return;
  const size_t stride = num_chains;
  float a[tri(cap<DT>(), 0)];
  load_and_factor<DT>(g, a, d, stride, c);
#pragma unroll
  for (int i = 0; i < d; ++i) {
#pragma unroll
    for (int j = 0; j < d; ++j) l[(size_t)(i * d + j) * stride + c] = j <= i ? a[tri(i, j)] : 0.0f;
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
    chol_solve_logdet_kernel(const float* __restrict__ g, const float* __restrict__ b,
                             float* __restrict__ x, float* __restrict__ logdet, int num_chains,
                             int d_rt) {
  const int d = DT > 0 ? DT : d_rt;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_chains) return;
  const size_t stride = num_chains;
  float a[tri(cap<DT>(), 0)];
  load_and_factor<DT>(g, a, d, stride, c);

  float y[cap<DT>()];
  // Forward substitution, L y = b.
#pragma unroll
  for (int i = 0; i < d; ++i) {
    float s = b[(size_t)i * stride + c];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= a[tri(i, k)] * y[k];
    y[i] = s / a[tri(i, i)];
  }
  // Back substitution, L^T x = y, in place: y[k > i] already holds x[k].
#pragma unroll
  for (int i = d - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < d; ++k) s -= a[tri(k, i)] * y[k];
    y[i] = s / a[tri(i, i)];
  }
  float half_logdet = 0.0f;
#pragma unroll
  for (int i = 0; i < d; ++i) {
    x[(size_t)i * stride + c] = y[i];
    half_logdet += logf(a[tri(i, i)]);
  }
  logdet[c] = 2.0f * half_logdet;
}

// Call f with the width as a compile-time constant for the widths the repo
// uses (the StochVol hyper block's D = 3; tests and the five BLR datasets: 5,
// 6, 7, 8, 14, 15, 25), and with 0 (the runtime-width instantiation, whose
// local arrays are sized for kMaxDim) for any other D <= kMaxDim.
template <typename F>
cudaError_t with_width(int d, F&& f) {
  switch (d) {
    case 3: return f(std::integral_constant<int, 3>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 14: return f(std::integral_constant<int, 14>{});
    case 15: return f(std::integral_constant<int, 15>{});
    case 25: return f(std::integral_constant<int, 25>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

inline int blocks_for(int num_chains) { return (num_chains + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int rhmc_cholesky(const void* g, void* l, int num_chains, int d, void* stream) {
  if (num_chains < 1 || d < 1 || d > kMaxDim) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    constexpr int DT = decltype(width)::value;
    cholesky_kernel<DT><<<blocks_for(num_chains), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<float*>(l), num_chains, d);
    return cudaGetLastError();
  });
}

extern "C" int rhmc_chol_solve_logdet(const void* g, const void* b, void* x, void* logdet,
                                      int num_chains, int d, void* stream) {
  if (num_chains < 1 || d < 1 || d > kMaxDim) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    constexpr int DT = decltype(width)::value;
    chol_solve_logdet_kernel<DT>
        <<<blocks_for(num_chains), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(g), static_cast<const float*>(b), static_cast<float*>(x),
            static_cast<float*>(logdet), num_chains, d);
    return cudaGetLastError();
  });
}
