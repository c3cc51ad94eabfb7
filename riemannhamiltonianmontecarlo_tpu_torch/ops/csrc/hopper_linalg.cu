// Chain-batched small-matrix Cholesky kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1 rhmc_cholesky           <- riemannhamiltonianmontecarlo_tpu/ops/pallas_linalg.py::cholesky
//                                 (_chol_kernel -> _chol_body)
//   K2 rhmc_chol_solve_logdet  <- riemannhamiltonianmontecarlo_tpu/ops/pallas_linalg.py::chol_solve_logdet
//                                 (_fused_kernel -> _chol_body + _solve_body)
// and one that replaces no Pallas kernel:
//   K3 rhmc_chol_inv_logdet    <- RMHMC's geometry, riemannhamiltonianmontecarlo_tpu/samplers/rmhmc.py:111-118:
//                                 ops.cholesky, then ops/linalg.py::inv_psd_from_chol (:154-159, an
//                                 unrolled substitution against the identity and a matmul) and
//                                 logdet_from_chol (:162-165).  XLA fuses those into the jitted step;
//                                 in eager PyTorch they are ~230 launches a geometry at D = 15.
// Python wrappers, checks and plain-PyTorch twins: ops/hopper_linalg.py.
//
// Layout: the public one.  G, L and G^-1 are contiguous (C, D, D), b and x
// are (C, D), logdet and half_logdet are (C,), all float32.  A chain's matrix is D*D neighbouring
// floats and neighbouring chains are neighbouring memory, so a block that
// owns kChains neighbouring chains owns one contiguous run of G.  No operand
// is transposed or copied on its way in or out.
//
// What bounds it on an H100: bytes.  Each matrix is read once (K1 writes one
// more), 7.4 MB at C = 4096, D = 15 against ~C*D^3/3 = 4.6 MFLOP of fp32 work;
// the arithmetic is one dependent sequence of D sqrt / divide / rank-1 steps
// per chain, so what keeps a kernel from its byte bound is latency and idle
// SMs, not the operation count.  What the design does about it:
//   * several lanes per chain: a group of kLanes threads (4 for D <= 4, 8 for
//     D <= 8, 16 for D <= 16, else 32; two rows a lane for 32 < D <= 48) owns
//     one chain, lane i holding row i in registers.  Column step j: the pivot
//     goes round the group with a shuffle, every lane scales its own entry
//     and takes the D-j-1 multipliers L[k][j] by shuffle for the update of its
//     own row.  A lane walks ~D dependent sqrt / divide rounds where one
//     thread per chain would walk ~D^3/6 dependent FMAs, and 4096 chains at
//     D = 15 are 512 blocks of 128 threads where they would be 32;
//   * the block's run of G reaches a shared-memory tile by coalesced
//     asynchronous copies (cp.async, 16 bytes a thread; 4 bytes a thread where
//     the run is not 16-byte aligned, its length no multiple of 4 floats, or
//     the tile's rows are padded), lanes read their rows from the tile, K1
//     writes the factor back into the tile and the block stores it coalesced;
//   * the tile's row stride is D | 1: an odd stride puts the rows of the lanes
//     of a warp in 32 different banks (D = 15: two chains a warp, all 32
//     banks; unpadded D = 8 would be an 8-way conflict).  Odd D keeps the
//     memory image and the 16-byte copies, even D pays the 4-byte copies;
//   * the width is a compile-time constant for the widths the repo uses, so
//     every loop unrolls and the rows stay in registers; any other D <= 48
//     runs the same template at the next capacity (4, 8, 16, 32, 48) with
//     the loops cut and the loads and stores masked by the runtime D;
//   * K2 never writes the factor to device memory.  Its forward substitution
//     rides on the elimination: b is one more column, step j gives
//     y_j = rhs_j / L[j][j] on lane j, which broadcasts it, and the lanes below
//     subtract L[i][j] y_j -- the twin's operations in the twin's order, off
//     the factor's own dependent chain.  For the back substitution the factor
//     goes to the shared tile and lane i reads column i there.
//   * K3 factors exactly as K1 (the same load_and_factor, so the same L bit
//     for bit) and stores L as K1 does, from the tile.  Then, from that
//     tile, lane c solves L y = e_c by forward substitution (row i reads
//     L's row i, the same entries on every lane of the group: a broadcast)
//     and keeps column c of L^-1 in registers, the twin's operations in the
//     twin's order; the columns go back to the tile as its rows (lane c
//     writes row c: the lanes' stores fall in different banks through the
//     odd stride), and lane a forms row a of G^-1 = L^-T L^-1 as
//     G^-1[a][b] = sum over k >= b of L^-1[k][a] L^-1[k][b], reading column
//     b of L^-1 (a row of the tile, again a broadcast) from k = b on.  The
//     terms k < max(a, b) are exact zeros, so (a, b) and (b, a) are the same
//     products summed in the same order and G^-1 comes out exactly
//     symmetric; each lane sums D (D + 1) / 2 products, what computing each
//     pair once would average, without the bank conflicts of storing a
//     pair's two entries (at D = 15, lane a's entry (a, a + t) lies in bank
//     16 a + t: eight lanes to a bank).  The rows of G^-1 go to the tile and
//     out as L did.  half_logdet is the group's butterfly sum of log L[i][i].
//
// K3's divisions: row i of column c divides by L[i][i]; above the column
// (i < c) and wherever the sum is an exact zero it divides 1 instead and
// multiplies the zero by that quotient, which gives what zero / L[i][i]
// gives (zero / x leaves the division's fast path).  The quotient is used on
// both sides so that nvcc cannot divide the sum and select afterwards.
//
// Shuffles need every lane of the warp: no thread returns early.  A group
// whose chain is past C, and a lane whose row is past D (lane 15 at D = 15),
// run the same instructions on a copy of the block's last chain, or of the
// chain's last row, with their stores masked.  A copy and not an identity
// row: 0 / x leaves the fast path of the float32 division, and one such lane
// sends its whole warp through the slow one at every step.  Shuffles are
// confined to the group (width kLanes) and never name a spare lane, so
// nothing crosses from one chain to its neighbour in the warp.
//
// Semantics kept from the TPU kernel:
//   * the algorithm is the same unrolled outer-product elimination, every
//     entry seeing the same operations in the same order (column
//     j = rem[:, j] / sqrt(rem[j, j]), then rem -= col col^T), reading only
//     the lower triangle of G.  K2's forward substitution keeps the order of
//     the twin; its back substitution subtracts x_k in descending k where the
//     twin sums in ascending k, and log|G| is a butterfly sum over the group:
//     rounding differs in the last bits, inside the stated tolerance;
//   * K1 and K3 write exact zeros to the strict upper triangle: their output
//     comes from torch.empty, so a slot they skipped would hold garbage;
//   * a matrix that is not positive definite gives NaN (sqrt of a negative
//     pivot) or inf in its own chain only: no trap, no early exit, no effect
//     on other chains.  RMHMC's divergence masking relies on it;
//   * K2 returns log|G| = 2 sum log diag L even where its caller drops it;
//     K3 returns half of it, sum log diag L (the twin's 0.5 (2 sum) is the
//     same float).
//
// Registers and shared memory (ptxas of CUDA 12.8, sm_90a; chip_smoke.py
// prints the report's numbers per instantiation): 28-46 registers a thread at
// the compile-time widths up to 15, 46 (K1) and 48 (K2) at D = 25, 33-78 for
// the run-time capacities up to 32 and 123 (K1) / 117 (K2) at capacity 48; no
// spills anywhere.  K3: 32-47 at the compile-time widths, 55-72 at the
// run-time capacities to 32 (20 B of spill stores at 32) and 168 at 48.  The tile
// (one matrix a chain, K3 too) is kChains * D * (D | 1) * 4 bytes: 1,152 at
// D = 3, 7,200 at D = 15, 10,000 at D = 25, 37,632 at D = 48, all under the
// 48 KB that need no opt-in.
//
// C interface (bound with ctypes): each entry launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxDim = 48;  // ops/linalg.py UNROLL_MAX_DIM
constexpr int kThreads = 128;

__host__ __device__ constexpr int lanes_for(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32; }
__host__ __device__ constexpr int row_stride(int d) { return d | 1; }

// N is the number of rows and elimination steps the instantiation is unrolled
// for.  kExact: the width is N itself; otherwise the width d <= N comes at run
// time and rows d..N-1 are spare.
template <int N, bool kExactWidth>
struct Width {
  static constexpr int kN = N;
  static constexpr bool kExact = kExactWidth;
  static constexpr int kLanes = lanes_for(N);                // lanes per chain
  static constexpr int kRows = (N + kLanes - 1) / kLanes;    // rows per lane: lane, lane + kLanes
  static constexpr int kChains = kThreads / kLanes;          // chains per block
};

__device__ __forceinline__ void cp_async_16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Can a run of `count` floats at p move between memory and the tile 16 bytes
// at a time?  Only if the tile is the run's own image (rows not padded).
__device__ __forceinline__ bool wide_copy(const float* p, int count, int d) {
  return row_stride(d) == d && count % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Offset in the tile of float e of the block's run: chain e / d^2, then row and column.
__device__ __forceinline__ int tile_offset(int e, int d) {
  const int chain = e / (d * d), in_chain = e - chain * d * d, row = in_chain / d;
  return chain * d * row_stride(d) + row * row_stride(d) + (in_chain - row * d);
}

// Bring `count` floats (whole chains) from src into the tile; all threads of the block.
__device__ __forceinline__ void tile_load(float* tile, const float* __restrict__ src, int count, int d) {
  if (wide_copy(src, count, d)) {
    for (int e = 4 * threadIdx.x; e < count; e += 4 * kThreads) cp_async_16(tile + e, src + e);
  } else {
    for (int e = threadIdx.x; e < count; e += kThreads) cp_async_4(tile + tile_offset(e, d), src + e);
  }
  cp_async_wait_all();
  __syncthreads();
}

// Store the tile's `count` floats to dst; all threads of the block.
__device__ __forceinline__ void tile_store(float* __restrict__ dst, const float* tile, int count, int d) {
  if (wide_copy(dst, count, d)) {
    for (int e = 4 * threadIdx.x; e < count; e += 4 * kThreads)
      *reinterpret_cast<float4*>(dst + e) = *reinterpret_cast<const float4*>(tile + e);
  } else {
    for (int e = threadIdx.x; e < count; e += kThreads) dst[e] = tile[tile_offset(e, d)];
  }
}

// Where a thread stands: its lane in the group, its chain and whether that
// chain exists, and the chain it reads (its own, or the block's last one) with
// that chain's part of the tile.
template <typename W>
struct Seat {
  int lane, chain, src_chain;
  bool chain_ok;
  float* mine;
  __device__ Seat(float* tile, int first_chain, int chains_here, int d) {
    const int group = threadIdx.x / W::kLanes, src_group = min(group, chains_here - 1);
    lane = threadIdx.x % W::kLanes;
    chain = first_chain + group;
    src_chain = first_chain + src_group;
    chain_ok = group < chains_here;
    mine = tile + src_group * d * row_stride(d);
  }
  __device__ int row(int r) const { return lane + r * W::kLanes; }
  // A row that exists and that this lane may store to.
  __device__ bool real(int r, int d) const { return chain_ok && row(r) < d; }
};

// Read this lane's rows from the tile and factor the chain in place: on
// return a[r][k], k <= row, is L[row][k] and diag[r] is L[row][row] (1 for a
// spare lane, which computes on a copy of row d - 1).  With kSolve, rhs[r]
// comes in as b[row] and y[r] goes out as (L^-1 b)[row].
template <typename W, bool kSolve>
__device__ __forceinline__ void load_and_factor(const Seat<W>& seat, int d, float (&a)[W::kRows][W::kN],
                                                float (&diag)[W::kRows], float (&rhs)[W::kRows],
                                                float (&y)[W::kRows]) {
  constexpr int N = W::kN;
  const int s = row_stride(d);
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    const int src_row = min(seat.row(r), d - 1);
    diag[r] = 1.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) a[r][k] = (W::kExact || k < d) ? seat.mine[src_row * s + k] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (!W::kExact && j >= d) break;  // the same for every thread
    const float pivot = __shfl_sync(0xffffffffu, a[j / W::kLanes][j], j % W::kLanes, W::kLanes);
    const float root = sqrtf(pivot);
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) {
      a[r][j] = a[r][j] / root;
      if (seat.row(r) == j) diag[r] = a[r][j];
    }
    if (kSolve) {  // forward substitution, L y = b, one column a step
      // Only lane j's quotient is used; the others divide by 1, not by an
      // L[i][j] that may be 0 (x / 0 leaves the division's fast path).
      const int slot = j / W::kLanes;
      const float yj = __shfl_sync(0xffffffffu, rhs[slot] / (seat.row(slot) == j ? a[slot][j] : 1.0f),
                                   j % W::kLanes, W::kLanes);
#pragma unroll
      for (int r = 0; r < W::kRows; ++r) {
        if (seat.row(r) == j) y[r] = yj;
        if (seat.row(r) > j) rhs[r] -= a[r][j] * yj;
      }
    }
#pragma unroll
    for (int k = j + 1; k < N; ++k) {
      if (!W::kExact && k >= d) break;
      const float lkj = __shfl_sync(0xffffffffu, a[k / W::kLanes][j], k % W::kLanes, W::kLanes);
#pragma unroll
      for (int r = 0; r < W::kRows; ++r) a[r][k] -= a[r][j] * lkj;
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    cholesky_kernel(const float* __restrict__ g, float* __restrict__ l, int num_chains, int d_rt) {
  extern __shared__ __align__(16) float tile[];
  constexpr int N = W::kN;
  const int d = W::kExact ? N : d_rt;
  const int s = row_stride(d);
  const int first_chain = blockIdx.x * W::kChains;
  const int chains_here = min(W::kChains, num_chains - first_chain);
  const size_t run = static_cast<size_t>(first_chain) * d * d;
  tile_load(tile, g + run, chains_here * d * d, d);

  const Seat<W> seat(tile, first_chain, chains_here, d);
  float a[W::kRows][N], diag[W::kRows], unused[W::kRows];
  load_and_factor<W, false>(seat, d, a, diag, unused, unused);
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    const int row = seat.row(r);
    if (seat.real(r, d)) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (W::kExact || k < d) seat.mine[row * s + k] = k <= row ? a[r][k] : 0.0f;
    }
  }
  __syncthreads();
  tile_store(l + run, tile, chains_here * d * d, d);
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    chol_solve_logdet_kernel(const float* __restrict__ g, const float* __restrict__ b,
                             float* __restrict__ x, float* __restrict__ logdet, int num_chains,
                             int d_rt) {
  extern __shared__ __align__(16) float tile[];
  constexpr int N = W::kN;
  const int d = W::kExact ? N : d_rt;
  const int s = row_stride(d);
  const int first_chain = blockIdx.x * W::kChains;
  const int chains_here = min(W::kChains, num_chains - first_chain);
  tile_load(tile, g + static_cast<size_t>(first_chain) * d * d, chains_here * d * d, d);

  const Seat<W> seat(tile, first_chain, chains_here, d);
  float a[W::kRows][N], diag[W::kRows], rhs[W::kRows], y[W::kRows];
  bool real[W::kRows];
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    real[r] = seat.real(r, d);
    rhs[r] = b[static_cast<size_t>(seat.src_chain) * d + min(seat.row(r), d - 1)];
    y[r] = 1.0f;  // a spare lane keeps it: 1 / 1 at every step of the back substitution
  }
  load_and_factor<W, true>(seat, d, a, diag, rhs, y);

  // The strict lower triangle goes to the tile, for the column reads of the
  // back substitution.  A lane writes its own row only, and has read it.
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    if (real[r]) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < seat.row(r)) seat.mine[seat.row(r) * s + k] = a[r][k];
    }
  }
  __syncwarp();  // a group lies inside one warp

  // Back substitution, L^T x = y, from the last row up: lane k broadcasts
  // x_k, lane i < k subtracts L[k][i] x_k, reading column i of the tile.
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    if (!W::kExact && k >= d) continue;
    const float xk = __shfl_sync(0xffffffffu, y[k / W::kLanes] / diag[k / W::kLanes], k % W::kLanes, W::kLanes);
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) {
      if (seat.row(r) == k) y[r] = xk;  // y[r] now holds x[row]
      if (real[r] && seat.row(r) < k) y[r] -= seat.mine[k * s + seat.row(r)] * xk;
    }
  }

  float half_logdet = 0.0f;
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    half_logdet += logf(diag[r]);  // a spare lane adds log 1 = 0
    if (real[r]) x[static_cast<size_t>(seat.chain) * d + seat.row(r)] = y[r];
  }
#pragma unroll
  for (int offset = W::kLanes / 2; offset > 0; offset /= 2)
    half_logdet += __shfl_xor_sync(0xffffffffu, half_logdet, offset, W::kLanes);
  if (seat.chain_ok && seat.lane == 0) logdet[seat.chain] = 2.0f * half_logdet;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
    chol_inv_logdet_kernel(const float* __restrict__ g, float* __restrict__ l, float* __restrict__ inv,
                           float* __restrict__ half_logdet, int num_chains, int d_rt) {
  extern __shared__ __align__(16) float tile[];
  constexpr int N = W::kN;
  const int d = W::kExact ? N : d_rt;
  const int s = row_stride(d);
  const int first_chain = blockIdx.x * W::kChains;
  const int chains_here = min(W::kChains, num_chains - first_chain);
  const size_t run = static_cast<size_t>(first_chain) * d * d;
  tile_load(tile, g + run, chains_here * d * d, d);

  // The factor, written to the tile and stored exactly as K1 does.
  const Seat<W> seat(tile, first_chain, chains_here, d);
  float a[W::kRows][N], diag[W::kRows], unused[W::kRows];
  load_and_factor<W, false>(seat, d, a, diag, unused, unused);
  bool real[W::kRows];
  int col[W::kRows];  // this lane's column of L^-1 (a spare lane: a copy of the last)
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    const int row = seat.row(r);
    real[r] = seat.real(r, d);
    col[r] = min(row, d - 1);
    if (real[r]) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (W::kExact || k < d) seat.mine[row * s + k] = k <= row ? a[r][k] : 0.0f;
    }
  }
  __syncthreads();
  tile_store(l + run, tile, chains_here * d * d, d);

  // Column col of L^-1: L y = e_col, row i from L's row i in the tile (the
  // twin's s = e[i][col] - sum_{k < i} L[i][k] y[k], then s / L[i][i]).
  float y[W::kRows][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (!W::kExact && i >= d) break;
    const float* li = seat.mine + i * s;
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) {
      float sum = i == col[r] ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < i; ++k) sum -= li[k] * y[r][k];
      const bool zero = sum == 0.0f;  // above the column, or a zero of L's pattern: zero / L[i][i] is the zero
      const float q = (zero ? 1.0f : sum) / li[i];
      y[r][i] = zero ? sum * q : q;
    }
  }
  __syncthreads();  // every lane has read L
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    if (real[r]) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (W::kExact || i < d) seat.mine[col[r] * s + i] = y[r][i];  // column col of L^-1 as row col
    }
  }
  __syncthreads();

  // Row col of G^-1: entry b sums L^-1[k][col] L^-1[k][b] over k from b on,
  // column b of L^-1 read as row b of the tile.
  float gi[W::kRows][N];
#pragma unroll
  for (int b = 0; b < N; ++b) {
    if (!W::kExact && b >= d) break;
    const float* yb = seat.mine + b * s;
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) {
      float sum = 0.0f;
#pragma unroll
      for (int k = b; k < N; ++k) {
        if (!W::kExact && k >= d) break;
        sum += y[r][k] * yb[k];
      }
      gi[r][b] = sum;
    }
  }
  __syncthreads();  // every lane has read L^-1
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    if (real[r]) {
#pragma unroll
      for (int b = 0; b < N; ++b)
        if (W::kExact || b < d) seat.mine[col[r] * s + b] = gi[r][b];
    }
  }
  __syncthreads();
  tile_store(inv + run, tile, chains_here * d * d, d);

  float sum_log = 0.0f;
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) sum_log += logf(diag[r]);  // a spare lane adds log 1 = 0
#pragma unroll
  for (int offset = W::kLanes / 2; offset > 0; offset /= 2)
    sum_log += __shfl_xor_sync(0xffffffffu, sum_log, offset, W::kLanes);
  if (seat.chain_ok && seat.lane == 0) half_logdet[seat.chain] = sum_log;
}

// Call f with the Width that serves d: the width itself as a compile-time
// constant for the widths the repo uses (the StochVol hyper block's D = 3;
// tests and the five BLR datasets: 5, 6, 7, 8, 14, 15, 25), else the next
// capacity with the width at run time.  The one place that lists them;
// ops/hopper_linalg.py::launch_geometry mirrors it.
template <typename F>
cudaError_t with_width(int d, F&& f) {
  switch (d) {
    case 3: return f(Width<3, true>{});
    case 5: return f(Width<5, true>{});
    case 6: return f(Width<6, true>{});
    case 7: return f(Width<7, true>{});
    case 8: return f(Width<8, true>{});
    case 14: return f(Width<14, true>{});
    case 15: return f(Width<15, true>{});
    case 25: return f(Width<25, true>{});
    default: break;
  }
  if (d <= 4) return f(Width<4, false>{});
  if (d <= 8) return f(Width<8, false>{});
  if (d <= 16) return f(Width<16, false>{});
  if (d <= 32) return f(Width<32, false>{});
  return f(Width<kMaxDim, false>{});
}

template <typename W>
int blocks_for(int num_chains) { return (num_chains + W::kChains - 1) / W::kChains; }

template <typename W>
size_t tile_bytes(int d) { return sizeof(float) * W::kChains * d * row_stride(d); }

bool bad_shape(int num_chains, int d) { return num_chains < 1 || d < 1 || d > kMaxDim; }

}  // namespace

extern "C" int rhmc_cholesky(const void* g, void* l, int num_chains, int d, void* stream) {
  if (bad_shape(num_chains, d)) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    using W = decltype(width);
    cholesky_kernel<W><<<blocks_for<W>(num_chains), kThreads, tile_bytes<W>(d), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<float*>(l), num_chains, d);
    return cudaGetLastError();
  });
}

extern "C" int rhmc_chol_solve_logdet(const void* g, const void* b, void* x, void* logdet,
                                      int num_chains, int d, void* stream) {
  if (bad_shape(num_chains, d)) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    using W = decltype(width);
    chol_solve_logdet_kernel<W>
        <<<blocks_for<W>(num_chains), kThreads, tile_bytes<W>(d), static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(g), static_cast<const float*>(b), static_cast<float*>(x),
            static_cast<float*>(logdet), num_chains, d);
    return cudaGetLastError();
  });
}

extern "C" int rhmc_chol_inv_logdet(const void* g, void* l, void* inv, void* half_logdet, int num_chains, int d,
                                    void* stream) {
  if (bad_shape(num_chains, d)) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    using W = decltype(width);
    chol_inv_logdet_kernel<W>
        <<<blocks_for<W>(num_chains), kThreads, tile_bytes<W>(d), static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(g), static_cast<float*>(l), static_cast<float*>(inv),
            static_cast<float*>(half_logdet), num_chains, d);
    return cudaGetLastError();
  });
}

// out[0..4]: lanes per chain, rows per lane, chains per block, the tile's row
// stride in floats, the tile's bytes.  No launch; for the wrapper's mirror.
extern "C" int rhmc_launch_geometry(int d, int* out) {
  if (bad_shape(1, d)) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    using W = decltype(width);
    out[0] = W::kLanes, out[1] = W::kRows, out[2] = W::kChains, out[3] = row_stride(d);
    out[4] = static_cast<int>(tile_bytes<W>(d));
    return cudaSuccess;
  });
}
