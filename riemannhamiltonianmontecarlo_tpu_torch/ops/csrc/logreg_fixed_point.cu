// The two fixed points of BLR RMHMC's generalized leapfrog, each one launch for every round (sm_90a).
//
// Neither replaces a Pallas kernel.  The JAX package computes both with XLA's GEMMs and fusions:
//   K4 rhmc_position_fixed_point  <- riemannhamiltonianmontecarlo_tpu/samplers/rmhmc.py:208-217, the implicit
//                                    position step (model.metric, models/logreg.py:166-183, then
//                                    ops.solve_psd), with the Student-t scale and the jitter;
//   K5 rhmc_momentum_fixed_point  <- riemannhamiltonianmontecarlo_tpu/samplers/rmhmc.py:193-195 and :220-223,
//                                    the implicit momentum half-step and the explicit one (momentum_force,
//                                    :166-185, through models/logreg.py::dg_bilinear, :200-205).
// In eager PyTorch a round of K4 is a logits GEMM, six passes over a (C, N) tensor, the (C, N) x (N, D^2)
// metric GEMM and K2; a round of K5 a batched matvec, two skinny GEMMs and two (C, N) passes.  A chain's
// rounds depend on that chain alone, so here the loop of rounds runs inside the kernel and no (C, N)
// intermediate reaches device memory.  Python wrappers, checks and plain versions:
// ops/logreg_fixed_point.py.
//
// Layout.  A chain belongs to a group of W::kLanes lanes of one warp, K1 / K2's groups (chol_rows.cuh):
// lane i holds rows i, i + kLanes of the chain's D x D matrices; a block of kFpThreads threads holds
// kFpThreads / kLanes neighbouring chains (16 at D = 15).  X (N, D) is staged in shared memory, its rows
// x_stride floats apart (a multiple of 4, an odd number of 16-byte slots: float4 loads of different rows by
// 8 lanes fall in 8 different slots), once a launch when the whole of it fits the budget (australian's
// 690 x 15 is 55 KB, german's 1000 x 25 112 KB), else in tiles of rows streamed through again every round.
// Every lane of the block reads the same row of X at the same time where a chain needs all of it, so those
// reads are broadcasts.
//
// K4, per chain and round, from wf = w:
//   * lane l computes f_n = x_n . wf for rows n = n0 + l (the chain's wf in every lane's registers),
//     p_n = 1 / (1 + exp(-f_n)) (torch.sigmoid's formula), v_n = p_n (1 - p_n);
//   * for each row n, v_n goes round the group by shuffle and lane i adds v_n x_n[i] x_n[k] to its row of
//     G, k = 0..D-1: G's rows are summed where the factor wants them, in registers;
//   * G += I / alpha (+ jitter I) on the diagonal, then K2's factor and forward substitution
//     (factor_rows) and its back substitution through the chain's shared-memory tile (back_substitute):
//     u = G^-1 pm;
//   * Student-t: u *= (1 + D) / (1 + pm . u); then wf = w + 0.5 dt (u0 + u), lane i its rows, shuffled
//     round the group for the next round.
// K5, per chain and round, from pm = pm0 (G^-1 in the lanes' registers, a row a lane, c in shared memory
// when it fits, so read once a launch):
//   * u = G^-1 pm (lane i its rows; pm_k by shuffle), u shuffled round the group;
//   * lane l takes rows n = l, l + kLanes, ...: xu_n = x_n . u, then b += (c_n xu_n) xu_n x_n; the group's
//     partial b summed by a butterfly of shuffles;
//   * last = 0.5 b, or under Student-t 0.5 (1 + D) b / (1 + pm . u); pm = p + 0.5 dt (base + last).
//
// Arithmetic: full fp32, fused multiply-adds, no TF32 and no tensor cores.  The sums over the N rows and
// over D run in another order than cuBLAS's, so neither kernel matches the plain version bit for bit;
// the updates (0.5 dt, the Student-t scale, w + ...) are the plain version's operations in its order,
// each rounded once.  A G that is not positive definite gives NaN or inf in its own chain only (K2's
// factor), as the plain version does; the sampler masks that chain to a reject.
//
// Spare lanes and chains compute on copies (row d - 1, the block's last chain) with their stores masked,
// as in K1 / K2: every lane of a warp runs every shuffle.  Blocks synchronise only to stage X.
//
// C interface (bound with ctypes): each entry launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

#include "chol_rows.cuh"  // Width, Seat, factor_rows, back_substitute, with_width

namespace {

constexpr int kFpThreads = 256;                   // a block of either kernel
// X is staged whole where it fits this many bytes of shared memory a block beside K4's tiles (K5: c beside it
// too, where both fit), so that an SM holds two blocks (H100: 227 KB an SM); else it streams in 64 KB tiles.
constexpr int kSharedBudget = 112 * 1024;
constexpr int kStreamBytes = 64 * 1024;           // X's tile when the whole of it does not fit

__host__ __device__ constexpr int x_stride(int n) { return ((n + 3) / 4 | 1) * 4; }

// The blocks an SM should hold, for ptxas's register budget 65,536 / (kMinBlocks kFpThreads): two up to 16
// rows (128 registers; with no second bound ptxas held K4 at D 15 to 64 and spilled 4 B), else one (255).
template <typename W>
constexpr int min_blocks() { return W::kN <= 16 ? 2 : 1; }

// K4's build of G: lane (ti, tk) of a chain's group sums the block of rows ti RI .. ti RI + RI - 1 and
// columns tk RK .. tk RK + RK - 1 of G, on a grid of kTI x kTK blocks over the padded width kCols (both
// triangles: the factor reads the lower one).  Each group first writes its chunk of kCH rows of X weighted
// by v_n (lane l < kCH the row n0 + l, v_n x_n) to its own part of a buffer, then a row of the chunk costs
// a lane two vector loads (the weighted row's RI entries, X's row's RK) and RI RK multiply-adds.
template <typename W>
struct Build {
  static constexpr int kTI = W::kLanes <= 8 ? 2 : 4;  // block rows
  static constexpr int kTK = W::kLanes / kTI;          // block columns
  static constexpr int kRI = ((W::kN + kTI - 1) / kTI + 1) / 2 * 2;  // rows a block: even, so float2 / float4
  static constexpr int kRK = ((W::kN + kTK - 1) / kTK + 1) / 2 * 2;  // columns a block: even
  static constexpr int kCols = kTI * kRI > kTK * kRK ? kTI * kRI : kTK * kRK;  // X's padded width
  static constexpr int kXS = ((kCols + 3) / 4 | 1) * 4;  // X's and the buffer's row stride: odd 16-byte slots
  static constexpr int kCH = W::kLanes < 16 ? W::kLanes : 16;  // rows a chunk
  // A group's part of the buffer: its kCH weighted rows and kTI kRI floats more, so that the groups of a warp
  // reading one row each read different banks.
  static constexpr int kPart = kCH * kXS + kTI * kRI;
  static constexpr int kBufFloats = kFpThreads / W::kLanes * kPart;
  __device__ static float* part_of(float* buf, int group) { return buf + group * kPart; }
};

template <typename W>
__host__ __device__ constexpr int x_cols(bool momentum) { return momentum ? W::kN : Build<W>::kCols; }

// A launch's layout; ops/logreg_fixed_point.py::launch_geometry mirrors it.
struct FpLayout {
  int lanes;         // per chain
  int chains;        // per block
  int x_stride;      // floats between X's rows in shared memory
  int x_rows;        // rows of X a tile holds (n_rows when whole)
  int whole;         // X staged once a launch
  int c_staged;      // K5: the block's rows of c in shared memory (else read from device memory every round)
  int shared_bytes;  // the block's
};

template <typename W>
FpLayout fp_layout(bool momentum, int n_rows, int d) {
  FpLayout lay{};
  lay.lanes = W::kLanes;
  lay.chains = kFpThreads / W::kLanes;
  lay.x_stride = x_stride(x_cols<W>(momentum));
  const long long x_bytes = 4LL * n_rows * lay.x_stride;
  // K4's factor tile and weighted rows
  const long long tile = momentum ? 0 : 4LL * (lay.chains * d * row_stride(d) + Build<W>::kBufFloats);
  lay.whole = x_bytes + tile <= kSharedBudget;
  lay.x_rows = lay.whole ? n_rows : kStreamBytes / (4 * lay.x_stride);
  const long long staged = 4LL * lay.x_rows * lay.x_stride;
  const long long c_bytes = 4LL * lay.chains * n_rows;
  lay.c_staged = momentum && lay.whole && staged + c_bytes <= kSharedBudget;
  lay.shared_bytes = static_cast<int>(staged + tile + (lay.c_staged ? c_bytes : 0));
  return lay;
}

// Rows row0 .. row0 + rows - 1 of X into the tile, columns d .. x_stride - 1 zero; all threads of the block.
__device__ __forceinline__ void stage_x(float* xt, const float* __restrict__ x, int row0, int rows, int d, int xs) {
  for (int e = threadIdx.x; e < rows * xs; e += kFpThreads) {
    const int r = e / xs, k = e - r * xs;
    xt[e] = k < d ? x[static_cast<size_t>(row0 + r) * d + k] : 0.0f;
  }
}

// float4 q of row xr (x_stride(W::kN) floats, 16-byte aligned).
__device__ __forceinline__ float4 x4(const float* xr, int q) { return reinterpret_cast<const float4*>(xr)[q]; }

__device__ __forceinline__ float part(const float4& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }

// R floats from xr (16-byte aligned where R % 4 == 0, 8-byte where R % 2 == 0) as the widest vector loads.
template <int R>
__device__ __forceinline__ void load_run(const float* xr, float (&out)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(xr)[q];
      out[4 * q] = v.x, out[4 * q + 1] = v.y, out[4 * q + 2] = v.z, out[4 * q + 3] = v.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const float2 v = reinterpret_cast<const float2*>(xr)[q];
      out[2 * q] = v.x, out[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q) out[q] = xr[q];
  }
}

// K4: one row of a chunk into this lane's block, from the group's weighted row wr and X's row xr.
template <typename W>
__device__ __forceinline__ void accumulate_row(const float* wr, const float* xr, float (&acc)[Build<W>::kRI][Build<W>::kRK]) {
  using B = Build<W>;
  float wi[B::kRI], xk[B::kRK];
  load_run<B::kRI>(wr, wi);
  load_run<B::kRK>(xr, xk);
#pragma unroll
  for (int r = 0; r < B::kRI; ++r)
#pragma unroll
    for (int c = 0; c < B::kRK; ++c) acc[r][c] = fmaf(wi[r], xk[c], acc[r][c]);
}

// K4: a round's sums over the rows of one tile of X into acc = this lane's block of sum_n v_n x_n x_n^T;
// ``mine`` is the group's part of the weighted-row buffer.
template <typename W>
__device__ __forceinline__ void accumulate_metric(int lane, const float* xt, int rows, float* mine, const float (&wf)[W::kN],
                                                  float (&acc)[Build<W>::kRI][Build<W>::kRK]) {
  using B = Build<W>;
  constexpr int N = W::kN, CH = B::kCH, Q = (N + 3) / 4, XS = B::kXS;
  const int i0 = lane / B::kTK * B::kRI, k0 = lane % B::kTK * B::kRK;
  for (int n0 = 0; n0 < rows; n0 += CH) {
    // lane l < kCH: v of row n0 + l (torch.sigmoid's 1 / (1 + exp(-f)), the reciprocal correctly rounded as
    // the division is), and the row weighted by it into the buffer (zero past the tile)
    float v = 0.0f;
    const float* xr = xt + (n0 + lane) * XS;
    float xv[4 * Q];
    if (lane < CH && n0 + lane < rows) {
      float f = 0.0f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 c = x4(xr, q);
        xv[4 * q] = c.x, xv[4 * q + 1] = c.y, xv[4 * q + 2] = c.z, xv[4 * q + 3] = c.w;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * q + i < N) f = fmaf(xv[4 * q + i], wf[4 * q + i], f);
      }
      const float p = __frcp_rn(1.0f + expf(-f));
      v = __fmul_rn(p, __fsub_rn(1.0f, p));
    } else {
#pragma unroll
      for (int k = 0; k < 4 * Q; ++k) xv[k] = 0.0f;
    }
    __syncwarp();  // the group is done with the last chunk's buffer
    if (lane < CH) {
#pragma unroll
      for (int q = 0; q < B::kCols / 4; ++q) {
        float4 wq;
        wq.x = 4 * q < 4 * Q ? __fmul_rn(v, xv[4 * q]) : 0.0f;
        wq.y = 4 * q + 1 < 4 * Q ? __fmul_rn(v, xv[4 * q + 1]) : 0.0f;
        wq.z = 4 * q + 2 < 4 * Q ? __fmul_rn(v, xv[4 * q + 2]) : 0.0f;
        wq.w = 4 * q + 3 < 4 * Q ? __fmul_rn(v, xv[4 * q + 3]) : 0.0f;
        reinterpret_cast<float4*>(mine + lane * XS)[q] = wq;
      }
    }
    __syncwarp();
    const float* wrow = mine + i0;
    const float* xrow = xt + n0 * XS + k0;
    if (n0 + CH <= rows) {  // a whole chunk: every address an offset known at compile time
#pragma unroll
      for (int j = 0; j < CH; ++j) accumulate_row<W>(wrow + j * XS, xrow + j * XS, acc);
    } else {
      for (int j = 0; j < rows - n0; ++j) accumulate_row<W>(wrow + j * XS, xrow + j * XS, acc);
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kFpThreads, min_blocks<W>())
    position_fixed_point_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                const float* __restrict__ pm, const float* __restrict__ u0,
                                const float* __restrict__ dt, float* __restrict__ out, int num_chains, int n_rows,
                                int d_rt, float inv_alpha, float jitter, int rounds, int student_t, FpLayout lay) {
  extern __shared__ __align__(16) float smem[];
  using B = Build<W>;
  constexpr int N = W::kN, L = W::kLanes, R = W::kRows, kChains = kFpThreads / L;
  const int d = W::kExact ? N : d_rt;
  const int xs = B::kXS, s = row_stride(d);
  float* xt = smem;
  float* tile = smem + lay.x_rows * xs;  // the factor's tile after X, then the weighted rows
  float* weighted = B::part_of(tile + kChains * d * s, threadIdx.x / L);
  const int first_chain = blockIdx.x * kChains;
  const int chains_here = min(kChains, num_chains - first_chain);
  Seat<W> seat(tile, first_chain, chains_here, d);
  // Every group, a spare one too, builds and factors in its own part of the tile: no group reads another's.
  seat.mine = tile + threadIdx.x / L * d * s;
  const size_t at = static_cast<size_t>(seat.src_chain) * d;
  const int i0 = seat.lane / B::kTK * B::kRI, k0 = seat.lane % B::kTK * B::kRK;

  bool real[R];
  float w_own[R], u0_own[R], pm_own[R], wf_own[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(seat.row(r), d - 1);
    real[r] = seat.real(r, d);
    w_own[r] = w[at + row];
    u0_own[r] = u0[at + row];
    pm_own[r] = pm[at + row];
    wf_own[r] = w_own[r];
  }
  float wf[N];  // the chain's position iterate, whole in every lane
#pragma unroll
  for (int k = 0; k < N; ++k) wf[k] = (W::kExact || k < d) ? w[at + k] : 0.0f;
  const float h = __fmul_rn(0.5f, dt[seat.src_chain]);
  const float t_scale = static_cast<float>(1 + d);
  const int tiles = (n_rows + lay.x_rows - 1) / lay.x_rows;

  for (int round = 0; round < rounds; ++round) {
    float acc[B::kRI][B::kRK];
#pragma unroll
    for (int r = 0; r < B::kRI; ++r)
#pragma unroll
      for (int c = 0; c < B::kRK; ++c) acc[r][c] = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      const int row0 = t * lay.x_rows, rows = min(lay.x_rows, n_rows - row0);
      if (!lay.whole || round == 0) {
        __syncthreads();  // every lane is done with the last tile
        stage_x(xt, x, row0, rows, d, xs);
        __syncthreads();
      }
      accumulate_metric<W>(seat.lane, xt, rows, weighted, wf, acc);
    }
    // G = X^T diag(v) X + I / alpha, + jitter I (the model's metric, then the sampler's jitter), into the tile
    __syncwarp();  // the last round's back substitution has read the tile
#pragma unroll
    for (int r = 0; r < B::kRI; ++r)
#pragma unroll
      for (int c = 0; c < B::kRK; ++c) {
        const int i = i0 + r, k = k0 + c;
        if (i < d && k < d) seat.mine[i * s + k] = i == k ? __fadd_rn(__fadd_rn(acc[r][c], inv_alpha), jitter) : acc[r][c];
      }
    __syncwarp();

    float a[R][N], diag[R], rhs[R], y[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rhs[r] = pm_own[r];
      y[r] = 1.0f;  // a spare lane keeps it: 1 / 1 at every step of the back substitution
    }
    load_and_factor<W, true>(seat, d, a, diag, rhs, y);  // K2's factor and forward substitution
    __syncwarp();  // every lane has read its row before the back substitution writes L over the tile
    back_substitute<W>(seat, d, a, diag, real, y);  // y[r] = (G^-1 pm)[row]

    if (student_t) {  // u *= (1 + D) / (1 + pm . u)
      float q = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (real[r]) q = __fadd_rn(q, __fmul_rn(pm_own[r], y[r]));
#pragma unroll
      for (int offset = L / 2; offset > 0; offset /= 2) q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, offset, L));
      const float denom = __fadd_rn(1.0f, q);
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] = __fdiv_rn(__fmul_rn(t_scale, y[r]), denom);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) wf_own[r] = __fadd_rn(w_own[r], __fmul_rn(h, __fadd_rn(u0_own[r], y[r])));
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (W::kExact || k < d) wf[k] = __shfl_sync(0xffffffffu, wf_own[k / L], k % L, L);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (real[r]) out[static_cast<size_t>(seat.chain) * d + seat.row(r)] = wf_own[r];
}

template <typename W>
__global__ void __launch_bounds__(kFpThreads, min_blocks<W>())
    momentum_fixed_point_kernel(const float* __restrict__ x, const float* __restrict__ inv,
                                const float* __restrict__ c, const float* __restrict__ p,
                                const float* __restrict__ pm0, const float* __restrict__ base,
                                const float* __restrict__ dt, float* __restrict__ out, int num_chains, int n_rows,
                                int d_rt, int rounds, int student_t, FpLayout lay) {
  extern __shared__ __align__(16) float smem[];
  constexpr int N = W::kN, L = W::kLanes, R = W::kRows, Q = (N + 3) / 4, kChains = kFpThreads / L;
  const int d = W::kExact ? N : d_rt;
  const int xs = lay.x_stride;
  float* xt = smem;
  float* cst = smem + lay.x_rows * xs;  // the block's rows of c, when staged
  const int first_chain = blockIdx.x * kChains;
  const int chains_here = min(kChains, num_chains - first_chain);
  const Seat<W> seat(smem, first_chain, chains_here, d);  // no tile: K5 factors nothing
  const size_t at = static_cast<size_t>(seat.src_chain) * d;
  const float* crow = lay.c_staged ? cst + static_cast<size_t>(seat.src_chain - first_chain) * n_rows
                                   : c + static_cast<size_t>(seat.src_chain) * n_rows;

  bool real[R];
  float gi[R][N], p_own[R], pm_own[R], base_own[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(seat.row(r), d - 1);
    real[r] = seat.real(r, d);
    p_own[r] = p[at + row];
    pm_own[r] = pm0[at + row];
    base_own[r] = base[at + row];
#pragma unroll
    for (int k = 0; k < N; ++k) gi[r][k] = (W::kExact || k < d) ? inv[(at + row) * d + k] : 0.0f;
  }
  const float h = __fmul_rn(0.5f, dt[seat.src_chain]);
  const float t_coef = 0.5f * static_cast<float>(1 + d);  // 0.5 (1 + D), exact
  const int tiles = (n_rows + lay.x_rows - 1) / lay.x_rows;

  for (int round = 0; round < rounds; ++round) {
    float u_own[R];  // u = G^-1 pm, lane i its rows
#pragma unroll
    for (int r = 0; r < R; ++r) u_own[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (!W::kExact && k >= d) break;
      const float pmk = __shfl_sync(0xffffffffu, pm_own[k / L], k % L, L);
#pragma unroll
      for (int r = 0; r < R; ++r) u_own[r] = fmaf(gi[r][k], pmk, u_own[r]);
    }
    float u[N], b[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      u[k] = (W::kExact || k < d) ? __shfl_sync(0xffffffffu, u_own[k / L], k % L, L) : 0.0f;
      b[k] = 0.0f;
    }
    for (int t = 0; t < tiles; ++t) {
      const int row0 = t * lay.x_rows, rows = min(lay.x_rows, n_rows - row0);
      if (!lay.whole || round == 0) {
        __syncthreads();  // every lane is done with the last tile
        stage_x(xt, x, row0, rows, d, xs);
        if (lay.c_staged)
          for (int e = threadIdx.x; e < chains_here * n_rows; e += kFpThreads)
            cst[e] = c[static_cast<size_t>(first_chain) * n_rows + e];
        __syncthreads();
      }
      const float* ct = lay.c_staged ? crow : crow + row0;
      for (int n = seat.lane; n < rows; n += L) {
        const float* xr = xt + n * xs;
        float xv[4 * Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 v = x4(xr, q);
          xv[4 * q] = v.x, xv[4 * q + 1] = v.y, xv[4 * q + 2] = v.z, xv[4 * q + 3] = v.w;
        }
        float xu = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) xu = fmaf(xv[k], u[k], xu);
        const float s = __fmul_rn(__fmul_rn(ct[n], xu), xu);
#pragma unroll
        for (int k = 0; k < N; ++k) b[k] = fmaf(s, xv[k], b[k]);
      }
    }
#pragma unroll
    for (int offset = L / 2; offset > 0; offset /= 2)
#pragma unroll
      for (int k = 0; k < N; ++k) b[k] = __fadd_rn(b[k], __shfl_xor_sync(0xffffffffu, b[k], offset, L));

    float denom = 1.0f;
    if (student_t) {  // 1 + pm . u
      float q = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (real[r]) q = __fadd_rn(q, __fmul_rn(pm_own[r], u_own[r]));
#pragma unroll
      for (int offset = L / 2; offset > 0; offset /= 2) q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, offset, L));
      denom = __fadd_rn(1.0f, q);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float bi = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k == min(seat.row(r), d - 1)) bi = b[k];
      const float last = student_t ? __fdiv_rn(__fmul_rn(t_coef, bi), denom) : __fmul_rn(0.5f, bi);
      pm_own[r] = __fadd_rn(p_own[r], __fmul_rn(h, __fadd_rn(base_own[r], last)));
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (real[r]) out[static_cast<size_t>(seat.chain) * d + seat.row(r)] = pm_own[r];
}

bool bad_shape(int num_chains, int n_rows, int d) { return num_chains < 1 || n_rows < 1 || d < 1 || d > kMaxDim; }

// Opt the kernel in to more than 48 KB of dynamic shared memory where the layout asks for it (once per
// kernel, device and size; a host call, not a stream operation, so it may run while a graph is captured).
template <typename K>
cudaError_t allow_shared(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int blocks_for(int num_chains, const FpLayout& lay) { return (num_chains + lay.chains - 1) / lay.chains; }

}  // namespace

extern "C" int rhmc_position_fixed_point(const void* x, const void* w, const void* pm, const void* u0, const void* dt,
                                         void* out, int num_chains, int n_rows, int d, float inv_alpha, float jitter,
                                         int rounds, int student_t, void* stream) {
  if (bad_shape(num_chains, n_rows, d) || rounds < 0) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    using W = decltype(width);
    const FpLayout lay = fp_layout<W>(false, n_rows, d);
    const cudaError_t err = allow_shared(position_fixed_point_kernel<W>, lay.shared_bytes);
    if (err != cudaSuccess) return err;
    position_fixed_point_kernel<W><<<blocks_for(num_chains, lay), kFpThreads, lay.shared_bytes,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(pm),
        static_cast<const float*>(u0), static_cast<const float*>(dt), static_cast<float*>(out), num_chains, n_rows,
        d, inv_alpha, jitter, rounds, student_t, lay);
    return cudaGetLastError();
  });
}

extern "C" int rhmc_momentum_fixed_point(const void* x, const void* inv, const void* c, const void* p, const void* pm0,
                                         const void* base, const void* dt, void* out, int num_chains, int n_rows,
                                         int d, int rounds, int student_t, void* stream) {
  if (bad_shape(num_chains, n_rows, d) || rounds < 0) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    using W = decltype(width);
    const FpLayout lay = fp_layout<W>(true, n_rows, d);
    const cudaError_t err = allow_shared(momentum_fixed_point_kernel<W>, lay.shared_bytes);
    if (err != cudaSuccess) return err;
    momentum_fixed_point_kernel<W><<<blocks_for(num_chains, lay), kFpThreads, lay.shared_bytes,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(inv), static_cast<const float*>(c),
        static_cast<const float*>(p), static_cast<const float*>(pm0), static_cast<const float*>(base),
        static_cast<const float*>(dt), static_cast<float*>(out), num_chains, n_rows, d, rounds, student_t, lay);
    return cudaGetLastError();
  });
}

// out[0..6]: the layout of K5 (momentum != 0) or K4 at n_rows x d: lanes per chain, chains per block, X's
// row stride in shared memory, X's rows a tile, X whole, c staged, the block's shared bytes.  No launch.
extern "C" int rhmc_fixed_point_geometry(int momentum, int n_rows, int d, int* out) {
  if (bad_shape(1, n_rows, d)) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    const FpLayout lay = fp_layout<decltype(width)>(momentum != 0, n_rows, d);
    out[0] = lay.lanes, out[1] = lay.chains, out[2] = lay.x_stride, out[3] = lay.x_rows, out[4] = lay.whole;
    out[5] = lay.c_staged, out[6] = lay.shared_bytes;
    return cudaSuccess;
  });
}
