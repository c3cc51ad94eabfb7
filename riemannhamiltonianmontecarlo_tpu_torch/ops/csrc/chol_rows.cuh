// A chain's small SPD matrix factored on a group of lanes of one warp, row i
// on lane i: the layout, the elimination and the substitutions that K1 / K2
// (hopper_linalg.cu) and the position fixed point K4 (logreg_fixed_point.cu)
// share.  hopper_linalg.cu's head comment describes the design; what is
// here is the part that does not depend on where a chain's G comes from (a
// shared-memory tile for K1 / K2, the lanes' own sums for K4).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 48;  // ops/linalg.py UNROLL_MAX_DIM
constexpr int kThreads = 128;  // K1's and K2's blocks

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
  static constexpr int kChains = kThreads / kLanes;          // chains per block of kThreads
};

// Call f with the Width that serves d: the width itself as a compile-time
// constant for the widths the repo uses (the StochVol hyper block's D = 3;
// tests and the five BLR datasets: 5, 6, 7, 8, 14, 15, 25), else the next
// capacity with the width at run time.  The one place that lists them;
// ops/hopper_linalg.py::launch_geometry mirrors it.
// kLargestCapacity: the largest capacity instantiated (K4 / K5 build none past 16 rows); a wider d is refused.
template <int kLargestCapacity = kMaxDim, typename F>
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
  if constexpr (kLargestCapacity > 16) {
    if (d <= 32) return f(Width<32, false>{});
    return f(Width<kMaxDim, false>{});
  } else {
    return cudaErrorInvalidValue;
  }
}

// Where a thread stands: its lane in the group, its chain and whether that
// chain exists, and the chain it reads (its own, or the block's last one) with
// that chain's part of the tile (d rows of row_stride(d) floats a chain).
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

// Factor the chain whose rows this lane holds: a[r] comes in as row
// min(row(r), d - 1) of G (a spare lane holds a copy of row d - 1; at a
// run-time width, a[r][k] = 0 for k >= d).  On return a[r][k], k <= row, is
// L[row][k] and diag[r] is L[row][row] (1 for a spare lane).  Only the lower
// triangle is read; the entries above it must be ordinary numbers (they are
// divided, and a division leaves its fast path on 0 or inf).  With kSolve,
// rhs[r] comes in as b[row] and y[r] goes out as (L^-1 b)[row].
template <typename W, bool kSolve>
__device__ __forceinline__ void factor_rows(const Seat<W>& seat, int d, float (&a)[W::kRows][W::kN],
                                            float (&diag)[W::kRows], float (&rhs)[W::kRows], float (&y)[W::kRows]) {
  constexpr int N = W::kN;
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) diag[r] = 1.0f;
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

// Read this lane's rows from the tile and factor the chain (factor_rows).
template <typename W, bool kSolve>
__device__ __forceinline__ void load_and_factor(const Seat<W>& seat, int d, float (&a)[W::kRows][W::kN],
                                                float (&diag)[W::kRows], float (&rhs)[W::kRows],
                                                float (&y)[W::kRows]) {
  constexpr int N = W::kN;
  const int s = row_stride(d);
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    const int src_row = min(seat.row(r), d - 1);
#pragma unroll
    for (int k = 0; k < N; ++k) a[r][k] = (W::kExact || k < d) ? seat.mine[src_row * s + k] : 0.0f;
  }
  factor_rows<W, kSolve>(seat, d, a, diag, rhs, y);
}

// After factor_rows<W, true>: L^T x = y, from the last row up, x into y.  The
// strict lower triangle goes to the chain's part of the tile, for the column
// reads (a lane writes its own row only, and has read it); lane k broadcasts
// x_k, lane i < k subtracts L[k][i] x_k, reading column i of the tile.  A
// spare lane must come in with y[r] = 1 (it divides 1 by 1 at every step).
template <typename W>
__device__ __forceinline__ void back_substitute(const Seat<W>& seat, int d, const float (&a)[W::kRows][W::kN],
                                                const float (&diag)[W::kRows], const bool (&real)[W::kRows],
                                                float (&y)[W::kRows]) {
  constexpr int N = W::kN;
  const int s = row_stride(d);
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    if (real[r]) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < seat.row(r)) seat.mine[seat.row(r) * s + k] = a[r][k];
    }
  }
  __syncwarp();  // a group lies inside one warp

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
}

}  // namespace
