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
// Python wrappers, checks and plain-PyTorch twins: ops/hopper_linalg.py.  The width table, the groups of
// lanes, the factor and the two substitutions that K1 / K2 share with K4 (logreg_fixed_point.cu) live in
// chol_rows.cuh.
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
//   * K3 (redesigned for Hopper; see "K3" below).
//
// K3: a warp owns a tile of kChains = 32 / kLanes neighbouring chains (K1's
// groups of lanes, K1's rows a lane), so nothing it computes crosses to
// another warp and no step needs more than __syncwarp: there is no block
// barrier.  The grid holds as many blocks as the card holds at once
// (k3_resident_blocks: the SM count times the occupancy) or as the tiles
// need, whichever is fewer; each warp walks tiles with the grid's stride,
// and while it works one its next tile's G arrives in its second stage.
// A tile's run moves by one 1-D bulk copy (TMA) for its 16-byte-aligned
// body, started by lane 0 and completing on the stage's mbarrier, and 4-byte
// cp.async copies by the lanes for its ragged ends, whatever the operand's
// alignment (the stage holds the run at the operand's own offset from a
// 16-byte boundary), so an unaligned operand gives the same bits through
// the same code.  L leaves as soon as it is formed (the stage, rewritten as
// L's image, goes out by one bulk store while the lanes go on to L^-1),
// G^-1 likewise once its row is formed.  Per tile:
//   * the factor is K1's, operation for operation (so L is K1's bit for
//     bit), but at step j the lanes on and below the diagonal write their
//     L[i][j] once into row j of the chain's L^T in shared memory and every
//     lane reads the multipliers L[k][j], k > j, as float4 (one LDS.128 a 4
//     entries) where K1 shuffles each one; the next pivot goes ahead by
//     shuffle from the lane that owns it.  The square roots and divisions
//     of that path are the IEEE ones' fast paths without their branches
//     (sqrt_rn_positive, div_rn_finite: fast_math.cuh, shared with T1; the
//     same results where the operands lie in fast_range, as for any
//     positive definite metric of ordinary scale), so
//     the steps interleave; where any operand of a tile's path leaves that
//     range (a metric that is not positive definite, entries near 2^+-60,
//     zeros of the wrong sign) the warp factors the tile again with
//     sqrt_exact / div_exact, the IEEE results for every input, branch-free
//     in double precision: no step of K3 calls an out-of-line slow path;
//   * each lane i then puts 1 / L[i][i] (one correctly rounded division a
//     lane, off every dependent chain) in the diagonal slot of L^T, where it
//     read L[i][i]; lane c forms column c of L^-1 one column of L at a time:
//     y_k = s_k * (1 / L[k][k]), then s_i -= L[i][k] y_k for i > k, reading
//     row k of L^T (column k of L) as float4.  Each s_i sees the twin's terms
//     in the twin's order; the twin's division by L[i][i] on the dependent
//     chain becomes a multiplication (ops/hopper_linalg.py::inv_in_kernel_order
//     replays it, chip_smoke.py holds the kernel to the replay bit for bit);
//   * lane c writes its column over row c of L^T (float4 stores) and forms
//     row c of G^-1: entry b sums L^-1[k][c] L^-1[k][b] over k from b on,
//     column b read as float4 from row b.  The terms k < max(a, b) are exact
//     zeros, so (a, b) and (b, a) are the same products summed in the same
//     order: G^-1 is exactly symmetric.
// Bank mapping: L^T's rows are kPad floats (a multiple of 4 with an odd
// number of 16-byte slots: 20 at D = 15, 28 at 25, 4 at 3) and its chains
// kChainStride floats apart (an odd number of 16-byte slots: 300 at D = 15),
// so the kChains <= 8 broadcast float4 loads of a warp (one address a chain)
// fall in kChains different 16-byte slots of the 32 banks (D = 15: the two
// chains at slots s and s + 75 mod 8 = s + 3), and a lane's float4 row
// store meets at most 32 / 8 others in its slot.  The stage is the memory
// image (row stride D): at odd D the lanes' 4-byte reads of their rows and
// writes of L and G^-1 fall in distinct banks, as the odd tile stride of K1
// and K2 gives them.
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
// spills anywhere.  The tile (one matrix a chain) is
// kChains * D * (D | 1) * 4 bytes: 1,152 at D = 3, 7,200 at D = 15, 10,000 at
// D = 25, 37,632 at D = 48, all under the 48 KB that need no opt-in.  K3
// (ptxas of CUDA 12.8): 64-72 registers at the compile-time widths to 8, 108 at 14,
// 121 at 15, 230 at 25, 72-186 at the run-time capacities; no spills
// anywhere; a block's shared memory is K3<W>::kSharedBytes (3,968 B at D = 3,
// 24,192 at 15, 31,296 at 25, 28,464 at 48) and 64 B of mbarriers.
//
// What bounds K3 now: no longer bytes or shared-memory instructions but each
// warp's own latency.  At C = 4096, D = 15 a warp has one tile and every
// warp starts at once, so the kernel lasts about one warp's span: the
// factor's 15 dependent steps (shuffle, square root, division, multiply-add,
// and the column's store and float4 loads) are ~45% of it, waiting for the
// first G (all of it asked for at once, ~1.1 us at the card's rate) ~23%,
// the rest the inverse and the stores (PERF.md: kernel_ab.py's stamped
// phase split).
//
// C interface (bound with ctypes): each entry launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "chol_rows.cuh"  // Width, Seat, load_and_factor, back_substitute, with_width
#include "fast_math.cuh"  // div_rn_finite, sqrt_rn_positive

namespace {

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

// K3's phase stamps, compiled only into the lab build that kernel_ab.py makes
// for itself with -DRHMC_K3_STAMPS (never into the library the port loads):
// lane 0 of each warp adds the clock64() cycles of each phase over its tiles
// and keeps %globaltimer at its start and end.  Elsewhere the hooks are empty.
enum K3Phase { kWaitG, kFactor, kStoreL, kSubst, kProduct, kStoreInv, kPhases };
#ifdef RHMC_K3_STAMPS
constexpr int kStampSlots = kPhases + 3;  // the phases' cycles, tiles, globaltimer at start and at end (ns)
constexpr int kMaxStampWarps = 1 << 15;
__device__ unsigned long long g_k3_stamps[kMaxStampWarps][kStampSlots];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct K3Stamps {
  unsigned long long acc[kStampSlots] = {};
  long long last = 0;
  __device__ __forceinline__ void start() {
    last = clock64();
    acc[kPhases + 1] = global_ns();
  }
  __device__ __forceinline__ void mark(K3Phase p) {
    const long long now = clock64();
    acc[p] += now - last;
    last = now;
  }
  __device__ __forceinline__ void tile() { ++acc[kPhases]; }
  __device__ void write(int warp) {
    acc[kPhases + 2] = global_ns();
    if (threadIdx.x % 32 == 0 && warp < kMaxStampWarps)
      for (int i = 0; i < kStampSlots; ++i) g_k3_stamps[warp][i] = acc[i];
  }
};
#else
struct K3Stamps {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(K3Phase) {}
  __device__ __forceinline__ void tile() {}
  __device__ __forceinline__ void write(int) {}
};
#endif

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

  back_substitute<W>(seat, d, a, diag, real, y);

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

// -- K3 ------------------------------------------------------------------------

constexpr int kK3SharedFloats = 48 * 1024 / 4;  // a block's shared memory without the opt-in

// K3's layout at width W: a warp owns the kChains neighbouring chains of a
// tile (a group of kLanes lanes each, as K1's), so nothing it computes crosses
// to another warp.  Per warp: two stages of kStage floats (a tile's run of G,
// then the images of its L and G^-1) and, per chain, L^T with rows of kPad
// floats (later the columns of L^-1 as rows), kChainStride floats apart.
template <typename W>
struct K3 {
  static constexpr int kN = W::kN;
  static constexpr int kChains = 32 / W::kLanes;  // chains a warp
  // Rows 16-byte aligned, an odd number of 16-byte slots long: a float4 store
  // of each lane's row goes to as many slots of the 8 in 128 bytes as can be.
  static constexpr int kPad = ((kN + 3) / 4 | 1) * 4;
  // An odd number of 16-byte slots between chains: the kChains <= 8 chains of
  // a warp read their broadcast float4 from kChains different slots, one
  // wavefront for the warp.
  static constexpr int kChainStride = kN * kPad / 4 % 2 ? kN * kPad : kN * kPad + 4;
  static constexpr int kStage = (kChains * kN * kN + 6) / 4 * 4;  // a tile's run, its shift (< 4), whole 16 B
  static constexpr int kWarpFloats = 2 * kStage + kChains * kChainStride;
  static constexpr int kWarps = kK3SharedFloats / kWarpFloats < 4 ? kK3SharedFloats / kWarpFloats : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSharedBytes = 4 * kWarps * kWarpFloats;
  // The blocks an SM should hold, ptxas's register budget 65,536 / (kMinBlocks kThreads): with none given it
  // spilled at the run-time capacities 8 and 16; 1 takes what it likes (138 registers at D = 15, too few
  // warps resident); 4 leaves the widths of 4 to 16 lanes 128 and none spills.  At D = 25, 5 and fewer
  // registers spilled (PERF.md), so D = 25 and the capacities take 1.
  static constexpr int kMinBlocks = W::kExact && W::kLanes < 32 ? 4 : 1;
};

// Floats from a (4-byte aligned) pointer to its next 16-byte boundary's offset, mod 4.
__device__ __forceinline__ int shift_of(const float* p) { return (reinterpret_cast<uintptr_t>(p) >> 2) & 3; }

// How a warp's tiles move.  The 16-byte-aligned body of each run moves by
// one bulk copy (TMA, 1-D) that lane 0 starts, G in on its stage's
// mbarrier, L and G^-1 out as a bulk group; the ragged ends (an operand off
// 16-byte alignment, a run whose length is no multiple of 4 floats) by the
// lanes' 4-byte copies.  (The lanes' own 16-byte cp.async for whole runs,
// with no bulk copy, was slower on the H100 at every timed shape: PERF.md.)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
struct K3Transport {
  unsigned bar0 = 0, parity = 0;  // the stages' mbarriers (8 bytes each); bit s: the phase stage s waits for
  int lane = 0;
  __device__ __forceinline__ void init(unsigned long long* bars, int lane_) {
    lane = lane_;
    bar0 = smem_addr(bars);
    if (lane == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
  }
  __device__ __forceinline__ void load(int s, float* stage, const float* __restrict__ src, int count) {
    const int head = min(count, (4 - shift_of(src)) & 3), chunks = (count - head) / 4, tail = head + 4 * chunks;
    float* img = stage + shift_of(src);
    for (int e = lane; e < head; e += 32) cp_async_4(img + e, src + e);
    for (int e = tail + lane; e < count; e += 32) cp_async_4(img + e, src + e);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (lane == 0) {
      const unsigned bar = bar0 + 8 * s, bytes = 16u * chunks;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
      if (bytes)
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                         smem_addr(img + head)),
                     "l"(src + head), "r"(bytes), "r"(bar)
                     : "memory");
    }
  }
  __device__ __forceinline__ void wait(int s, bool newer_pending) {
    if (newer_pending) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar0 + 8 * s), "r"((parity >> s) & 1u)
          : "memory");
    parity ^= 1u << s;
  }
  __device__ __forceinline__ void store(float* __restrict__ dst, const float* stage, int count) {
    const int head = min(count, (4 - shift_of(dst)) & 3), chunks = (count - head) / 4, tail = head + 4 * chunks;
    const float* img = stage + shift_of(dst);
    for (int e = lane; e < head; e += 32) dst[e] = img[e];
    for (int e = tail + lane; e < count; e += 32) dst[e] = img[e];
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the lanes' image writes, to the bulk copy
    __syncwarp();
    if (lane == 0 && chunks > 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst + head),
                   "r"(smem_addr(img + head)), "r"(16u * chunks)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  // Before a stage that a bulk store reads is written again, and before the warp leaves.
  __device__ __forceinline__ void release() {
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncwarp();
  }
};

__device__ __forceinline__ float part(const float4& v, int t) { return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w; }

// The factor's fast path: sqrt_rn_positive and div_rn_finite (fast_math.cuh)
// give the IEEE results bit for bit where every operand lies in fast_range: a
// square root of x in [2^-100, 2^100], a quotient of a = +0 or |a| in
// [2^-60, 2^60] over b in [2^-50, 2^50] (a normal quotient, normal
// remainders, no overflow).
__device__ __forceinline__ bool fast_range(float x, float lo, float hi) {
  return (x >= lo && x <= hi) || (x <= -lo && x >= -hi);
}

// IEEE float32 division and square root (round to nearest, ties to even)
// for every input, with no branch and no call (the compiler's IEEE forms
// call out-of-line slow paths, and a call costs registers saved around it):
// the result to ~2^-60 in double precision from the approximate reciprocal
// (reciprocal square root) and Newton steps, rounded to float32, then moved
// to its neighbour where an exact remainder in double precision puts the
// true value past their midpoint (the product of a float32 and a midpoint,
// 49 bits, is exact in double precision); zeros, infinities and NaN by
// selection.  For the factor's fallback and the reciprocals 1 / L[i][i].
__device__ __forceinline__ float next_up(float x) { return __uint_as_float(__float_as_uint(x) + 1u); }
__device__ __forceinline__ float next_down(float x) { return __uint_as_float(__float_as_uint(x) - 1u); }

__device__ __forceinline__ float div_exact(float a, float b) {
  const float x = fabsf(a), y = fabsf(b);
  const double xd = x, yd = y;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(yd));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fma(r, fma(-yd, r, 1.0), r);
  double qd = xd * r;
  qd = fma(r, fma(-yd, qd, xd), qd);
  // q: the float32 next to x / y on qd's side (the largest finite one past it); n: its neighbour past qd
  // (infinity past the largest, whose midpoint with it is 2^128 - 2^103); m: their midpoint
  const float q = fminf(__double2float_rn(qd), 3.40282347e38f);
  const bool up = qd > static_cast<double>(q);
  const float n = up ? next_up(q) : next_down(q);
  const double m = 0.5 * (static_cast<double>(q) + (isinf(n) ? 0x1p128 : static_cast<double>(n)));
  const double e = fma(-yd, m, xd);  // x - y m, its sign exact
  const bool past = up ? e > 0.0 : e < 0.0;
  float res = past || (e == 0.0 && (__float_as_uint(q) & 1u)) ? n : q;
  res = (y == 0.0f || isinf(x)) ? __int_as_float(0x7f800000) : res;
  res = (x == 0.0f || isinf(y)) ? 0.0f : res;
  res = __uint_as_float(__float_as_uint(res) | ((__float_as_uint(a) ^ __float_as_uint(b)) & 0x80000000u));
  const bool nan = isnan(a) || isnan(b) || (x == 0.0f && y == 0.0f) || (isinf(x) && isinf(y));
  return nan ? __int_as_float(0x7fffffff) : res;
}

__device__ __forceinline__ float sqrt_exact(float x) {
  const double xd = x;
  double y;
  asm("rsqrt.approx.f64 %0, %1;" : "=d"(y) : "d"(xd));
#pragma unroll
  for (int i = 0; i < 3; ++i) y = fma(y, fma(-0.5 * xd * y, y, 0.5), y);
  double sd = xd * y;
  sd = fma(fma(-sd, sd, xd), 0.5 * y, sd);
  const float s = __double2float_rn(sd);  // positive and normal for a positive finite x
  const bool up = sd > static_cast<double>(s);
  const float n = up ? next_up(s) : next_down(s);
  const double m = 0.5 * (static_cast<double>(s) + static_cast<double>(n));
  const double e = fma(-m, m, xd);  // x - m^2, its sign exact; never 0 (m^2 has more bits than x)
  const float res = (up ? e > 0.0 : e < 0.0) ? n : s;
  return (x == 0.0f || x == __int_as_float(0x7f800000)) ? x : (x < 0.0f || isnan(x)) ? __int_as_float(0x7fffffff) : res;
}

// Read this lane's rows from its chain's run in the stage and factor the
// chain: K1's operations in K1's order (load_and_factor), so on return
// a[r][k], k <= row, is L[row][k], bit for bit K1's.  The multipliers L[k][j]
// are read as float4 from row j of the chain's L^T, which the lanes on and
// below the diagonal write at step j, where K1 shuffles each one.  The next
// pivot goes ahead of that broadcast: lane j + 1 updates its own diagonal
// entry with its own L[j + 1][j] (the update below makes the same fused
// multiply-add again) and shuffles it, so the chain of pivots runs shuffle,
// square root, division, multiply-add.  kFast: the square roots and the
// divisions of the entries on and below the diagonal are sqrt_rn_positive
// and div_rn_finite, with no branch, so a step's updates interleave with the next
// pivots; the result is whether an operand on that path fell outside
// fast_range, where the caller factors again with sqrt_exact and div_exact.
template <typename W, bool kFast>
__device__ __forceinline__ bool k3_factor(const float* mine, int d, int lane, float* lt, float (&a)[W::kRows][W::kN]) {
  using T = K3<W>;
  constexpr int N = W::kN, kQuads = (N + 3) / 4;
  const auto row = [&](int r) { return lane % W::kLanes + r * W::kLanes; };
#pragma unroll
  for (int r = 0; r < W::kRows; ++r) {
    const int src_row = min(row(r), d - 1);
#pragma unroll
    for (int k = 0; k < N; ++k) a[r][k] = (W::kExact || k < d) ? mine[src_row * d + k] : 0.0f;
  }
  bool outside = false;
  float pivot = __shfl_sync(0xffffffffu, a[0][0], 0, W::kLanes);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (!W::kExact && j >= d) break;  // the same for every thread
    if (kFast) outside |= !fast_range(pivot, 0x1p-100f, 0x1p100f) || pivot < 0.0f;
    const float root = kFast ? sqrt_rn_positive(pivot) : sqrt_exact(pivot);
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) {
      if (kFast && row(r) >= j && row(r) < d)
        outside |= !(fast_range(a[r][j], 0x1p-60f, 0x1p60f) || __float_as_uint(a[r][j]) == 0u);
      a[r][j] = kFast ? div_rn_finite(a[r][j], root) : div_exact(a[r][j], root);
      if (row(r) >= j && row(r) < d) lt[j * T::kPad + row(r)] = a[r][j];
    }
    if (j + 1 < N && (W::kExact || j + 1 < d)) {
      const int next_slot = (j + 1) / W::kLanes;
      pivot = __shfl_sync(0xffffffffu, a[next_slot][j + 1] - a[next_slot][j] * a[next_slot][j], (j + 1) % W::kLanes,
                          W::kLanes);
    }
    __syncwarp();
    const float4* col = reinterpret_cast<const float4*>(lt + j * T::kPad);
#pragma unroll
    for (int q = (j + 1) / 4; q < kQuads; ++q) {
      if (!W::kExact && 4 * q >= d) break;
      const float4 v = col[q];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = 4 * q + t;
        if (k <= j || k >= N || (!W::kExact && k >= d)) continue;
#pragma unroll
        for (int r = 0; r < W::kRows; ++r) a[r][k] -= a[r][j] * part(v, t);
      }
    }
  }
  return outside;
}

template <typename W>
__global__ void __launch_bounds__(K3<W>::kThreads, K3<W>::kMinBlocks)
    chol_inv_logdet_kernel(const float* __restrict__ g, float* __restrict__ l, float* __restrict__ inv,
                           float* __restrict__ half_logdet, int num_chains, int d_rt) {
  using T = K3<W>;
  constexpr int N = W::kN, kQuads = (N + 3) / 4;
  extern __shared__ __align__(16) float smem[];
  const int d = W::kExact ? N : d_rt, dd = d * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, group = lane / W::kLanes;
  float* const stages = smem + warp * T::kWarpFloats;
  float* const lt = stages + 2 * T::kStage + group * T::kChainStride;  // this group's L^T, then L^-1's columns
  const int tiles = (num_chains + T::kChains - 1) / T::kChains, stride = gridDim.x * T::kWarps;
  const auto run_of = [&](int tile) { return static_cast<size_t>(tile) * T::kChains * dd; };
  const auto count_of = [&](int tile) { return min(T::kChains, num_chains - tile * T::kChains) * dd; };
  int tile = blockIdx.x * T::kWarps + warp;
  const auto row = [&](int r) { return lane % W::kLanes + r * W::kLanes; };
  K3Stamps stamps;
  stamps.start();
  K3Transport move;
  __shared__ unsigned long long bars[4][2];  // the warps' stages' mbarriers
  move.init(bars[warp], lane);
  if (tile < tiles) move.load(0, stages, g + run_of(tile), count_of(tile));
  for (int buf = 0; tile < tiles; tile += stride, buf ^= 1) {
    float* const stage = stages + buf * T::kStage;
    const int next = tile + stride;
    if (next < tiles) {  // the next tile's G arrives while this one is worked
      move.release();
      move.load(buf ^ 1, stages + (buf ^ 1) * T::kStage, g + run_of(next), count_of(next));
    }
    move.wait(buf, next < tiles);
    __syncwarp();
    stamps.tile();
    stamps.mark(kWaitG);

    // This lane's rows: of chain tile * kChains + group, or past C of the tile's last chain (stores masked).
    const size_t run = run_of(tile);
    const int here = count_of(tile) / dd;
    const bool chain_ok = group < here;
    const float* const mine = stage + shift_of(g + run) + min(group, here - 1) * dd;
    float a[W::kRows][N];
    const bool exact = __any_sync(0xffffffffu, k3_factor<W, true>(mine, d, lane, lt, a));
    if (exact) k3_factor<W, false>(mine, d, lane, lt, a);
    // L[i][i] from the diagonal slot of L^T, where lane i wrote it (a spare row: 1, whose log is 0).
    float diag[W::kRows];
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) diag[r] = row(r) < d ? lt[row(r) * T::kPad + row(r)] : 1.0f;
    // Each row's reciprocal 1 / L[i][i], formed once, into the diagonal slot of
    // L^T (which the factor's updates never read); L, as K1 writes it, to the stage.
    float* const limg = stage + shift_of(l + run) + group * dd;
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) {
      if (row(r) >= d) continue;
      if (exact) {
        lt[row(r) * T::kPad + row(r)] = div_exact(1.0f, diag[r]);
      } else {  // the fast path leaves L[i][i] in [2^-50, 2^50]: div_rn_finite's range
        lt[row(r) * T::kPad + row(r)] = div_rn_finite(1.0f, diag[r]);
      }
      if (chain_ok) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          if (W::kExact || k < d) limg[row(r) * d + k] = k <= row(r) ? a[r][k] : 0.0f;
      }
    }
    __syncwarp();
    stamps.mark(kFactor);
    move.store(l + run, stage, here * dd);
    stamps.mark(kStoreL);

    // Column c = min(row, d - 1) of L^-1: L y = e_c, one column of L at a
    // time (s_i -= L[i][k] y_k for i > k: for every s_i the twin's terms in the
    // twin's order), y_k = s_k times the reciprocal of L[k][k].
    float y[W::kRows][N];
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) {
#pragma unroll
      for (int i = 0; i < N; ++i) y[r][i] = i == min(row(r), d - 1) ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (!W::kExact && k >= d) break;
      const float4* lk = reinterpret_cast<const float4*>(lt + k * T::kPad);
#pragma unroll
      for (int q = k / 4; q < kQuads; ++q) {
        if (!W::kExact && 4 * q >= d) break;
        const float4 v = lk[q];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = 4 * q + t;
          if (i < k || i >= N || (!W::kExact && i >= d)) continue;
#pragma unroll
          for (int r = 0; r < W::kRows; ++r) {
            if (i == k) y[r][k] = y[r][k] * part(v, t);
            else y[r][i] -= part(v, t) * y[r][k];
          }
        }
      }
    }
    __syncwarp();  // every lane has read L^T
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) {
      if (row(r) >= d) continue;
      float4* dst = reinterpret_cast<float4*>(lt + row(r) * T::kPad);  // column c of L^-1 as row c
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        if (!W::kExact && 4 * q >= d) break;
        dst[q] = make_float4(y[r][4 * q], 4 * q + 1 < N ? y[r][4 * q + 1] : 0.0f,
                             4 * q + 2 < N ? y[r][4 * q + 2] : 0.0f, 4 * q + 3 < N ? y[r][4 * q + 3] : 0.0f);
      }
    }
    __syncwarp();
    move.release();  // L has left the stage
    stamps.mark(kSubst);

    // Row c of G^-1: entry b sums L^-1[k][c] L^-1[k][b] over k from b on,
    // column b of L^-1 read as float4 from row b.  With one row a lane the
    // row is held and goes to the stage's image of G^-1 at the end, so that
    // no store stands between one entry's loads and the next's; with two
    // (D > 32) each entry goes as it is formed, within the registers.
    float* const iimg = stage + shift_of(inv + run) + group * dd;
    constexpr bool kHold = W::kRows == 1;
    float held[kHold ? N : 1];
#pragma unroll
    for (int b = 0; b < N; ++b) {
      if (!W::kExact && b >= d) break;
      const float4* yb = reinterpret_cast<const float4*>(lt + b * T::kPad);
      float sum[W::kRows];
#pragma unroll
      for (int r = 0; r < W::kRows; ++r) sum[r] = 0.0f;
#pragma unroll
      for (int q = b / 4; q < kQuads; ++q) {
        if (!W::kExact && 4 * q >= d) break;
        const float4 v = yb[q];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = 4 * q + t;
          if (k < b || k >= N || (!W::kExact && k >= d)) continue;
#pragma unroll
          for (int r = 0; r < W::kRows; ++r) sum[r] += y[r][k] * part(v, t);
        }
      }
      if (kHold) {
        held[kHold ? b : 0] = sum[0];
      } else {
#pragma unroll
        for (int r = 0; r < W::kRows; ++r)
          if (chain_ok && row(r) < d) iimg[row(r) * d + b] = sum[r];
      }
    }
    if (kHold && chain_ok && row(0) < d) {
#pragma unroll
      for (int b = 0; b < N; ++b)
        if (W::kExact || b < d) iimg[row(0) * d + b] = held[kHold ? b : 0];
    }
    __syncwarp();
    stamps.mark(kProduct);
    move.store(inv + run, stage, here * dd);

    float sum_log = 0.0f;
#pragma unroll
    for (int r = 0; r < W::kRows; ++r) sum_log += logf(diag[r]);  // a spare lane adds log 1 = 0
#pragma unroll
    for (int offset = W::kLanes / 2; offset > 0; offset /= 2)
      sum_log += __shfl_xor_sync(0xffffffffu, sum_log, offset, W::kLanes);
    if (chain_ok && lane % W::kLanes == 0) half_logdet[tile * T::kChains + group] = sum_log;
    __syncwarp();  // the stage and L^T are rewritten only when every lane is done with them
    stamps.mark(kStoreInv);
  }
  move.release();
  stamps.write(blockIdx.x * T::kWarps + warp);
}

template <typename W>
int blocks_for(int num_chains) { return (num_chains + W::kChains - 1) / W::kChains; }

template <typename W>
size_t tile_bytes(int d) { return sizeof(float) * W::kChains * d * row_stride(d); }

bool bad_shape(int num_chains, int d) { return num_chains < 1 || d < 1 || d > kMaxDim; }

// The blocks of K3 at width W that the current device holds at once (its SM
// count times the occupancy, the SM's memory given to shared memory first),
// asked once per device and kept.
template <typename W>
int k3_resident_blocks() {
  constexpr int kDevices = 64;
  static int kept[kDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kDevices && kept[dev] > 0) return kept[dev];
  int sms = 0, per_sm = 0;
  cudaFuncSetAttribute(chol_inv_logdet_kernel<W>, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_inv_logdet_kernel<W>, K3<W>::kThreads,
                                                K3<W>::kSharedBytes);
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev >= 0 && dev < kDevices) kept[dev] = blocks;
  return blocks;
}

// K3's grid: a block for every kWarps tiles, at most as many as the device
// holds at once (the warps then walk more than one).  (Fewer blocks, two
// tiles a warp where the card could hold them all, were slower: PERF.md.)
template <typename W>
int k3_blocks(int num_chains) {
  using T = K3<W>;
  const int tiles = (num_chains + T::kChains - 1) / T::kChains, per_block = T::kWarps;
  const int wanted = (tiles + per_block - 1) / per_block, resident = k3_resident_blocks<W>();
  return wanted < resident ? wanted : resident;
}

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
    chol_inv_logdet_kernel<W><<<k3_blocks<W>(num_chains), K3<W>::kThreads, K3<W>::kSharedBytes,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<float*>(l), static_cast<float*>(inv),
        static_cast<float*>(half_logdet), num_chains, d);
    return cudaGetLastError();
  });
}

#ifdef RHMC_K3_STAMPS
// The lab build's stamps, warps x (kPhases + 3) unsigned 64-bit values, to host memory; zero them first with reset.
extern "C" int rhmc_k3_stamps(void* out, int warps) {
  return cudaMemcpyFromSymbol(out, g_k3_stamps, sizeof(unsigned long long) * kStampSlots *
                                  (warps < kMaxStampWarps ? warps : kMaxStampWarps));
}
extern "C" int rhmc_k3_stamps_reset() {
  void* p;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_k3_stamps);
  return err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_k3_stamps));
}
#endif

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

// out[0..7]: K3's lanes per chain, rows per lane, chains per warp, warps per
// block, L^T's row stride and chain stride (floats), a stage's floats and the
// block's shared bytes.  No launch; for the wrapper's mirror.
extern "C" int rhmc_k3_geometry(int d, int* out) {
  if (bad_shape(1, d)) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    using W = decltype(width);
    using T = K3<W>;
    out[0] = W::kLanes, out[1] = W::kRows, out[2] = T::kChains, out[3] = T::kWarps, out[4] = T::kPad;
    out[5] = T::kChainStride, out[6] = T::kStage, out[7] = T::kSharedBytes;
    return cudaSuccess;
  });
}

// out[0..1]: the blocks K3 launches for num_chains chains of width d on the
// current device, and the blocks of it that the device holds at once.
extern "C" int rhmc_k3_grid(int num_chains, int d, int* out) {
  if (bad_shape(num_chains, d)) return cudaErrorInvalidValue;
  return with_width(d, [&](auto width) {
    using W = decltype(width);
    out[0] = k3_blocks<W>(num_chains), out[1] = k3_resident_blocks<W>();
    return cudaSuccess;
  });
}
