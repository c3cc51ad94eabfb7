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
// intermediate reaches device memory.  Python wrappers, checks, plain versions and the layout's mirror:
// ops/logreg_fixed_point.py.
//
// What bounds them: the multiply-adds on the CUDA cores (full fp32, FFMA; no TF32, no tensor cores), K4's
// N D (D + 1) / 2 a chain and round for G's upper triangle, K5's 2 N D for X u and X^T (c (Xu)^2); K5's
// one-round half-step the bytes of c.  So both are register-tiled products over a tile of chains, X read
// from shared memory once for all the tile's chains.
//
// K4, a block of 512 threads and K4Plan::kChains chains (32 at D <= 16, 16 at D 25: the factor's groups of W::kLanes
// lanes, 128 blocks for 4,096 chains at every width up to 16), per round from wf = w.  G[c, p] = sum_n v[c, n]
// xx[n, p] over the pairs p = (i, j), i <= j (P = D (D + 1) / 2 of them, row-major: p = i D - i (i - 1) / 2 + j - i),
// xx[n, p] = x_n[i] x_n[j]:
//   * the rows go by in chunks of kChunk.  For each chunk every thread writes part of the pair table xx
//     (kChunk x kPad, shared memory) and part of the weights v (kChunk x kChains): thread (q, c) the logits
//     z = x_n . wf_c of chain c and rows q, q + kLogitSlots, ... (wf_c in its registers, x_n a broadcast),
//     v = p (1 - p), p = 1 / (1 + exp(-z)) (torch.sigmoid's formula, the reciprocal correctly rounded as the
//     division is).  Both are double-buffered: chunk k + 1's table and weights are made while chunk k's
//     products run, one block barrier a chunk;
//   * the products: kSets sets of threads (at most 16) split a chunk's rows (kRowsPerSet each); in a set, thread (cg, pg)
//     holds a 4 x kTP register tile of G (chains 4 cg .., pairs kTP pg ..), and a row costs it one float4
//     load of v, kTP / 4 float4 loads of xx and 4 kTP multiply-adds;
//   * after each tile of X the sets' tiles are added into the sum in shared memory, set 0 first: one set after
//     another (a block barrier each), or, with more than 4 sets (D <= 8), in one pass: the sets write their tiles
//     over the free pair table and weights and each thread adds the sets' values of its entries in order, then
//     that total to the sum.  Every sum is blocked (a set's rows of a tile, the sets, then the tiles), in a fixed
//     order;
//   * G + I / alpha (+ jitter I) written to the factor's tile, both triangles, then K2's factor and
//     substitutions (chol_rows.cuh), a chain on a group of lanes (the warps past kFactorThreads wait at the
//     barrier): u = G^-1 pm; Student-t: u *= (1 + D) /
//     (1 + pm . u); wf = w + 0.5 dt (u0 + u), to shared memory for the next round's logits.
// X stays in shared memory for every round where it fits beside the rest (australian's 690 x 15, german's
// 1000 x 25), as one tile; else it streams in tiles of a multiple of kChunk rows through two stages, every
// round.  Each tile arrives by one bulk copy (TMA) that thread 0 starts and that completes on its stage's
// mbarrier; a streamed stage is refilled as soon as the block is done with it, so the next tile lands while
// this one is used.
//
// K5, a block of 8 warps, a warp kCH chains (4 at D 15, 2 at D 25), per round from pm = pm0:
//   * u = G^-1 pm: lane l owns entries kPer of the warp's kCH x kDp (chain, column) entries (kDp: D to a
//     power of two), holds those rows of G^-1 in registers, and the warp trades pm and u through shared
//     memory; every lane then holds the whole u of the warp's chains;
//   * rows in passes of kK5Pass, lane l rows l and l + 32 of a pass: xu = x_n . u_c for each chain,
//     s = (c_n xu) xu, b_c += s x_n; x_n (D loads) serves kCH chains, 2 kCH D multiply-adds a row and lane,
//     and a row past the end reads row 0 with c = 0, so a pass has no branch;
//   * b summed over the 32 lanes by halving exchanges (each level trades half of what a lane holds), ending
//     with each lane holding its own entries' sums: a fixed tree;
//   * last = 0.5 b, or under Student-t 0.5 (1 + D) b / (1 + pm . u); pm = p + 0.5 dt (base + last).
// X and the block's rows of c arrive by bulk copies of kK5Copy rows (X's rows, and each chain's run of c: one
// copy a lane of warp 0), all started at the launch, each copy's on its own mbarrier, so round 0 computes on
// copy g while later copies land; they stay for the later rounds.  The one-round half-step stages X alone and
// reads c from device memory, coalesced, the next pass's values loaded while this one's are used.  Where X and
// c do not fit (N 20,000), they stream through a ring of three stages every round.
//
// A copy moves the 16-byte-aligned hull of its run (at most 3 floats more at each end), its run at the first
// float's offset: device allocations begin and end on 16-byte boundaries (PyTorch's blocks on 512), so the
// hull lies inside the operand's allocation.
//
// Arithmetic: full fp32, fused multiply-adds.  The sums over the N rows and over D run in another order than
// cuBLAS's, so neither kernel matches the plain version bit for bit; the updates (0.5 dt, the Student-t scale,
// w + ...) are the plain version's operations in its order, each rounded once.  No atomics: every sum has a
// fixed order, so a launch's bits do not depend on timing.  A G that is not positive definite gives NaN or
// inf in its own chain only (K2's factor), as the plain version does; the sampler masks that chain to a
// reject.  Chains past the batch's end compute on copies of its last chain, their stores masked.
//
// Both serve D <= 16 and D 25 (fp_width); a model of another width takes the sampler's loops.
//
// C interface (bound with ctypes): each entry launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "chol_rows.cuh"  // Width, Seat, load_and_factor, back_substitute, with_width

namespace {

constexpr int kSmemMax = 232448;        // the shared memory an H100 block may opt into
constexpr int kStreamBytes = 64 * 1024;  // K4: a stage of streamed X at most
constexpr int kVFloats = 2048;          // K4: a chunk's weights (rows x chains), each of two buffers, at most
constexpr int kXXFloats = 8192;         // K4: a chunk's pair table (rows x pairs), each of two buffers, at most
constexpr int kK5Threads = 256;
constexpr int kK5Copy = 256;            // K5: rows a copy (X's, and each chain's c)
constexpr int kK5Pass = 64;             // K5: rows a pass of the lanes, two a lane
constexpr int kK5MaxCopies = 8;         // K5: X and c stay whole where they fit in at most this many copies
constexpr int kK5RingStages = 3;
constexpr int kK4Threads = 512;
constexpr int kK4MaxSets = 16;          // K4: sets of threads splitting a chunk's rows, at most

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
// Floats a run of n floats' 16-byte-aligned hull spans at most (the run plus 3 floats each side), in whole slots.
__host__ __device__ constexpr long long hull_floats(long long n) { return (n + 9) / 4 * 4; }

// The widths K4 / K5 serve (ops/logreg_fixed_point.py::kernel_width): D <= 16 and D 25.  At the capacities 32 and
// 48 the sampler's loops were faster on an H100 than these kernels and the earlier ones (PERF.md), so none is built.
bool fp_width(int d) { return d >= 1 && (d <= 16 || d == 25); }

template <typename F>
cudaError_t with_fp_width(int d, F&& f) {
  if (!fp_width(d)) return cudaErrorInvalidValue;
  return with_width<16>(d, static_cast<F&&>(f));
}

// K4's tiling at width W (ops/logreg_fixed_point.py::k4_tiles mirrors it).
template <typename W>
struct K4Plan {
  static constexpr int N = W::kN;
  static constexpr int kThreads = kK4Threads;
  static constexpr int kChains = cmin(32, kThreads / W::kLanes);  // a chain a group of the factor's lanes
  static constexpr int kFactorThreads = kChains * W::kLanes;       // the rest sit the factor out
  static constexpr int kTCH = 4;                                   // chains of a thread's tile of G
  static constexpr int kTP = 8;                                    // pairs of a thread's tile of G
  static constexpr int kPairs = N * (N + 1) / 2;
  static constexpr int kPairGroups = (kPairs + kTP - 1) / kTP;
  static constexpr int kPad = kPairGroups * kTP;        // the pair table's width
  static constexpr int kChainGroups = kChains / kTCH;
  static constexpr int kSetThreads = kChainGroups * kPairGroups;
  static constexpr int kSets = cmin(kK4MaxSets, kThreads / kSetThreads);
  static_assert(kSets >= 1, "a set of threads must cover the block's G");
  static constexpr int kRowsPerSet =
      cmax(1, cmin(16, cmin(kVFloats / (kChains * kSets), kXXFloats / (kPad * kSets))));
  static constexpr int kChunk = kSets * kRowsPerSet;
  static constexpr int kTStride = kPad + 4;             // the sum's rows: a skew of 4 banks between chains
  static constexpr int kWfStride = (N + 3) / 4 * 4;
  static constexpr int kLogitSlots = kThreads / kChains;  // rows a pass of the logits
  static constexpr int kXXRowGroups = kPad <= kThreads ? kThreads / kPad : 1;
  static constexpr int kXXPairsPerThread = (kPad + kThreads - 1) / kThreads;
  // The sets' tiles of G are summed in one pass over all of them where there are many (D <= 8: 12-16 sets), else
  // one set after another into the sum (a block barrier a set).  The one pass was the faster on an H100 at D 7 and
  // 8, the other at D 10-25 (PERF.md).
  static constexpr bool kOnePassSum = kSets > 4;
  // The pair table and weights (two buffers each), or between tiles of X the sets' tiles of G over them.
  static constexpr int kScratch = cmax(2 * kChunk * kPad + 2 * kChunk * kChains, kSets * kChains * kPad);
  // Shared floats besides X: that scratch, the sum, the iterates, the factor's tile.
  __host__ __device__ static constexpr long long fixed_floats(int d) {
    return 1LL * kScratch + 1LL * kChains * kTStride + 1LL * kChains * kWfStride + 1LL * kChains * d * row_stride(d);
  }
};

// K5's tiling at width W (ops/logreg_fixed_point.py::k5_tiles mirrors it).
template <typename W>
struct K5Plan {
  static constexpr int N = W::kN;
  static constexpr int kWarps = kK5Threads / 32;
  static constexpr int kCH = N <= 16 ? 4 : 2;                // chains a warp (D 25: 2)
  static constexpr int kChains = kWarps * kCH;
  static constexpr int kDp = cmax(4, pow2_at_least(N));     // b's width, padded
  static constexpr int kValues = kCH * kDp;                  // b's entries a lane sums before the exchange
  static constexpr int kPer = kValues >= 32 ? kValues / 32 : 1;   // entries a lane owns after it
  static constexpr int kShare = kValues >= 32 ? 1 : 32 / kValues;  // lanes holding each entry
  static constexpr int kCSlot = static_cast<int>(hull_floats(kK5Copy));  // a chain's rows of c in a stage
  __host__ __device__ static constexpr long long stage_floats(int d) {
    return hull_floats(1LL * kK5Copy * d) + 1LL * kChains * kCSlot;
  }
};

// A launch's layout; ops/logreg_fixed_point.py::launch_geometry mirrors it.
struct FpLayout {
  int threads;       // a block's
  int chains;        // a block's
  int chunk_rows;    // rows a pass (K4: the pair table's and the weights' chunk; K5: a copy)
  int tile_rows;     // rows a copy of X brings (K4: a multiple of chunk_rows, all of X where whole; K5: a chunk)
  int stages;        // copies resident at once (where whole: every one of the launch)
  int whole;         // X (K5: and c) stays in shared memory for every round
  int shared_bytes;  // the block's
};

template <typename W>
FpLayout k4_layout(int n_rows, int d) {
  using P = K4Plan<W>;
  FpLayout lay{P::kThreads, P::kChains, P::kChunk, 0, 0, 0, 0};
  const long long fixed = P::fixed_floats(d);
  if (16 + 4 * (fixed + hull_floats(1LL * n_rows * d)) <= kSmemMax) {
    lay.tile_rows = n_rows, lay.stages = 1, lay.whole = 1;
  } else {
    long long stage = ((kSmemMax - 16) / 4 - fixed) / 2;
    if (stage > kStreamBytes / 4) stage = kStreamBytes / 4;
    const long long rows = (stage - 9) / d / P::kChunk * P::kChunk;
    lay.tile_rows = static_cast<int>(rows > 0 ? rows : 0), lay.stages = 2, lay.whole = 0;
  }
  lay.shared_bytes = static_cast<int>(16 + 4 * (fixed + lay.stages * hull_floats(1LL * lay.tile_rows * d)));
  return lay;
}

template <typename W>
FpLayout k5_layout(int n_rows, int d) {
  using P = K5Plan<W>;
  FpLayout lay{kK5Threads, P::kChains, kK5Pass, kK5Copy, 0, 0, 0};
  const long long fixed = 2LL * P::kChains * P::kDp, stage = P::stage_floats(d);
  const int copies = (n_rows + kK5Copy - 1) / kK5Copy;
  lay.whole = copies <= kK5MaxCopies && 8 * kK5MaxCopies + 4 * (fixed + copies * stage) <= kSmemMax;
  lay.stages = lay.whole ? copies : kK5RingStages;
  lay.shared_bytes = static_cast<int>(8 * kK5MaxCopies + 4 * (fixed + lay.stages * stage));
  return lay;
}

// -- bulk copies (TMA) on mbarriers ----------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) { return static_cast<unsigned>(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of copies on the barrier's current phase.
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
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

// A run of floats in device memory seen as its 16-byte-aligned hull: the hull's start, the run's first
// float's offset in it (0..3) and the hull's bytes.
struct Hull {
  const float* start;
  int shift;
  unsigned bytes;
};

__device__ __forceinline__ int shift_of(const float* p) { return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3); }

__device__ __forceinline__ Hull hull_of(const float* src, long long count) {
  const int shift = shift_of(src);
  return {src - shift, shift, static_cast<unsigned>((shift + count + 3) / 4 * 16)};
}

__device__ __forceinline__ void bulk_load(float* dst, const Hull& h, unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(h.start), "r"(h.bytes), "r"(smem_u32(bar))
               : "memory");
}

// -- K4's phase stamps -------------------------------------------------------------
//
// Compiled only into the lab build that kernel_ab.py makes for itself with -DRHMC_K4_STAMPS (never into the
// library the port loads): thread 0 of each block adds the clock64() cycles of each phase over the rounds and
// keeps %globaltimer at its start and end.  Elsewhere the hooks are empty.
enum K4Phase { kWaitX, kPairTable, kLogits, kBuild, kChunkSync, kFlush, kFactor, kK4Phases };
#ifdef RHMC_K4_STAMPS
constexpr int kK4StampSlots = kK4Phases + 3;  // the phases' cycles, rounds, globaltimer at start and at end (ns)
constexpr int kMaxStampBlocks = 1 << 12;
__device__ unsigned long long g_k4_stamps[kMaxStampBlocks][kK4StampSlots];
__device__ __forceinline__ unsigned long long k4_global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct K4Stamps {
  unsigned long long acc[kK4StampSlots] = {};
  long long last = 0;
  __device__ __forceinline__ void start() {
    last = clock64();
    acc[kK4Phases + 1] = k4_global_ns();
  }
  __device__ __forceinline__ void mark(K4Phase p) {
    const long long now = clock64();
    acc[p] += now - last;
    last = now;
  }
  __device__ __forceinline__ void round() { ++acc[kK4Phases]; }
  __device__ void write() {
    acc[kK4Phases + 2] = k4_global_ns();
    if (threadIdx.x == 0 && blockIdx.x < kMaxStampBlocks)
      for (int i = 0; i < kK4StampSlots; ++i) g_k4_stamps[blockIdx.x][i] = acc[i];
  }
};
#else
struct K4Stamps {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(K4Phase) {}
  __device__ __forceinline__ void round() {}
  __device__ __forceinline__ void write() {}
};
#endif

// -- K4 ----------------------------------------------------------------------------

// Pair p of width N as (i, j), i <= j, row-major over the upper triangle; (-1, -1) for padding.
template <int N>
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  if (p >= N * (N + 1) / 2) {
    i = j = -1;
    return;
  }
  i = 0;
  while (p >= N - i) p -= N - i, ++i;
  j = i + p;
}

template <int N>
__device__ __forceinline__ int pair_index(int i, int j) { return i * N - i * (i - 1) / 2 + (j - i); }

template <typename W>
__global__ void __launch_bounds__(kK4Threads, 1)
    position_fixed_point_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                const float* __restrict__ pm, const float* __restrict__ u0,
                                const float* __restrict__ dt, float* __restrict__ out, int num_chains, int n_rows,
                                int d_rt, float inv_alpha, float jitter, int rounds, int student_t, FpLayout lay) {
  using P = K4Plan<W>;
  constexpr int N = W::kN, L = W::kLanes, R = W::kRows, TC = P::kChains, CH = P::kChunk, PAD = P::kPad;
  constexpr int TCH = P::kTCH, TP = P::kTP, RPS = P::kRowsPerSet, TS = P::kTStride, WS = P::kWfStride, T = P::kThreads;
  extern __shared__ __align__(16) float smem[];
  K4Stamps stamps;
  stamps.start();
  const int d = W::kExact ? N : d_rt;
  const int s = row_stride(d), t = threadIdx.x;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);  // the stages' mbarriers
  float* xx = smem + 4;                   // the pair table, two buffers of CH x PAD
  float* vbuf = xx + 2 * CH * PAD;        // the weights, two buffers of CH x TC
  float* part = xx;                       // between tiles of X: the sets' tiles of G, kSets x TC x PAD
  float* tsum = smem + 4 + P::kScratch;   // the sum of G's upper triangle, TC x TS
  float* wfs = tsum + TC * TS;            // the iterates, TC x WS
  float* xst = wfs + TC * WS;             // X's stages
  const int stage_floats = static_cast<int>(hull_floats(1LL * lay.tile_rows * d));
  float* tile = xst + lay.stages * stage_floats;  // the factor's tile, TC x d x s
  const int first_chain = blockIdx.x * TC;
  const int chains_here = min(TC, num_chains - first_chain);
  Seat<W> seat(tile, first_chain, chains_here, d);
  const bool factors = t < P::kFactorThreads;  // a group of the factor's (warps past them sit it out)
  seat.mine = tile + (factors ? t / L : 0) * d * s;  // every group, a spare one too, factors in its own part of the tile
  const size_t at = static_cast<size_t>(seat.src_chain) * d;

  bool real[R];
  float w_own[R], u0_own[R], pm_own[R], wf_own[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = min(seat.row(r), d - 1);
    real[r] = factors && seat.real(r, d);
    w_own[r] = w[at + row];
    u0_own[r] = u0[at + row];
    pm_own[r] = pm[at + row];
    wf_own[r] = w_own[r];
  }
  const float h = __fmul_rn(0.5f, dt[seat.src_chain]);
  const float t_scale = static_cast<float>(1 + d);
  for (int e = t; e < TC * WS; e += T) {
    const int c = e / WS, k = e - c * WS;
    wfs[e] = k < d ? w[static_cast<size_t>(first_chain + min(c, chains_here - 1)) * d + k] : 0.0f;
  }

  // The pairs this thread writes into the table, and the first of its rows there.  A padding pair, or one past a
  // run-time width, takes column 0 twice: a finite product in a column of G that nothing reads.
  int xi[P::kXXPairsPerThread], xj[P::kXXPairsPerThread];
  const int xbase = PAD <= T ? t % PAD : t, xrg = PAD <= T ? t / PAD : 0;
#pragma unroll
  for (int m = 0; m < P::kXXPairsPerThread; ++m) {
    pair_of<N>(xbase + m * T, xi[m], xj[m]);
    if (xi[m] < 0 || xj[m] >= d) xi[m] = xj[m] = 0;
  }
  // This thread's tile of G (set, chain group, pair group), and its chain and first row in the logits.
  const bool in_set = t < P::kSets * P::kSetThreads;
  const int set = t / P::kSetThreads, u = t % P::kSetThreads;
  const int cg = u % P::kChainGroups, pg = u / P::kChainGroups;
  const int lc = t % TC, lq = t / TC;

  const int tiles = (n_rows + lay.tile_rows - 1) / lay.tile_rows, loads = lay.whole ? 1 : rounds * tiles;
  // Start tile g's copy into its stage (thread 0).
  auto start_copy = [&](int g) {
    const int row0 = g % tiles * lay.tile_rows, rows = min(lay.tile_rows, n_rows - row0), st = g % lay.stages;
    const Hull hx = hull_of(x + static_cast<size_t>(row0) * d, 1LL * rows * d);
    bar_expect(&bars[st], hx.bytes);
    bulk_load(xst + st * stage_floats, hx, &bars[st]);
  };
  if (t == 0) {
    for (int st = 0; st < lay.stages; ++st) bar_init(&bars[st]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (rounds > 0)
      for (int g = 0; g < min(lay.stages, loads); ++g) start_copy(g);
  }
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    stamps.round();
    float wfr[N];  // the logits' chain's iterate
#pragma unroll
    for (int k = 0; k < N; ++k) wfr[k] = wfs[lc * WS + k];
    float acc[TCH][TP];
#pragma unroll
    for (int a = 0; a < TCH; ++a)
#pragma unroll
      for (int q = 0; q < TP; ++q) acc[a][q] = 0.0f;

    for (int ti = 0; ti < tiles; ++ti) {
      const int g = round * tiles + ti, st = g % lay.stages;
      const int row0 = ti * lay.tile_rows, rows = min(lay.tile_rows, n_rows - row0);
      stamps.mark(kFactor);
      if (!lay.whole || g == 0) bar_wait(&bars[st], (g / lay.stages) & 1);
      stamps.mark(kWaitX);
      const float* xt = xst + st * stage_floats + shift_of(x + static_cast<size_t>(row0) * d);

      // Chunk k's pair table and weights into buffer b: thread t the pairs xbase (+ T ..) of rows xrg, xrg +
      // kXXRowGroups, ..; the logits of chain lc and rows lq, lq + kLogitSlots, .. (x_n a broadcast, wf in
      // registers).
      auto prepare = [&](int k, int b) {
        float* xxb = xx + b * CH * PAD;
        constexpr int RG = P::kXXRowGroups, PPT = P::kXXPairsPerThread;
        if (xrg < RG && (k + 1) * CH <= rows) {  // a whole chunk: no guard, the rows' offsets known at compile time
          const float* xr0 = xt + static_cast<size_t>(k * CH + xrg) * d;
          float* xw = xxb + xrg * PAD + xbase;
#pragma unroll
          for (int i = 0; i < (CH + RG - 1) / RG; ++i) {
            if (CH % RG != 0 && xrg + i * RG >= CH) break;
            const float* xr = xr0 + i * RG * d;
#pragma unroll
            for (int m = 0; m < PPT; ++m) {
              if (PPT > 1 && xbase + m * T >= PAD) break;
              xw[i * RG * PAD + m * T] = __fmul_rn(xr[xi[m]], xr[xj[m]]);
            }
          }
        } else if (xrg < RG) {  // the last chunk of a tile: rows past its end are zero
          for (int r = xrg; r < CH; r += RG) {
            const int row = k * CH + r;
            const float* xr = xt + static_cast<size_t>(row) * d;
#pragma unroll
            for (int m = 0; m < PPT; ++m) {
              const int p = xbase + m * T;
              if (PPT > 1 && p >= PAD) break;
              xxb[r * PAD + p] = row < rows ? __fmul_rn(xr[xi[m]], xr[xj[m]]) : 0.0f;
            }
          }
        }
        stamps.mark(kPairTable);
        float* vb = vbuf + b * CH * TC;
        for (int r = lq; r < CH; r += P::kLogitSlots) {
          const int row = k * CH + r;
          float v = 0.0f;
          if (row < rows) {
            const float* xr = xt + static_cast<size_t>(row) * d;
            float f = 0.0f;
#pragma unroll
            for (int kk = 0; kk < N; ++kk)
              if (W::kExact || kk < d) f = fmaf(xr[kk], wfr[kk], f);
            const float p = __frcp_rn(1.0f + expf(-f));
            v = __fmul_rn(p, __fsub_rn(1.0f, p));
          }
          vb[r * TC + lc] = v;
        }
        stamps.mark(kLogits);
      };
      // Chunk k's products into this thread's tile of G.
      auto build = [&](int k) {
        if (!in_set) return;
        const float* vb = vbuf + (k & 1) * CH * TC + set * RPS * TC + TCH * cg;
        const float* xb = xx + (k & 1) * CH * PAD + set * RPS * PAD + TP * pg;
#pragma unroll
        for (int j = 0; j < RPS; ++j) {
          float va[TCH];
#pragma unroll
          for (int q = 0; q < TCH / 4; ++q) {
            const float4 v4 = reinterpret_cast<const float4*>(vb + j * TC)[q];
            va[4 * q] = v4.x, va[4 * q + 1] = v4.y, va[4 * q + 2] = v4.z, va[4 * q + 3] = v4.w;
          }
          float xv[TP];
#pragma unroll
          for (int q = 0; q < TP / 4; ++q) {
            const float4 x4 = reinterpret_cast<const float4*>(xb + j * PAD)[q];
            xv[4 * q] = x4.x, xv[4 * q + 1] = x4.y, xv[4 * q + 2] = x4.z, xv[4 * q + 3] = x4.w;
          }
#pragma unroll
          for (int a = 0; a < TCH; ++a)
#pragma unroll
            for (int q = 0; q < TP; ++q) acc[a][q] = fmaf(va[a], xv[q], acc[a][q]);
        }
      };

      const int chunks = (rows + CH - 1) / CH;
      prepare(0, 0);
      __syncthreads();
      stamps.mark(kChunkSync);
      for (int k = 0; k < chunks; ++k) {
        if (k + 1 < chunks) prepare(k + 1, (k + 1) & 1);
        build(k);
        stamps.mark(kBuild);
        __syncthreads();  // chunk k's buffers are free; chunk k + 1's are written
        stamps.mark(kChunkSync);
      }
      if constexpr (P::kOnePassSum) {
        // The sets' tiles into the sum: each set's tile to its part of the scratch (the pair table and weights are
        // free), then each thread adds, for its float4s of the sum, the sets' values in order, set 0 first, and that
        // tile of X's total to the sum (the first tile's starts it).
        if (in_set) {
#pragma unroll
          for (int a = 0; a < TCH; ++a) {
            float4* prow = reinterpret_cast<float4*>(part + (set * TC + TCH * cg + a) * PAD + TP * pg);
#pragma unroll
            for (int q = 0; q < TP / 4; ++q)
              prow[q] = make_float4(acc[a][4 * q], acc[a][4 * q + 1], acc[a][4 * q + 2], acc[a][4 * q + 3]);
          }
        }
        __syncthreads();
        for (int e = t; e < TC * PAD / 4; e += T) {
          const int c = e / (PAD / 4), p4 = e - c * (PAD / 4);
          const float4* col = reinterpret_cast<const float4*>(part + c * PAD) + p4;
          float4 sum = col[0];
          for (int st_ = 1; st_ < P::kSets; ++st_) {
            const float4 x4 = col[st_ * TC * PAD / 4];
            sum.x = __fadd_rn(sum.x, x4.x), sum.y = __fadd_rn(sum.y, x4.y);
            sum.z = __fadd_rn(sum.z, x4.z), sum.w = __fadd_rn(sum.w, x4.w);
          }
          float4* dst = reinterpret_cast<float4*>(tsum + c * TS) + p4;
          if (ti > 0) {
            const float4 cur = *dst;
            sum.x = __fadd_rn(cur.x, sum.x), sum.y = __fadd_rn(cur.y, sum.y);
            sum.z = __fadd_rn(cur.z, sum.z), sum.w = __fadd_rn(cur.w, sum.w);
          }
          *dst = sum;
        }
        __syncthreads();  // the sum is whole; the scratch is free for the next tile's pair table
      } else {  // the sets' tiles into the sum one set after another, set 0 first (the first tile's set 0 starts it)
        for (int st_ = 0; st_ < P::kSets; ++st_) {
          if (in_set && set == st_) {
            const bool first = ti == 0 && st_ == 0;
#pragma unroll
            for (int a = 0; a < TCH; ++a) {
              float4* trow = reinterpret_cast<float4*>(tsum + (TCH * cg + a) * TS + TP * pg);
#pragma unroll
              for (int q = 0; q < TP / 4; ++q) {
                float4 cur = first ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : trow[q];
                cur.x = first ? acc[a][4 * q] : __fadd_rn(cur.x, acc[a][4 * q]);
                cur.y = first ? acc[a][4 * q + 1] : __fadd_rn(cur.y, acc[a][4 * q + 1]);
                cur.z = first ? acc[a][4 * q + 2] : __fadd_rn(cur.z, acc[a][4 * q + 2]);
                cur.w = first ? acc[a][4 * q + 3] : __fadd_rn(cur.w, acc[a][4 * q + 3]);
                trow[q] = cur;
              }
            }
          }
          __syncthreads();
        }
      }
#pragma unroll
      for (int a = 0; a < TCH; ++a)
#pragma unroll
        for (int q = 0; q < TP; ++q) acc[a][q] = 0.0f;
      // Every thread is done with this stage: thread 0 refills it with the tile two on.
      if (!lay.whole && t == 0 && g + lay.stages < loads) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        start_copy(g + lay.stages);
      }
      stamps.mark(kFlush);
    }

    // G = X^T diag(v) X + I / alpha, + jitter I (the model's metric, then the sampler's jitter), both triangles,
    // into the factor's tile: a row (chain, i) a thread.
    for (int e = t; e < TC * d; e += T) {
      const int c = e / d, i = e - c * d;
      const float* trow = tsum + c * TS;
      float* grow = tile + c * d * s + i * s;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (!W::kExact && k >= d) break;
        float g = trow[pair_index<N>(min(i, k), max(i, k))];
        if (k == i) g = __fadd_rn(__fadd_rn(g, inv_alpha), jitter);
        grow[k] = g;
      }
    }
    __syncthreads();

    if (factors) {  // whole warps
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
      for (int r = 0; r < R; ++r) {
        wf_own[r] = __fadd_rn(w_own[r], __fmul_rn(h, __fadd_rn(u0_own[r], y[r])));
        if (seat.row(r) < d) wfs[t / L * WS + seat.row(r)] = wf_own[r];
      }
    }
    __syncthreads();  // the next round's logits read the iterates
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (real[r]) out[static_cast<size_t>(seat.chain) * d + seat.row(r)] = wf_own[r];
  stamps.mark(kFactor);
  stamps.write();
}

// -- K5 ----------------------------------------------------------------------------

// The warp's sums b (kCount entries a lane) halved over the lanes at xor distances kMask, kMask / 2, .., 1:
// at each level a lane keeps the half its bit selects and adds its partner's; past one entry a level adds
// the partner's whole.  Lane l ends with entries (l / kShare) kPer + 0 .. kPer - 1 in b[0 .. kPer - 1].
template <int kCount, int kMask, int kV>
__device__ __forceinline__ void halve_over_lanes(float (&b)[kV], int lane) {
  if constexpr (kMask >= 1) {
    if constexpr (kCount >= 2) {
      constexpr int H = kCount / 2;
      const bool up = (lane & kMask) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float lo = b[i], hi = b[i + H];
        const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, kMask);
        b[i] = __fadd_rn(up ? hi : lo, got);
      }
      halve_over_lanes<H, kMask / 2, kV>(b, lane);
    } else {
      b[0] = __fadd_rn(b[0], __shfl_xor_sync(0xffffffffu, b[0], kMask));
      halve_over_lanes<1, kMask / 2, kV>(b, lane);
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kK5Threads, 1)
    momentum_fixed_point_kernel(const float* __restrict__ x, const float* __restrict__ inv,
                                const float* __restrict__ c, const float* __restrict__ p,
                                const float* __restrict__ pm0, const float* __restrict__ base,
                                const float* __restrict__ dt, float* __restrict__ out, int num_chains, int n_rows,
                                int d_rt, int rounds, int student_t, FpLayout lay) {
  using P = K5Plan<W>;
  constexpr int N = W::kN, CH = P::kCH, TC = P::kChains, DP = P::kDp, PER = P::kPer, V = P::kValues;
  constexpr int RC = kK5Copy, CS = P::kCSlot, M = kK5Pass / 32;
  extern __shared__ __align__(16) float smem[];
  const int d = W::kExact ? N : d_rt;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);  // one a stage
  float* pms = smem + 2 * kK5MaxCopies;  // pm of the block's chains, TC x DP
  float* us = pms + TC * DP;             // u likewise
  float* stages = us + TC * DP;
  const int xfl = static_cast<int>(hull_floats(1LL * RC * d));
  const int stage_floats = static_cast<int>(P::stage_floats(d));
  const int first_chain = blockIdx.x * TC;
  const int chains_here = min(TC, num_chains - first_chain);
  const bool stage_c = rounds > 1;
  const int copies = (n_rows + RC - 1) / RC, loads = lay.whole ? copies : rounds * copies;

  // The warp's chains (a spare one reads the batch's last), and the entries of b this lane owns.
  const int slot0 = warp * CH;
  int src[CH];
#pragma unroll
  for (int cc = 0; cc < CH; ++cc) src[cc] = first_chain + min(slot0 + cc, chains_here - 1);
  const int own = lane / P::kShare * PER, own_cc = own / DP, own_col = own % DP;
  const int own_slot = slot0 + own_cc, own_src = first_chain + min(own_slot, chains_here - 1);
  const bool writer = lane % P::kShare == 0;
  float gi[PER][N], p_own[PER], pm_own[PER], base_own[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int col = own_col + i;
    const bool ok = col < d;
    const size_t e = static_cast<size_t>(own_src) * d + col;
    p_own[i] = ok ? p[e] : 0.0f;
    pm_own[i] = ok ? pm0[e] : 0.0f;
    base_own[i] = ok ? base[e] : 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) gi[i][k] = ok && (W::kExact || k < d) ? inv[e * d + k] : 0.0f;
  }
  const float h = __fmul_rn(0.5f, dt[own_src]);
  const float t_coef = 0.5f * static_cast<float>(1 + d);  // 0.5 (1 + D), exact

  // Copy g's rows into its stage (warp 0): X's and, with several rounds, each chain's rows of c.
  auto start_copy = [&](int g) {
    const int row0 = g % copies * RC, rows = min(RC, n_rows - row0), st = g % lay.stages;
    float* stg = stages + st * stage_floats;
    const Hull hx = hull_of(x + static_cast<size_t>(row0) * d, 1LL * rows * d);
    Hull hc{nullptr, 0, 0};
    if (stage_c && lane < chains_here) hc = hull_of(c + static_cast<size_t>(first_chain + lane) * n_rows + row0, rows);
    const unsigned bytes = hx.bytes + __reduce_add_sync(0xffffffffu, hc.bytes);
    if (lane == 0) {
      bar_expect(&bars[st], bytes);
      bulk_load(stg, hx, &bars[st]);
    }
    __syncwarp();
    if (hc.bytes) bulk_load(stg + xfl + lane * CS, hc, &bars[st]);
  };
  if (t == 0) {
    for (int st = 0; st < lay.stages; ++st) bar_init(&bars[st]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0 && rounds > 0)
    for (int g = 0; g < min(lay.stages, loads); ++g) start_copy(g);

  for (int round = 0; round < rounds; ++round) {
    // u = G^-1 pm: this lane's entries, then the warp's chains' whole u in every lane.
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (writer) pms[own_slot * DP + own_col + i] = pm_own[i];
    __syncwarp();
    float u_own[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      u_own[i] = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (W::kExact || k < d) u_own[i] = fmaf(gi[i][k], pms[own_slot * DP + k], u_own[i]);
      if (writer) us[own_slot * DP + own_col + i] = u_own[i];
    }
    __syncwarp();
    float uw[CH][N];
#pragma unroll
    for (int cc = 0; cc < CH; ++cc)
#pragma unroll
      for (int k = 0; k < N; ++k) uw[cc][k] = us[(slot0 + cc) * DP + k];
    float denom = 1.0f;
    if (student_t) {  // 1 + pm . u
      float q = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (W::kExact || k < d) q = __fadd_rn(q, __fmul_rn(pms[own_slot * DP + k], us[own_slot * DP + k]));
      denom = __fadd_rn(1.0f, q);
    }

    float b[V];
#pragma unroll
    for (int e = 0; e < V; ++e) b[e] = 0.0f;
    // The one-round form reads c from device memory: the next pass's values load while this one's are used.
    auto c_at = [&](int cc, int n) { return n < n_rows ? c[static_cast<size_t>(src[cc]) * n_rows + n] : 0.0f; };
    float cnext[M][CH];
    if (!stage_c) {
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int cc = 0; cc < CH; ++cc) cnext[m][cc] = c_at(cc, lane + 32 * m);
    }
    for (int g0 = 0; g0 < copies; ++g0) {
      const int g = lay.whole ? g0 : round * copies + g0, st = g % lay.stages;
      const int row0 = g0 * RC, rows = min(RC, n_rows - row0);
      if (!lay.whole || round == 0) bar_wait(&bars[st], (g / lay.stages) & 1);
      const float* stg = stages + st * stage_floats;
      const float* xt = stg + shift_of(x + static_cast<size_t>(row0) * d);
      const float* ct[CH];
#pragma unroll
      for (int cc = 0; cc < CH; ++cc)
        ct[cc] = stg + xfl + min(slot0 + cc, chains_here - 1) * CS +
                 shift_of(c + static_cast<size_t>(src[cc]) * n_rows + row0);
      for (int r0 = 0; r0 < rows; r0 += kK5Pass) {
        // Rows r0 + lane + 32 m; one past the copy's end reads row 0 with c = 0, so it adds nothing and the
        // pass needs no branch.
        float cv[M][CH];
        const float* xr[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int r = r0 + lane + 32 * m;
          xr[m] = xt + static_cast<size_t>(r < rows ? r : 0) * d;
#pragma unroll
          for (int cc = 0; cc < CH; ++cc) {
            if (stage_c) {
              cv[m][cc] = r < rows ? ct[cc][r] : 0.0f;
            } else {
              cv[m][cc] = cnext[m][cc];
              cnext[m][cc] = c_at(cc, row0 + r + kK5Pass);
            }
          }
        }
        float xv[M][N];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int k = 0; k < N; ++k) xv[m][k] = W::kExact || k < d ? xr[m][k] : 0.0f;
        float xu[M][CH];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int cc = 0; cc < CH; ++cc) xu[m][cc] = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k)
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int cc = 0; cc < CH; ++cc) xu[m][cc] = fmaf(xv[m][k], uw[cc][k], xu[m][cc]);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int cc = 0; cc < CH; ++cc) {
            const float sv = __fmul_rn(__fmul_rn(cv[m][cc], xu[m][cc]), xu[m][cc]);
#pragma unroll
            for (int k = 0; k < N; ++k) b[cc * DP + k] = fmaf(sv, xv[m][k], b[cc * DP + k]);
          }
      }
      if (!lay.whole) {  // the ring: every warp is done with this stage; warp 0 refills it
        __syncthreads();
        if (warp == 0 && g + lay.stages < loads) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          start_copy(g + lay.stages);
        }
      }
    }
    halve_over_lanes<V, 16, V>(b, lane);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float last = student_t ? __fdiv_rn(__fmul_rn(t_coef, b[i]), denom) : __fmul_rn(0.5f, b[i]);
      pm_own[i] = __fadd_rn(p_own[i], __fmul_rn(h, __fadd_rn(base_own[i], last)));
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (writer && own_slot < chains_here && own_col + i < d)
      out[static_cast<size_t>(first_chain + own_slot) * d + own_col + i] = pm_own[i];
}

bool bad_shape(int num_chains, int n_rows, int d) { return num_chains < 1 || n_rows < 1 || d < 1 || d > kMaxDim; }

// Opt the kernel in to more than 48 KB of dynamic shared memory where the layout asks for it (a host call,
// not a stream operation, so it may run while a graph is captured).
template <typename K>
cudaError_t allow_shared(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int blocks_for(int num_chains, const FpLayout& lay) { return (num_chains + lay.chains - 1) / lay.chains; }

template <typename W>
FpLayout fp_layout(bool momentum, int n_rows, int d) {
  return momentum ? k5_layout<W>(n_rows, d) : k4_layout<W>(n_rows, d);
}

}  // namespace

extern "C" int rhmc_position_fixed_point(const void* x, const void* w, const void* pm, const void* u0, const void* dt,
                                         void* out, int num_chains, int n_rows, int d, float inv_alpha, float jitter,
                                         int rounds, int student_t, void* stream) {
  if (bad_shape(num_chains, n_rows, d) || rounds < 0) return cudaErrorInvalidValue;
  return with_fp_width(d, [&](auto width) {
    using W = decltype(width);
    const FpLayout lay = k4_layout<W>(n_rows, d);
    if (lay.tile_rows < 1 || lay.shared_bytes > kSmemMax) return cudaErrorInvalidValue;
    const cudaError_t err = allow_shared(position_fixed_point_kernel<W>, lay.shared_bytes);
    if (err != cudaSuccess) return err;
    position_fixed_point_kernel<W><<<blocks_for(num_chains, lay), lay.threads, lay.shared_bytes,
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
  return with_fp_width(d, [&](auto width) {
    using W = decltype(width);
    const FpLayout lay = k5_layout<W>(n_rows, d);
    if (lay.shared_bytes > kSmemMax) return cudaErrorInvalidValue;
    const cudaError_t err = allow_shared(momentum_fixed_point_kernel<W>, lay.shared_bytes);
    if (err != cudaSuccess) return err;
    momentum_fixed_point_kernel<W><<<blocks_for(num_chains, lay), lay.threads, lay.shared_bytes,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(inv), static_cast<const float*>(c),
        static_cast<const float*>(p), static_cast<const float*>(pm0), static_cast<const float*>(base),
        static_cast<const float*>(dt), static_cast<float*>(out), num_chains, n_rows, d, rounds, student_t, lay);
    return cudaGetLastError();
  });
}

// out[0..6]: the layout of K5 (momentum != 0) or K4 at n_rows x d: threads and chains a block, rows a chunk,
// rows a copy of X, stages, X whole, the block's shared bytes.  No launch.
extern "C" int rhmc_fixed_point_geometry(int momentum, int n_rows, int d, int* out) {
  if (bad_shape(1, n_rows, d)) return cudaErrorInvalidValue;
  return with_fp_width(d, [&](auto width) {
    const FpLayout lay = fp_layout<decltype(width)>(momentum != 0, n_rows, d);
    out[0] = lay.threads, out[1] = lay.chains, out[2] = lay.chunk_rows, out[3] = lay.tile_rows, out[4] = lay.stages;
    out[5] = lay.whole, out[6] = lay.shared_bytes;
    return cudaSuccess;
  });
}

#ifdef RHMC_K4_STAMPS
// The lab build's stamps, blocks x (kK4Phases + 3) unsigned 64-bit values, to host memory; zero them first.
extern "C" int rhmc_k4_stamps(void* out, int blocks) {
  return cudaMemcpyFromSymbol(out, g_k4_stamps, sizeof(unsigned long long) * kK4StampSlots *
                                                    static_cast<size_t>(min(blocks, kMaxStampBlocks)));
}
extern "C" int rhmc_k4_stamps_reset() {
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_k4_stamps);
  return err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_k4_stamps));
}
#endif
