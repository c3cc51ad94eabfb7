"""The two fixed points of RMHMC's generalized leapfrog, and BLR's kernels for them.

Port of the fixed-point loops of ``riemannhamiltonianmontecarlo_tpu/samplers/rmhmc.py``
(``:193-195`` momentum, ``:208-217`` position, ``:220-223`` the explicit half-step):

* the position update: from wf = w, ``rounds`` times
  u = G(wf)^-1 pm (Student-t: u *= (1 + D) / (1 + pm . u)), wf = w + 0.5 dt (u0 + u);
* the momentum update: from pm = pm0, ``rounds`` times
  u = G^-1 pm, b = [u^T dG_d u]_d, last = 0.5 b (Student-t: 0.5 (1 + D) b / (1 + pm . u)),
  pm = p + 0.5 dt (base + last);
  the explicit half-step is one round with p = pm0 = pm.

``*_plain`` are the sampler's loops, moved here unchanged: any model with
``metric`` (position) and ``dg_bilinear`` (momentum), the solve through
``ops.solve_psd(method=)`` (K2 on a CUDA batch unless the method says
otherwise).  The sampler runs them for every model without the two methods
of ``models.LogisticRegression``.

For a logistic regression on a card both loops are hand-written kernels of
``csrc/logreg_fixed_point.cu``, every round inside one launch (the JAX
package has no Pallas kernel here; XLA compiles its loops):

* K4 ``position_fixed_point_cuda``: each round builds the upper triangle of
  G = X^T diag(v) X for a tile of chains as a register-tiled product of the
  weights v and a pair table x_n[i] x_n[j] (``k4_tiles``, ``pair_of``; sets
  of threads split the rows and their tiles are added in a fixed order), adds
  I / alpha (+ jitter I), factors it and solves (K2's code), X arriving by
  bulk copies; no (C, N) intermediate and no G reaches device memory;
* K5 ``momentum_fixed_point_cuda``: each round's u, X u and X^T (c (Xu)^2),
  a warp's chains sharing each row of X, the lanes' sums halved over the
  warp (``k5_tiles``, ``k5_owned``), X and c arriving by bulk copies while
  round 0 runs and staying for the later rounds.

Both serve the widths ``kernel_width`` names (D <= 16 and D 25); a model of
another width takes the loops.  Each ``*_cuda`` checks its operands (a CUDA
device shared by all, float32, shapes, contiguity, a width the kernels
serve), allocates its output with
``torch.empty``, launches on the current stream, counts the launch
(``ops.launches``) and raises on anything else, a CPU tensor included.
``position_fixed_point`` / ``momentum_fixed_point`` take the plain version
for a CPU batch and the kernel for a CUDA one, never a fallback from one to
the other.  The library is built by ``ops._build`` at the first CUDA call,
never at import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.ops import _build, hopper_linalg, launches, linalg

MAX_DIM = hopper_linalg.MAX_DIM
POSITION, MOMENTUM = "position_fixed_point", "momentum_fixed_point"  # their names in ops.launches
_COUNTED = (POSITION, MOMENTUM)
_KERNEL_DEVICE = "cuda"

# The layout, mirrored from csrc/logreg_fixed_point.cu (chip_smoke.py holds it against the built library).
SHARED_OPT_IN = 232448  # kSmemMax: the shared memory an H100 block may opt into
STREAM_BYTES = 64 * 1024  # kStreamBytes: K4's stage of streamed X at most
K4_V_FLOATS = 2048  # kVFloats: a chunk's weights (rows x chains), each of K4's two buffers, at most
K4_XX_FLOATS = 8192  # kXXFloats: a chunk's pair table (rows x pairs), each of K4's two buffers, at most
K4_THREADS = 512  # kK4Threads
K4_MAX_SETS = 16  # kK4MaxSets: sets of K4's threads splitting a chunk's rows, at most
K5_THREADS = 256  # kK5Threads
K5_COPY = 256  # kK5Copy: rows a copy of K5 (X's, and each chain's c)
K5_PASS = 64  # kK5Pass: rows a pass of K5's lanes, two a lane
K5_MAX_COPIES = 8  # kK5MaxCopies: X and c stay whole where they fit in at most this many copies
K5_RING_STAGES = 3  # kK5RingStages


def launch_counts() -> dict[str, int]:
    """Launches of K4 and K5 since the last reset (``ops.launches``)."""
    return launches.counts(_COUNTED)


def reset_launch_counts() -> None:
    launches.reset(_COUNTED)


class FixedPointGeometry(NamedTuple):
    """How K4 / K5 lay (N, D) out on the card (csrc: ``FpLayout``)."""

    threads: int  # a block's
    chains: int  # a block's
    chunk_rows: int  # rows a pass (K4: the pair table's and the weights' chunk; K5: a copy)
    tile_rows: int  # rows a copy of X brings (K4: a multiple of chunk_rows, all of X where whole; K5: a chunk)
    stages: int  # copies resident at once (where whole: every one of the launch)
    whole: int  # 1 where X (K5: and c) stays in shared memory for every round
    shared_bytes: int  # the block's


class K4Tiles(NamedTuple):
    """K4's register tiling of G's upper triangle (csrc: ``K4Plan``): ``sets`` sets of threads split a chunk's
    rows, ``rows_per_set`` each; in a set, thread (cg, pg) sums chains 4 cg .. 4 cg + 3 and pairs tp pg ..
    tp pg + tp - 1 of the pair table (``pair_of``).  The logits: thread (q, c) computes chain c's of rows q,
    q + logit_slots, .. of a chunk (``k4_logit_tile``).  Between tiles of X the sets' tiles of G lie over the pair
    table and weights (``scratch`` floats, the larger of the two) where they are summed in one pass
    (``one_pass_sum``: more than 4 sets), else one set after another."""

    threads: int
    chains: int  # a block's: the factor's groups of lanes
    factor_threads: int  # the factor's: chains x lanes (the rest sit it out)
    chains_per_thread: int
    pairs_per_thread: int
    pairs: int  # D (D + 1) / 2 at the width the kernel is unrolled for
    padded_pairs: int  # the pair table's width
    set_threads: int
    sets: int
    rows_per_set: int
    chunk: int  # rows a chunk: sets x rows_per_set
    logit_slots: int  # rows a pass of the logits
    scratch: int  # floats: the pair table and weights (two buffers each), or the sets' tiles of G
    one_pass_sum: bool  # the sets' tiles summed in one pass (more than 4 sets), else one set after another


class K5Tiles(NamedTuple):
    """K5's tiling (csrc: ``K5Plan``): a warp's ``chains_per_warp`` chains, b's ``padded_width`` columns each; after
    the halving exchange lane l owns entries (l // lanes_per_entry) entries_per_lane + 0 .. entries_per_lane - 1
    of the warp's chains_per_warp x padded_width (chain, column) entries."""

    threads: int
    chains: int  # a block's
    chains_per_warp: int
    padded_width: int
    entries_per_lane: int
    lanes_per_entry: int


def kernel_width(d: int) -> bool:
    """Whether K4 / K5 serve width ``d`` (csrc: ``fp_width``), and so whether a whole model of that width takes them
    (``LogisticRegression.fixed_point_kernels``): D <= 16 (the exact widths and the capacities 4, 8, 16) and D 25.
    At the capacities 32 and 48 (D 17-24 and 26-48) the sampler's loops were faster on an H100 than these kernels
    and the earlier ones (``kernel_ab.py --kernels fixed_point`` at D 20, 32 and 48; PERF.md): none is built there."""
    return 1 <= d <= 16 or d == 25


def _unrolled_rows(d: int) -> int:
    """The rows the kernels are unrolled for (csrc: ``with_fp_width``): d itself, or the next capacity."""
    if not kernel_width(d):
        raise ValueError(f"K4 / K5 serve 1 <= D <= 16 and D 25, got D = {d}")
    return d if d in hopper_linalg.EXACT_WIDTHS else next(cap for cap in hopper_linalg.CAPACITIES if d <= cap)


def _hull_floats(n: int) -> int:
    """Floats a run of n floats' 16-byte-aligned hull spans at most, in whole 16-byte slots (csrc: hull_floats)."""
    return (n + 9) // 4 * 4


def k4_tiles(d: int) -> K4Tiles:
    """K4's tiles at width ``d``, mirrored from the source."""
    n, threads, lanes = _unrolled_rows(d), K4_THREADS, hopper_linalg.launch_geometry(d).lanes_per_chain
    chains = min(32, threads // lanes)
    tch, tp = 4, 8
    pairs = n * (n + 1) // 2
    pad = -(-pairs // tp) * tp
    set_threads = chains // tch * (pad // tp)
    sets = min(K4_MAX_SETS, threads // set_threads)
    rows = max(1, min(16, K4_V_FLOATS // (chains * sets), K4_XX_FLOATS // (pad * sets)))
    chunk = sets * rows
    scratch = max(2 * chunk * pad + 2 * chunk * chains, sets * chains * pad)
    return K4Tiles(threads, chains, chains * lanes, tch, tp, pairs, pad, set_threads, sets, rows, chunk,
                   threads // chains, scratch, sets > 4)


def k4_logit_tile(d: int, thread: int) -> tuple[int, list[int]]:
    """(chain, rows of a chunk) whose logits K4's ``thread`` computes at width ``d``."""
    k = k4_tiles(d)
    return thread % k.chains, list(range(thread // k.chains, k.chunk, k.logit_slots))


def pair_of(p: int, n: int) -> tuple[int, int] | None:
    """Pair ``p`` of width ``n`` as (i, j), i <= j, row-major over the upper triangle; None for padding."""
    if p >= n * (n + 1) // 2:
        return None
    i = 0
    while p >= n - i:
        p, i = p - (n - i), i + 1
    return i, i + p


def k4_thread_tile(d: int, thread: int) -> tuple[int, range, range] | None:
    """(set, chains, pair-table columns) of K4's ``thread`` at width ``d``; None for a thread outside the sets."""
    k = k4_tiles(d)
    if thread >= k.sets * k.set_threads:
        return None
    u = thread % k.set_threads
    groups = k.chains // k.chains_per_thread
    cg, pg = u % groups, u // groups
    return (thread // k.set_threads, range(k.chains_per_thread * cg, k.chains_per_thread * (cg + 1)),
            range(k.pairs_per_thread * pg, k.pairs_per_thread * (pg + 1)))


def k5_tiles(d: int) -> K5Tiles:
    """K5's tiles at width ``d``, mirrored from the source."""
    n = _unrolled_rows(d)
    per_warp = 4 if n <= 16 else 2
    width = max(4, 1 << (n - 1).bit_length())
    values = per_warp * width
    return K5Tiles(K5_THREADS, K5_THREADS // 32 * per_warp, per_warp, width, max(1, values // 32),
                   max(1, 32 // values))


def k5_owned(d: int, lane: int) -> list[tuple[int, int]]:
    """The (chain of the warp, column) entries of b that K5's ``lane`` holds after the halving exchange."""
    k = k5_tiles(d)
    first = lane // k.lanes_per_entry * k.entries_per_lane
    return [divmod(first + i, k.padded_width) for i in range(k.entries_per_lane)]


def launch_geometry(kernel: str, n: int, d: int) -> FixedPointGeometry:
    """K4's (``kernel`` = ``POSITION``) or K5's (``MOMENTUM``) layout at N rows of width D, as
    ``csrc/logreg_fixed_point.cu::k4_layout`` / ``k5_layout`` compute it.  K4: X whole in one copy where it fits
    beside the pair table, the weights, the sum, the iterates and the factor's tile (D (D | 1) floats a chain),
    else streamed through two stages of a multiple of the chunk's rows; K5: X and c in copies of 256 rows, all
    resident where at most 8 of them fit, else a ring of three."""
    if kernel not in _COUNTED:
        raise ValueError(f"kernel must be one of {_COUNTED}, got {kernel!r}")
    if n < 1 or not kernel_width(d):
        raise ValueError(f"the CUDA kernels take N >= 1 and 1 <= D <= 16 or D 25, got N = {n}, D = {d}")
    if kernel == POSITION:
        k = k4_tiles(d)
        wf_stride = -(-_unrolled_rows(d) // 4) * 4
        fixed = k.scratch + k.chains * (k.padded_pairs + 4) + k.chains * wf_stride + k.chains * d * (d | 1)
        if 16 + 4 * (fixed + _hull_floats(n * d)) <= SHARED_OPT_IN:
            tile_rows, stages, whole = n, 1, 1
        else:
            stage = min(((SHARED_OPT_IN - 16) // 4 - fixed) // 2, STREAM_BYTES // 4)
            tile_rows, stages, whole = max(0, (stage - 9) // d // k.chunk * k.chunk), 2, 0
        return FixedPointGeometry(k.threads, k.chains, k.chunk, tile_rows, stages, whole,
                                  16 + 4 * (fixed + stages * _hull_floats(tile_rows * d)))
    k = k5_tiles(d)
    fixed, stage = 2 * k.chains * k.padded_width, _hull_floats(K5_COPY * d) + k.chains * _hull_floats(K5_COPY)
    copies = -(-n // K5_COPY)
    whole = copies <= K5_MAX_COPIES and 8 * K5_MAX_COPIES + 4 * (fixed + copies * stage) <= SHARED_OPT_IN
    stages = copies if whole else K5_RING_STAGES
    return FixedPointGeometry(k.threads, k.chains, K5_PASS, K5_COPY, stages, int(whole),
                              8 * K5_MAX_COPIES + 4 * (fixed + stages * stage))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rhmc_position_fixed_point.argtypes = [ptr] * 6 + [i32, i32, i32, f32, f32, i32, i32, ptr]
    lib.rhmc_position_fixed_point.restype = i32
    lib.rhmc_momentum_fixed_point.argtypes = [ptr] * 8 + [i32, i32, i32, i32, i32, ptr]
    lib.rhmc_momentum_fixed_point.restype = i32
    lib.rhmc_fixed_point_geometry.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    lib.rhmc_fixed_point_geometry.restype = i32
    return lib


def built_launch_geometry(kernel: str, n: int, d: int) -> FixedPointGeometry:
    """The built library's own layout (builds the library: needs the toolkit)."""
    out = (ctypes.c_int * len(FixedPointGeometry._fields))()
    err = _lib().rhmc_fixed_point_geometry(int(kernel == MOMENTUM), n, d, out)
    if err != 0:
        raise RuntimeError(f"rhmc_fixed_point_geometry({kernel}, {n}, {d}) failed with CUDA error {err}")
    return FixedPointGeometry(*out)


def _float32(value: float) -> float:
    """``value`` rounded to float32, as a CUDA tensor op takes a Python scalar."""
    return float(torch.tensor(value, dtype=torch.float32))


def _inv_alpha(alpha: float) -> float:
    """1 / alpha as the model's ``eye / alpha`` scales the identity on a card: the float32 reciprocal."""
    return float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(alpha, dtype=torch.float32))


def _check(name: str, x: Tensor, batch: dict[str, tuple[Tensor, tuple[int, ...]]]) -> tuple[int, int, int]:
    """(C, N, D) of a launch, or raise: every operand a contiguous float32 tensor on x's CUDA device, of the
    shape given beside it ("C" the chains, "N" X's rows, "D" its width)."""
    if x.device.type != _KERNEL_DEVICE:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got X on {x.device}")
    if x.ndim != 2:
        raise ValueError(f"{name}: X must be (N, D), got shape {tuple(x.shape)}")
    n, d = x.shape
    if n < 1 or not kernel_width(d):
        raise ValueError(f"{name}: the CUDA kernel takes N >= 1 and 1 <= D <= 16 or D 25, got N = {n}, D = {d}")
    c = batch["dt"][0].shape[0] if batch["dt"][0].ndim == 1 else -1
    sizes = {"C": c, "N": n, "D": d}
    for label, (t, shape) in {"X": (x, ("N", "D")), **batch}.items():
        want = tuple(sizes[s] for s in shape)
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name}: {label} must be a {want} float32 tensor on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")
    return c, n, d


def _launch(name: str, symbol: str, device: torch.device, *args) -> None:
    """Launch ``symbol`` of the library with ``args`` on the current stream of ``device``, and count it."""
    fn = getattr(_lib(), symbol)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    launches.count(name, device)


# -- K4: the position fixed point -----------------------------------------------


def position_fixed_point_plain(model, w: Tensor, pm: Tensor, u0: Tensor, dt: Tensor, *, rounds: int,
                               student_t: bool = False, jitter: float = 0.0, method: str | None = None) -> Tensor:
    """The implicit position step as the sampler's loop: ``model.metric`` (+ jitter I) and
    ``ops.solve_psd(method=)`` each round.  w, pm, u0: (C, D); dt: (C,)."""
    d = w.shape[-1]
    half_dt = 0.5 * dt[:, None]
    wf = w
    for _ in range(rounds):
        g_new = model.metric(wf)
        if jitter:
            g_new = g_new + jitter * torch.eye(d, dtype=g_new.dtype, device=g_new.device)
        u_new = linalg.solve_psd(g_new, pm, method=method)
        if student_t:
            qn = torch.sum(pm * u_new, dim=-1, keepdim=True)
            u_new = (1.0 + d) * u_new / (1.0 + qn)
        wf = w + half_dt * (u0 + u_new)
    return wf


def position_fixed_point_cuda(x: Tensor, w: Tensor, pm: Tensor, u0: Tensor, dt: Tensor, *, alpha: float,
                              rounds: int, student_t: bool = False, jitter: float = 0.0) -> Tensor:
    """K4 on the card: X (N, D), w, pm, u0 (C, D), dt (C,), float32 CUDA, contiguous -> wf (C, D)."""
    c, n, d = _check(POSITION, x, {"w": (w, ("C", "D")), "pm": (pm, ("C", "D")), "u0": (u0, ("C", "D")),
                                   "dt": (dt, ("C",))})
    if rounds < 0:
        raise ValueError(f"{POSITION}: rounds must be >= 0, got {rounds}")
    out = torch.empty_like(w)
    if c > 0:
        _launch(POSITION, "rhmc_position_fixed_point", x.device, x.data_ptr(), w.data_ptr(), pm.data_ptr(),
                u0.data_ptr(), dt.data_ptr(), out.data_ptr(), c, n, d, _inv_alpha(alpha), _float32(jitter),
                rounds, int(student_t))
    return out


def position_fixed_point(model, w: Tensor, pm: Tensor, u0: Tensor, dt: Tensor, *, rounds: int,
                         student_t: bool = False, jitter: float = 0.0) -> Tensor:
    """The position fixed point of a logistic regression ``model`` (its ``X`` and ``alpha``): the plain
    version on a CPU batch, K4 on a CUDA one."""
    if w.device.type == "cpu":
        return position_fixed_point_plain(model, w, pm, u0, dt, rounds=rounds, student_t=student_t, jitter=jitter)
    return position_fixed_point_cuda(model.X, w, pm, u0, dt, alpha=model.alpha, rounds=rounds,
                                     student_t=student_t, jitter=jitter)


# -- K5: the momentum fixed point -----------------------------------------------


def momentum_fixed_point_plain(model, w: Tensor, inv: Tensor, cache, p: Tensor, pm0: Tensor, base: Tensor,
                               dt: Tensor, *, rounds: int, student_t: bool = False) -> Tensor:
    """The implicit momentum half-step as the sampler's loop (``momentum_force``): u = G^-1 pm,
    ``model.dg_bilinear(w, u, u, cache=)`` each round.  inv (C, D, D); p, pm0, base (C, D); dt (C,)."""
    half_dt = 0.5 * dt[:, None]
    pm = pm0
    for _ in range(rounds):
        u_vec = torch.einsum("...ab,...b->...a", inv, pm)
        bil = model.dg_bilinear(w, u_vec, u_vec, cache=cache)
        if student_t:
            quad = torch.sum(pm * u_vec, dim=-1, keepdim=True)
            last = 0.5 * (1.0 + w.shape[-1]) * bil / (1.0 + quad)
        else:
            last = 0.5 * bil
        pm = p + half_dt * (base + last)
    return pm


def momentum_fixed_point_cuda(x: Tensor, inv: Tensor, cache: Tensor, p: Tensor, pm0: Tensor, base: Tensor,
                              dt: Tensor, *, rounds: int, student_t: bool = False) -> Tensor:
    """K5 on the card: X (N, D), G^-1 (C, D, D), c (C, N), p, pm0, base (C, D), dt (C,), float32 CUDA,
    contiguous -> pm (C, D)."""
    c, n, d = _check(MOMENTUM, x, {"inv": (inv, ("C", "D", "D")), "cache": (cache, ("C", "N")),
                                   "p": (p, ("C", "D")), "pm0": (pm0, ("C", "D")), "base": (base, ("C", "D")),
                                   "dt": (dt, ("C",))})
    if rounds < 0:
        raise ValueError(f"{MOMENTUM}: rounds must be >= 0, got {rounds}")
    out = torch.empty_like(p)
    if c > 0:
        _launch(MOMENTUM, "rhmc_momentum_fixed_point", x.device, x.data_ptr(), inv.data_ptr(),
                cache.data_ptr(), p.data_ptr(), pm0.data_ptr(), base.data_ptr(), dt.data_ptr(), out.data_ptr(), c,
                n, d, rounds, int(student_t))
    return out


def momentum_fixed_point(model, w: Tensor, inv: Tensor, cache: Tensor, p: Tensor, pm0: Tensor, base: Tensor,
                         dt: Tensor, *, rounds: int, student_t: bool = False) -> Tensor:
    """The momentum fixed point of a logistic regression ``model`` (its ``X``; ``cache`` its dG weights at w):
    the plain version on a CPU batch, K5 on a CUDA one."""
    if p.device.type == "cpu":
        return momentum_fixed_point_plain(model, w, inv, cache, p, pm0, base, dt, rounds=rounds, student_t=student_t)
    return momentum_fixed_point_cuda(model.X, inv, cache, p, pm0, base, dt, rounds=rounds, student_t=student_t)
