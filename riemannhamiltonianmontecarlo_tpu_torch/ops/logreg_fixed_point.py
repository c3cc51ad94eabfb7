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

* K4 ``position_fixed_point_cuda``: each round builds G = X^T diag(v) X +
  I / alpha (+ jitter I) from the data staged in shared memory, a block of
  G a lane (``k4_build``), factors it and solves (K2's code), for every
  chain at once; no (C, N) intermediate and no G reaches device memory;
* K5 ``momentum_fixed_point_cuda``: each round's u, X u and X^T (c (Xu)^2),
  c read once a launch.

Each ``*_cuda`` checks its operands (a CUDA device shared by all, float32,
shapes, contiguity, 1 <= D <= 48), allocates its output with
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
THREADS_PER_BLOCK = 256  # kFpThreads
SHARED_BUDGET = 112 * 1024  # kSharedBudget: X staged whole where it fits (so that an SM holds two blocks)
SHARED_OPT_IN = 227 * 1024  # the shared memory an H100 block may opt into
STREAM_BYTES = 64 * 1024  # kStreamBytes: X's tile when the whole of it does not fit


def launch_counts() -> dict[str, int]:
    """Launches of K4 and K5 since the last reset (``ops.launches``)."""
    return launches.counts(_COUNTED)


def reset_launch_counts() -> None:
    launches.reset(_COUNTED)


class FixedPointGeometry(NamedTuple):
    """How K4 / K5 lay (N, D) out on the card (csrc: ``FpLayout``)."""

    lanes_per_chain: int  # K1 / K2's groups: 4, 8, 16 or 32 by the width's rows
    chains_per_block: int
    x_stride: int  # floats between X's rows in shared memory: a multiple of 4, an odd number of 16-byte slots
    x_rows: int  # rows of X a tile holds (N where X is staged whole)
    x_whole: int  # 1 where X is staged once a launch
    c_staged: int  # K5: 1 where the block's rows of c sit in shared memory
    shared_bytes: int  # the block's


class K4Build(NamedTuple):
    """How K4's lanes split a chain's G (csrc: ``Build``): lane (ti, tk) of the group sums the block of rows
    ti ri .. ti ri + ri - 1 and columns tk rk .. tk rk + rk - 1, on a grid of block_rows x block_cols blocks
    over ``cols`` (X's padded width)."""

    block_rows: int
    block_cols: int
    ri: int
    rk: int
    cols: int
    chunk: int  # rows of X a group weighs at a time (csrc: kCH)
    buffer_floats: int  # the block's weighted rows: each group's chunk x the stride, and a bank skew


def _unrolled_rows(d: int) -> int:
    """The rows the kernels are unrolled for (csrc: with_width): d itself, or the next capacity."""
    return d if d in hopper_linalg.EXACT_WIDTHS else next(cap for cap in hopper_linalg.CAPACITIES if d <= cap)


def k4_build(d: int) -> K4Build:
    """K4's blocks of G at width ``d``, mirrored from the source."""
    n, lanes = _unrolled_rows(d), hopper_linalg.launch_geometry(d).lanes_per_chain
    ti = 2 if lanes <= 8 else 4
    tk = lanes // ti
    ri, rk = (-(-n // ti) + 1) // 2 * 2, (-(-n // tk) + 1) // 2 * 2
    cols, chunk = max(ti * ri, tk * rk), min(lanes, 16)
    groups = THREADS_PER_BLOCK // lanes
    return K4Build(ti, tk, ri, rk, cols, chunk, groups * (chunk * _stride(cols) + ti * ri))


def _stride(cols: int) -> int:
    """Floats between rows of X (and of K4's weighted rows) in shared memory: an odd number of 16-byte slots."""
    return ((cols + 3) // 4 | 1) * 4


def launch_geometry(kernel: str, n: int, d: int) -> FixedPointGeometry:
    """K4's (``kernel`` = ``POSITION``) or K5's (``MOMENTUM``) layout at N rows of width D, as
    ``csrc/logreg_fixed_point.cu::fp_layout`` computes it: X's rows padded (K4: to its blocks' width), whole
    in shared memory where X fits the budget beside K4's factor tile (C D (D | 1) floats) and weighted rows,
    else in tiles of 64 KB; K5's rows of c beside a whole X where both fit."""
    if kernel not in _COUNTED:
        raise ValueError(f"kernel must be one of {_COUNTED}, got {kernel!r}")
    if n < 1 or not 1 <= d <= MAX_DIM:
        raise ValueError(f"the CUDA kernels take N >= 1 and 1 <= D <= {MAX_DIM}, got N = {n}, D = {d}")
    geo = hopper_linalg.launch_geometry(d)
    chains = THREADS_PER_BLOCK // geo.lanes_per_chain
    stride = _stride(_unrolled_rows(d) if kernel == MOMENTUM else k4_build(d).cols)
    tile = 0 if kernel == MOMENTUM else 4 * (chains * d * (d | 1) + k4_build(d).buffer_floats)
    whole = 4 * n * stride + tile <= SHARED_BUDGET
    x_rows = n if whole else STREAM_BYTES // (4 * stride)
    c_bytes = 4 * chains * n
    c_staged = kernel == MOMENTUM and whole and 4 * x_rows * stride + c_bytes <= SHARED_BUDGET
    return FixedPointGeometry(geo.lanes_per_chain, chains, stride, x_rows, int(whole), int(c_staged),
                              4 * x_rows * stride + tile + (c_bytes if c_staged else 0))


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
    if n < 1 or not 1 <= d <= MAX_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes N >= 1 and 1 <= D <= {MAX_DIM}, got N = {n}, D = {d}")
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
