"""Hand-written Hopper kernel for the FitzHugh-Nagumo sensitivity system.

The JAX package's ``models/fhn.py`` integrates the FitzHugh-Nagumo ODE with
a fixed-step RK4 ``lax.scan`` (``:55-85``) and takes every derivative by
autodiff through it: ``jax.grad`` for the gradient (``:149-156``),
``jacfwd`` for the sensitivities of the metric (``:129-134``) and
``jacfwd`` of that for dG (``:169-182``).  It has no Pallas kernel.  Here one
CUDA kernel (``csrc/fhn_sens.cu``) integrates the augmented system instead:
the state y = (V, R), its first sensitivities S = dy/dtheta (2 x 3) and its
second sensitivities T = d2y/dtheta2 (2 x 6, symmetric in the two theta
indices), each stage's right-hand side differentiated by hand.  An explicit
Runge-Kutta step applied to the augmented system is the exact derivative of
the step applied to the state, so the result is ``jacfwd`` through the
integrator up to rounding.  A chain is a group of lanes of one warp (1, 4 or
8 by order: ``launch_geometry``); each lane integrates y and its share of S
and T, and ``lane_outputs`` says which lane writes which output entry.  The
sums over the observation times run inside the integration, so one launch
returns, for every chain,

* order 0: ``logp``;
* order 1: ``logp``, ``grad`` and the metric ``G``;
* order 2: the same and ``dG`` (``[k] = dG/dtheta_k``, the layout of
  ``models.base._AutodiffManifold.dg_cache``).

Three functions, as in ``ops/hopper_linalg.py``: ``fhn_sensitivities_cuda``
is the kernel's wrapper (checks, ``torch.empty`` outputs, the launch on the
current stream, a launch count by order, and an error on anything else, a
CPU tensor included); ``fhn_sensitivities_plain`` is the plain-PyTorch twin,
the same augmented RK4 with the chain axis batched and a Python loop over
the steps (no autograd, so it runs under ``torch.inference_mode()`` as it
is); ``fhn_sensitivities`` runs the twin for a CPU tensor and the kernel for
a CUDA one, never one in place of the other.

The library is built by ``ops._build`` at the first CUDA call, never at
import, so this module imports on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.ops import _build, launches

ORDERS = (0, 1, 2)
DIM = 3  # (a, b, c)
STAGED_MAX_OBS = 6144  # csrc/fhn_sens.cu::kStagedMaxObs: to here the data is staged in shared memory, then streamed
INIT = (-1.0, 1.0)  # (V, R) at t0, RunFHN_RMHMC.m
T0, T1 = 0.0, 20.0
_KERNEL_DEVICE = "cuda"

# (i, j), i <= j: the six second sensitivities of a species, in storage order.
PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
# PAIR_OF[i][j]: the storage slot of (i, j) for any order of i and j.
PAIR_OF = ((0, 1, 2), (1, 3, 4), (2, 4, 5))

def _counted(order: int) -> str:
    """The kernel's name in ``ops.launches`` at ``order``."""
    return f"fhn_sensitivities/{order}"


def launch_counts() -> dict[int, int]:
    """Launches of the kernel by order since the last reset (``ops.launches``)."""
    counts = launches.counts(tuple(_counted(order) for order in ORDERS))
    return {order: counts[_counted(order)] for order in ORDERS}


def reset_launch_counts() -> None:
    launches.reset(tuple(_counted(order) for order in ORDERS))


class FHNSensitivities(NamedTuple):
    """What one call returns for C chains; the fields past the order are None."""

    logp: Tensor  # (C,)
    grad: Tensor | None  # (C, 3), order >= 1
    metric: Tensor | None  # (C, 3, 3), order >= 1
    dmetric: Tensor | None  # (C, 3, 3, 3), order 2: [k] = dG / dtheta_k


def step_size(num_obs: int, substeps: int, t0: float = T0, t1: float = T1) -> float:
    """The RK4 step h, in float64 as the JAX model computes it (``fhn.py:67-68``)."""
    return (t1 - t0) / (num_obs - 1) / substeps


# Floating-point operations of the kernel a chain, read from csrc/fhn_sens.cu
# with each +, -, *, / of the source counted once (a multiply-add as two):
# (per RK4 step, per observation time) by order.  A step is four right-hand
# sides (10, 40, 145 operations) and seven state updates of 2 n (n = 2, 8, 20).
_OPS_PER_STEP = {0: 68, 1: 272, 2: 860}
_OPS_PER_OBS = {0: 6, 1: 42, 2: 186}


def operations(order: int, num_chains: int, num_obs: int, substeps: int) -> int:
    """The kernel's floating-point operations for one call (its bound's numerator)."""
    _check_order(order)
    steps = (num_obs - 1) * substeps
    return num_chains * (steps * _OPS_PER_STEP[order] + num_obs * _OPS_PER_OBS[order])


# The longest chain of dependent operations in csrc/fhn_sens.cu as nvcc
# contracts it, the same at every order (y does not depend on S or T, and
# their own chains are shorter).  A step: at each of the four stages V -> V*V
# -> *V -> FMA with -1/3 -> +R -> *c (k.v), then the stage's FMA into the next
# stage's V (the fourth stage's into the RK4 sum instead), then y += h/6 sum:
# 4 x 5 + 3 + 2 = 25.  An observation: e = data - V, then two FMAs into the
# sum of squares: 3; every observation but the last overlaps the steps after it.
# It is this source's chain, not the function's: the same RK4 step with the
# cubic c (V - V^3/3 + R) written as FMAs has a shorter one (17 with three
# FMAs a stage, fewer by evaluating the cubic as two halves in parallel).
_CHAIN_PER_STEP = 25
_CHAIN_PER_OBS = 3


# Hopper's latency of a float32 add, multiply or FMA: cycles from its issue
# to the issue of an operation that reads its result.
FP32_DEPENDENT_CYCLES = 4


def dependent_operations(num_obs: int, substeps: int) -> int:
    """Length of a chain's longest sequence of dependent operations in one call."""
    return (num_obs - 1) * substeps * _CHAIN_PER_STEP + _CHAIN_PER_OBS


def critical_path_us(num_obs: int, substeps: int, sm_clock_mhz: float) -> float:
    """The source's critical path: ``dependent_operations`` one after another
    at the card's latency and the given SM clock.  No spread of this source
    over lanes or SMs takes less, at any order and chain count; a shorter
    chain of arithmetic for the same function would (see ``_CHAIN_PER_STEP``)."""
    return dependent_operations(num_obs, substeps) * FP32_DEPENDENT_CYCLES / sm_clock_mhz


# -- the launch geometry and which lane writes what, mirrored from csrc/fhn_sens.cu --

THREADS_PER_BLOCK = 32  # a block is one warp
LANES_PER_CHAIN = {0: 1, 1: 4, 2: 8}  # a power of two, so a chain's lanes are a fixed slice of a warp
WORKING_LANES = {0: 1, 1: DIM, 2: len(PAIRS)}  # order 1: a column of S each; order 2: a pair of T each


class LaunchGeometry(NamedTuple):
    """How the kernel lays C chains out on the card (csrc: ``geometry``)."""

    lanes_per_chain: int
    chains_per_block: int
    threads_per_block: int
    blocks: int
    shared_bytes: int  # the block's copy of the (num_obs, 2) float32 data to STAGED_MAX_OBS, then none


def launch_geometry(order: int, num_chains: int, num_obs: int) -> LaunchGeometry:
    """The source's launch geometry for one call, mirrored in Python.

    ``rhmc_fhn_launch_geometry`` of the built library gives the source's own
    answer; ``chip_smoke.py`` holds the two against each other on the card.
    """
    _check_order(order)
    if num_chains < 1 or num_obs < 2:
        raise ValueError(f"need num_chains >= 1 and num_obs >= 2, got {num_chains}, {num_obs}")
    lanes = LANES_PER_CHAIN[order]
    chains = THREADS_PER_BLOCK // lanes
    shared = 4 * 2 * num_obs if num_obs <= STAGED_MAX_OBS else 0
    return LaunchGeometry(lanes, chains, THREADS_PER_BLOCK, -(-num_chains // chains), shared)


# A chain's output entries, flattened in the order the C mirror numbers them.
ENTRIES = (("logp",), *(("grad", i) for i in range(DIM)),
           *(("G", i, j) for i in range(DIM) for j in range(DIM)),
           *(("dG", k, i, j) for k in range(DIM) for i in range(DIM) for j in range(DIM)))


def lane_outputs(order: int) -> tuple[tuple[int, ...], ...]:
    """The entries of ``ENTRIES`` that each lane of a chain's group writes.

    Order 1: lane j integrates S_j and writes grad[j], G[j][j] and G[j][j+1
    mod 3] both ways.  Order 2: lane p integrates the pair (i, j) = PAIRS[p]
    of T (and S_i, S_j) and writes G and every dG[k] at (i, j) and (j, i),
    and grad[i] where i == j.  Lane 0 writes logp; spare lanes write nothing.
    """
    _check_order(order)
    entry = {name: e for e, name in enumerate(ENTRIES)}
    lanes = [[] for _ in range(LANES_PER_CHAIN[order])]
    lanes[0].append(entry[("logp",)])
    if order == 1:
        for j in range(DIM):
            n = (j + 1) % DIM
            lanes[j] += [entry[("grad", j)], entry[("G", j, j)], entry[("G", j, n)], entry[("G", n, j)]]
    elif order == 2:
        for p, (i, j) in enumerate(PAIRS):
            if i == j:
                lanes[p].append(entry[("grad", i)])
            lanes[p] += sorted({entry[("G", i, j)], entry[("G", j, i)]})
            lanes[p] += sorted({entry[("dG", k, x, y)] for k in range(DIM) for x, y in ((i, j), (j, i))})
    return tuple(map(tuple, lanes))


def output_owners(order: int) -> tuple[int, ...]:
    """``lane_outputs`` by entry: the lane that writes each entry, -1 past the order."""
    owners = [-1] * len(ENTRIES)
    for lane, entries in enumerate(lane_outputs(order)):
        for e in entries:
            if owners[e] != -1:
                raise RuntimeError(f"order {order}: lanes {owners[e]} and {lane} both write {ENTRIES[e]}")
            owners[e] = lane
    return tuple(owners)


def _check_order(order: int) -> None:
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")


# -- the twin ------------------------------------------------------------------

# Columns of the twin's packed augmented state (C, n), n = 2, 8, 20 by order:
# V, R | dV/dtheta_j, dR/dtheta_j | d2V, d2R in PAIRS order.
_WIDTH = {0: 2, 1: 8, 2: 20}
_I, _J = [p[0] for p in PAIRS], [p[1] for p in PAIRS]
# The kernel multiplies by float(1/3) and by 1/c where the JAX model divides
# (csrc/fhn_sens.cu: a division leaves its fast path on a NaN operand); so does the twin.
_THIRD = 1.0 / 3.0


def _rhs(order: int, th: tuple, y: Tensor) -> Tensor:
    """Right-hand side of the augmented system: (C, n) -> (C, n).

    ``th``: the per-chain constants a, b, c, 1/c, 1/c^2, 1/c^3, b/c as (C, 1).
    """
    a, b, c, inv_c, inv_c2, inv_c3, b_c = th
    v, r = y[:, 0:1], y[:, 1:2]
    v2 = v * v
    cubic = v - v * v * v * _THIRD + r  # dV/dt = c (V - V^3/3 + R)
    lin = v - a + b * r  # dR/dt = -(V - a + b R) / c
    parts = [c * cubic, -lin * inv_c]
    if order >= 1:
        # df/dy = [[c (1 - V^2), c], [-1/c, -b/c]]; df/dtheta = [[0, 0, cubic], [1/c, -R/c, lin/c^2]]
        sv, sr = y[:, 2:5], y[:, 5:8]
        jvv = c * (1.0 - v2)
        zero = torch.zeros_like(v)
        parts += [jvv * sv + c * sr + torch.cat([zero, zero, cubic], 1),
                  -inv_c * sv - b_c * sr + torch.cat([inv_c, -r * inv_c, lin * inv_c2], 1)]
    if order == 2:
        tv, tr = y[:, 8:14], y[:, 14:20]
        zero3 = torch.zeros_like(sv)
        # mix[i][j] = d2f/(dy dtheta_i) . S_j; a pair (i, j) takes mix[i][j] + mix[j][i].
        # V: only theta_c, (1 - V^2) SV_j + SR_j.  R: 0, -SR_j / c, (SV_j + b SR_j) / c^2.
        mix_v = torch.stack([zero3, zero3, (1.0 - v2) * sv + sr], 1)
        mix_r = torch.stack([zero3, -sr * inv_c, (sv + b * sr) * inv_c2], 1)
        # d2f_V/dV2 = -2 c V; d2f_R/dtheta2: (a, c) -1/c^2, (b, c) R/c^2, (c, c) -2 lin/c^3.
        hess_r = torch.cat([zero, zero, -inv_c2, zero, r * inv_c2, -2.0 * lin * inv_c3], 1)
        parts += [jvv * tv + c * tr + (-2.0 * c * v) * sv[:, _I] * sv[:, _J] + (mix_v[:, _I, _J] + mix_v[:, _J, _I]),
                  -inv_c * tv - b_c * tr + (mix_r[:, _I, _J] + mix_r[:, _J, _I]) + hess_r]
    return torch.cat(parts, 1)


def fhn_sensitivities_plain(theta: Tensor, data: Tensor, order: int, *, substeps: int, noise_sd: float,
                            gamma_scale: float) -> FHNSensitivities:
    """The kernel's twin: the augmented RK4 and the sums over time, batched over C."""
    _check_order(order)
    num_obs = data.shape[0]
    h = step_size(num_obs, substeps)
    var = noise_sd**2
    a, b, c = theta[:, 0:1], theta[:, 1:2], theta[:, 2:3]
    inv_c = 1.0 / c
    inv_c2 = inv_c * inv_c
    th = (a, b, c, inv_c, inv_c2, inv_c2 * inv_c, b * inv_c)
    cn = theta.shape[0]
    kw = dict(dtype=theta.dtype, device=theta.device)
    y = torch.zeros((cn, _WIDTH[order]), **kw)
    y[:, 0], y[:, 1] = INIT
    data = data.to(theta.dtype)
    pair_of = torch.tensor(PAIR_OF, device=theta.device)

    sq = torch.zeros((cn,), **kw)
    finite = torch.ones((cn,), dtype=torch.bool, device=theta.device)
    grad_sum = torch.zeros((cn, DIM), **kw)
    g_sum = torch.zeros((cn, DIM, DIM), **kw)
    dg_sum = torch.zeros((cn, DIM, DIM, DIM), **kw)

    def observe(y, t):
        nonlocal sq, finite, grad_sum, g_sum, dg_sum
        e = data[t] - y[:, :2]  # data - y, (C, 2)
        sq = sq + (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1])
        finite = finite & torch.isfinite(y[:, :2]).all(1)
        if order >= 1:
            s = y[:, 2:8].reshape(cn, 2, DIM)  # [species, j]
            grad_sum = grad_sum + (e[:, 0:1] * s[:, 0] + e[:, 1:2] * s[:, 1])
            g_sum = g_sum + (s[:, :, :, None] * s[:, :, None, :]).sum(1)
        if order == 2:
            t2 = y[:, 8:20].reshape(cn, 2, len(PAIRS))[:, :, pair_of]  # [species, i, k], symmetric
            # [k, i, j] = T_ik S_j + S_i T_jk, summed over the species
            dg_sum = dg_sum + (t2.transpose(2, 3)[:, :, :, :, None] * s[:, :, None, None, :]
                               + s[:, :, None, :, None] * t2.transpose(2, 3)[:, :, :, None, :]).sum(1)

    observe(y, 0)
    half, sixth = 0.5 * h, h / 6.0
    for t in range(1, num_obs):
        for _ in range(substeps):
            k1 = _rhs(order, th, y)
            k2 = _rhs(order, th, y + half * k1)
            k3 = _rhs(order, th, y + half * k2)
            k4 = _rhs(order, th, y + h * k3)
            y = y + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        observe(y, t)

    valid = (theta > 0.0).all(-1) & finite
    logp = torch.where(valid, -0.5 * sq / var - theta.sum(-1) / gamma_scale, -torch.inf)
    if order == 0:
        return FHNSensitivities(logp, None, None, None)
    grad = grad_sum / var - 1.0 / gamma_scale
    grad = torch.where(valid[:, None] & torch.isfinite(grad), grad, 0.0)
    metric = g_sum / var + torch.diag_embed(2.0 / (theta * theta))
    if order == 1:
        return FHNSensitivities(logp, grad, metric, None)
    eye = torch.eye(DIM, dtype=torch.bool, device=theta.device)
    diag3 = eye[:, :, None] & eye[:, None, :]  # [k, i, j]: k == i == j
    corner = torch.where(diag3, (-4.0 / (theta * theta * theta))[:, :, None, None], 0.0)
    return FHNSensitivities(logp, grad, metric, dg_sum / var + corner)


# -- the kernel ------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    ptr, i32, f32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    lib.rhmc_fhn_sensitivities.argtypes = [i32, ptr, ptr, i32, i32, i32, f64, f32, f32, f32, f32,
                                           ptr, ptr, ptr, ptr, ptr]
    lib.rhmc_fhn_sensitivities.restype = i32
    lib.rhmc_fhn_launch_geometry.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    lib.rhmc_fhn_launch_geometry.restype = i32
    lib.rhmc_fhn_output_owners.argtypes = [i32, ctypes.POINTER(i32)]
    lib.rhmc_fhn_output_owners.restype = i32
    return lib


def built_launch_geometry(order: int, num_chains: int, num_obs: int) -> LaunchGeometry:
    """The built library's own geometry (builds the library: needs the toolkit)."""
    out = (ctypes.c_int * len(LaunchGeometry._fields))()
    err = _lib().rhmc_fhn_launch_geometry(order, num_chains, num_obs, out)
    if err != 0:
        raise RuntimeError(f"rhmc_fhn_launch_geometry({order}, {num_chains}, {num_obs}) failed with CUDA error {err}")
    return LaunchGeometry(*out)


def built_output_owners(order: int) -> tuple[int, ...]:
    """The built library's own ``output_owners`` (builds the library: needs the toolkit)."""
    out = (ctypes.c_int * len(ENTRIES))()
    err = _lib().rhmc_fhn_output_owners(order, out)
    if err != 0:
        raise RuntimeError(f"rhmc_fhn_output_owners({order}) failed with CUDA error {err}")
    return tuple(out)


def _check(theta: Tensor, data: Tensor, order: int, substeps: int) -> None:
    _check_order(order)
    for name, t in (("theta", theta), ("data", data)):
        if t.device.type != _KERNEL_DEVICE:
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32, got {name} as {t.dtype}")
    if data.device != theta.device:
        raise ValueError(f"theta on {theta.device} and data on {data.device}")
    if theta.ndim != 2 or theta.shape[1] != DIM:
        raise ValueError(f"expected theta of shape (C, {DIM}), got {tuple(theta.shape)}")
    if data.ndim != 2 or data.shape[1] != 2 or data.shape[0] < 2:
        raise ValueError(f"expected data of shape (num_obs, 2) with num_obs >= 2, got {tuple(data.shape)}")
    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")


def fhn_sensitivities_cuda(theta: Tensor, data: Tensor, order: int, *, substeps: int, noise_sd: float,
                           gamma_scale: float) -> FHNSensitivities:
    """The kernel on the card: (C, 3), (num_obs, 2) float32 CUDA -> the order's outputs."""
    _check(theta, data, order, substeps)
    theta, data = theta.contiguous(), data.contiguous()  # themselves unless the caller's are strided
    c, num_obs = theta.shape[0], data.shape[0]
    kw = dict(dtype=torch.float32, device=theta.device)
    logp = torch.empty((c,), **kw)
    grad = torch.empty((c, DIM), **kw) if order >= 1 else None
    metric = torch.empty((c, DIM, DIM), **kw) if order >= 1 else None
    dmetric = torch.empty((c, DIM, DIM, DIM), **kw) if order == 2 else None
    if c > 0:
        ptrs = [t.data_ptr() if t is not None else None for t in (logp, grad, metric, dmetric)]
        with torch.cuda.device(theta.device):
            stream = torch.cuda.current_stream(theta.device).cuda_stream
            err = _lib().rhmc_fhn_sensitivities(
                order, theta.data_ptr(), data.data_ptr(), c, num_obs, substeps,
                step_size(num_obs, substeps), noise_sd**2, gamma_scale, *INIT, *ptrs, stream)
        if err != 0:
            raise RuntimeError(f"fhn_sensitivities kernel launch failed with CUDA error {err}")
        launches.count(_counted(order), theta.device)
    return FHNSensitivities(logp, grad, metric, dmetric)


def fhn_sensitivities(theta: Tensor, data: Tensor, order: int, **constants) -> FHNSensitivities:
    """The order's outputs for a (C, 3) batch: the twin on CPU, the kernel on CUDA."""
    if theta.device.type == "cpu":
        return fhn_sensitivities_plain(theta, data, order, **constants)
    return fhn_sensitivities_cuda(theta, data, order, **constants)
