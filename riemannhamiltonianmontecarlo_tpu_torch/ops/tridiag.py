"""Batched symmetric-tridiagonal linear algebra for chain-structured models.

Port of ``riemannhamiltonianmontecarlo_tpu/ops/tridiag.py``.  The
stochastic-volatility latent block has a constant tridiagonal metric
G = AR(1)-precision + I/2 (``StochVol_RMHMC.m:132-141``), so a sweep needs
one factorization (momentum sampling) and ~L tridiagonal solves ``G \\ p``.
Everything is batched over the leading (chain) axes, with T last:

* ``cholesky``: the bidiagonal factor by the sequential recurrence over T
  (the JAX package's ``lax.scan``), walked on the pivots q_t = ld_t^2 so
  that a step's dependent chain is one division and one subtraction.  On a
  CUDA tensor it is the hand-written kernel T1 (``csrc/tridiag.cu``,
  ``cholesky_cuda``): one launch, a thread a chain walking T.  On a CPU
  tensor it is the plain twin ``cholesky_plain``, a Python loop over T with
  the chains vectorized;
* ``matvec_chol``: L z (bidiagonal), one shifted multiply-add;
* ``matvec``: G x;
* ``solve``: parallel cyclic reduction (PCR), ceil(log2 T) lockstep rounds
  with zero fill for the off-diagonals and identity fill (1.0) for the
  diagonal.  On a CUDA tensor it is the hand-written kernel T2
  (``csrc/tridiag.cu``, ``solve_cuda``): one launch, a block a chain, each
  thread's rows in registers and the rounds below the block width through
  16-byte slots in shared memory, bit for bit the plain version on the card
  (past ``PCR_SHARED_MAX_T`` positions, one launch a round through device
  memory).  On a CPU tensor it is the plain twin ``solve_plain``, whose
  elementwise ops are 335 device kernels a call at T = 2000 on a card.

A CUDA tensor never falls back to a twin, nor a CPU tensor to a kernel.
The JAX package has no Pallas kernel here: its scan and PCR are compiled
loops.  ``matvec_chol`` and ``matvec`` are plain PyTorch.  The library is
built by ``ops._build`` at the first CUDA call, never at import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.ops import _build, launches

_KERNEL_DEVICE = "cuda"  # the only device type the wrappers launch on
BIDIAG, PCR = "bidiag_cholesky", "pcr_solve"  # T1's and T2's names in ops.launches
_COUNTED = (BIDIAG, PCR)

# T2's launch geometry, mirrored from csrc/tridiag.cu (chip_smoke.py holds it against the built library).
PCR_SHARED_BYTES = 232448  # kPcrSharedBytes: the shared memory an H100 block may opt into
PCR_SLOT_BYTES = 16  # kPcrSlotBytes: a position's (a, c, bb, d) as one float4
PCR_SHARED_MAX_T = PCR_SHARED_BYTES // PCR_SLOT_BYTES  # kPcrSharedMaxT
PCR_POSITIONS_A_THREAD = 8  # kPcrPositionsAThread
PCR_MAX_THREADS = 1024  # kPcrMaxThreads
PCR_GLOBAL_THREADS = 256  # kPcrGlobalThreads


class PcrGeometry(NamedTuple):
    threads: int  # a block's: a power of two
    per_thread: int  # positions a thread; 0 in the device-memory form
    shared_bytes: int  # dynamic shared memory a block: T 16-byte slots
    launches: int  # kernels a call
    workspace: int  # floats a row of the wrapper's workspace: 8 T in the device-memory form, else 0


def pcr_geometry(t: int) -> PcrGeometry:
    """T2's launch geometry at T positions, as ``csrc/tridiag.cu::pcr_geometry`` computes it: up to
    ``PCR_SHARED_MAX_T`` one launch of 2^ceil(log2 T) / 8 threads (32 to 1024) of the power of two of
    positions a thread that covers T, a 16-byte slot a position; past it ceil(log2 T) launches, a thread a
    position, through a workspace."""
    rounds = (t - 1).bit_length()
    if t > PCR_SHARED_MAX_T:
        return PcrGeometry(PCR_GLOBAL_THREADS, 0, 0, rounds, 8 * t)
    threads = min(PCR_MAX_THREADS, max(32, (1 << rounds) // PCR_POSITIONS_A_THREAD))
    return PcrGeometry(threads, max(1, (1 << rounds) // threads), PCR_SLOT_BYTES * t, 1, 0)


class TridiagChol(NamedTuple):
    """G = L L^T with L lower bidiagonal: diag ``ld``, subdiag ``e``."""

    ld: Tensor  # (..., T)
    e: Tensor  # (..., T-1)


def launch_counts() -> dict[str, int]:
    """Launches of T1 and T2 since the last reset (``ops.launches``)."""
    return launches.counts(_COUNTED)


def reset_launch_counts() -> None:
    launches.reset(_COUNTED)


def cholesky_plain(diag: Tensor, off: Tensor) -> TridiagChol:
    """Bidiagonal Cholesky of symmetric tridiagonal (diag, off), the plain twin of T1.

    diag: (..., T), off: (..., T-1).  On the pivots q_t = ld_t^2: q_0 = d_0;
    for t >= 1 q_t = d_t - off_{t-1} off_{t-1} / q_{t-1}, NaN where q_{t-1}
    is not positive (so a chain is NaN from its first non-positive pivot
    on); ld_t = sqrt(q_t), e_t = off_{t-1} / ld_{t-1}.  Seven launches a
    position, T1's operations in its order.
    """
    t = diag.shape[-1]
    q = diag[..., 0]
    ld = [torch.sqrt(q)]
    e = []
    for i in range(1, t):
        o = off[..., i - 1]
        q_next = diag[..., i] - o * o / q
        e.append(o / ld[-1])
        q = torch.where(q > 0, q_next, torch.nan)
        ld.append(torch.sqrt(q))
    e_out = torch.stack(e, dim=-1) if e else off.new_empty(off.shape)
    return TridiagChol(torch.stack(ld, dim=-1), e_out)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rhmc_bidiag_cholesky.argtypes = [ptr, ptr, i64, i64, ptr, ptr, i32, i32, ptr]
    lib.rhmc_bidiag_cholesky.restype = i32
    lib.rhmc_pcr_solve.argtypes = [ptr, ptr, i64, i64, ptr, ptr, ptr, i32, i32, ptr]
    lib.rhmc_pcr_solve.restype = i32
    lib.rhmc_pcr_geometry.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.rhmc_pcr_geometry.restype = i32
    return lib


def built_pcr_geometry(t: int) -> PcrGeometry:
    """T2's launch geometry at T as the built library computes it (builds it; needs nvcc, not a card)."""
    out = (ctypes.c_int * 5)()
    err = _lib().rhmc_pcr_geometry(t, out)
    if err != 0:
        raise ValueError(f"rhmc_pcr_geometry({t}) failed with CUDA error {err}")
    return PcrGeometry(*out)


def _check(diag: Tensor, off: Tensor, *rest: Tensor) -> None:
    """The kernels' operands: CUDA float32 on one device, diag (..., T) with T >= 1, off (..., T-1) and
    each of ``rest`` (T2's b) shaped as diag."""
    tensors = (diag, off, *rest)
    if diag.device.type != _KERNEL_DEVICE or any(x.device != diag.device for x in tensors):
        raise ValueError("the CUDA kernel needs CUDA tensors on one device, got "
                         + ", ".join(str(x.device) for x in tensors))
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("the CUDA kernel takes float32, got " + ", ".join(str(x.dtype) for x in tensors))
    if diag.ndim < 1 or diag.shape[-1] < 1:
        raise ValueError(f"expected diag of shape (..., T) with T >= 1, got {tuple(diag.shape)}")
    want = diag.shape[:-1] + (diag.shape[-1] - 1,)
    if off.shape != want:
        raise ValueError(f"off must have shape {tuple(want)} for diag {tuple(diag.shape)}, got {tuple(off.shape)}")
    for x in rest:
        if x.shape != diag.shape:
            raise ValueError(f"b must have diag's shape {tuple(diag.shape)}, got {tuple(x.shape)}")


def _rows(diag: Tensor, off: Tensor) -> tuple[int, int, Tensor, Tensor]:
    """(B, T, diag as contiguous (B, T) rows, off as (B, T-1) rows): off is a view wherever its strides
    allow one (StochVol's expanded off is), read by the kernels through its strides, never copied for them."""
    t = diag.shape[-1]
    b = diag.numel() // t
    return b, t, diag.reshape(b, t).contiguous(), off.reshape(b, t - 1)


def _call(name: str, fn, count: int, device: torch.device, *args) -> None:
    """Call the library's ``fn`` on the current stream, raise on its CUDA error, and count ``count``
    launches of kernel ``name``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    for _ in range(count):
        launches.count(name, device)


def _launch(tensors: tuple[Tensor, ...], b: int, t: int) -> None:
    """Launch T1 on (diag, off, ld, e) of ``b`` chains and length ``t``, and count it.  off is read through
    its strides; the others are contiguous."""
    diag, off, ld, e = tensors
    for x in (diag, ld, e):
        if not x.is_contiguous():  # the kernel's index arithmetic assumes it
            raise ValueError("bidiag_cholesky: kernel operand is not contiguous")
    _call(BIDIAG, _lib().rhmc_bidiag_cholesky, 1, diag.device, diag.data_ptr(), off.data_ptr(), off.stride(0),
          off.stride(1), ld.data_ptr(), e.data_ptr(), b, t)


def cholesky_cuda(diag: Tensor, off: Tensor) -> TridiagChol:
    """T1 on the card: diag (..., T), off (..., T-1) float32 CUDA -> (ld, e), contiguous, shaped as diag
    and off.  StochVol's expanded off is read through its strides, not copied."""
    _check(diag, off)
    b, t, d2, o2 = _rows(diag, off)
    ld, e = torch.empty_like(d2), d2.new_empty((b, t - 1))
    if b > 0:
        _launch((d2, o2, ld, e), b, t)
    return TridiagChol(ld.view(diag.shape), e.view(off.shape))


def cholesky(diag: Tensor, off: Tensor) -> TridiagChol:
    """Bidiagonal Cholesky of symmetric tridiagonal (diag, off): the twin on
    CPU tensors, T1 on CUDA ones."""
    if diag.device.type == "cpu":
        return cholesky_plain(diag, off)
    return cholesky_cuda(diag, off)


def logdet_from_chol(chol: TridiagChol) -> Tensor:
    return 2.0 * torch.sum(torch.log(chol.ld), dim=-1)


def matvec_chol(chol: TridiagChol, z: Tensor) -> Tensor:
    """(L z)_t = ld_t z_t + e_{t-1} z_{t-1} -- samples N(0, G) from iid z."""
    return chol.ld * z + F.pad(chol.e * z[..., :-1], (1, 0))


def matvec(diag: Tensor, off: Tensor, x: Tensor) -> Tensor:
    """Symmetric tridiagonal matvec (G x)."""
    lower = F.pad(off * x[..., :-1], (1, 0))
    upper = F.pad(off * x[..., 1:], (0, 1))
    return diag * x + lower + upper


def _from_before(x: Tensor, s: int, fill: float = 0.0) -> Tensor:
    """x_{i-s}, positions i < s filled with ``fill``."""
    return F.pad(x[..., :-s], (s, 0), value=fill)


def _from_after(x: Tensor, s: int, fill: float = 0.0) -> Tensor:
    """x_{i+s}, positions i >= T - s filled with ``fill``."""
    return F.pad(x[..., s:], (0, s), value=fill)


def solve_plain(diag: Tensor, off: Tensor, b: Tensor) -> Tensor:
    """Solve G x = b for symmetric tridiagonal G by parallel cyclic reduction, the plain twin of T2.

    diag: (..., T), off: (..., T-1), b: (..., T).  ceil(log2 T) lockstep
    rounds; out-of-range neighbours are identity rows.  The arithmetic is
    the JAX package's, in the same order.
    """
    t = diag.shape[-1]
    a = F.pad(off, (1, 0))  # a_i = G[i, i-1]
    c = F.pad(off, (0, 1))  # c_i = G[i, i+1]
    bb = diag
    d = b
    s = 1
    while s < t:
        alpha = -a / _from_before(bb, s, 1.0)
        gamma = -c / _from_after(bb, s, 1.0)
        bb = bb + alpha * _from_before(c, s) + gamma * _from_after(a, s)
        d = d + alpha * _from_before(d, s) + gamma * _from_after(d, s)
        a = alpha * _from_before(a, s)
        c = gamma * _from_after(c, s)
        s *= 2
    return d / bb


def _launch_solve(diag: Tensor, off: Tensor, b: Tensor, x: Tensor, workspace: Tensor | None, rows: int,
                  t: int) -> None:
    """Launch T2 on (B, T) rows: diag, b, x contiguous, off through its strides, ``workspace`` of
    ``pcr_geometry(t).workspace`` floats a row past the shared-memory form; count each launch."""
    for v in (diag, b, x):
        if not v.is_contiguous():  # the kernel's index arithmetic assumes it
            raise ValueError("pcr_solve: kernel operand is not contiguous")
    geometry = pcr_geometry(t)
    if geometry.workspace and (workspace is None or workspace.numel() < rows * geometry.workspace):
        raise ValueError(f"pcr_solve: T = {t} needs a workspace of {rows * geometry.workspace} floats")
    _call(PCR, _lib().rhmc_pcr_solve, geometry.launches, diag.device, diag.data_ptr(), off.data_ptr(),
          off.stride(0), off.stride(1), b.data_ptr(), x.data_ptr(),
          None if workspace is None else workspace.data_ptr(), rows, t)


def solve_cuda(diag: Tensor, off: Tensor, b: Tensor) -> Tensor:
    """T2 on the card: x = G^-1 b for diag (..., T), off (..., T-1), b (..., T) float32 CUDA; x contiguous,
    shaped as b.  off is read through its strides (StochVol's expanded view is not copied); a
    non-contiguous diag or b is copied once.  Capturable: no host sync, and the outputs (and past
    ``PCR_SHARED_MAX_T`` the workspace) come from the caching allocator."""
    _check(diag, off, b)
    rows, t, d2, o2 = _rows(diag, off)
    b2 = b.reshape(rows, t).contiguous()
    x = torch.empty_like(d2)
    if rows > 0:
        geometry = pcr_geometry(t)
        workspace = d2.new_empty(rows * geometry.workspace) if geometry.workspace else None
        _launch_solve(d2, o2, b2, x, workspace, rows, t)
    return x.view(b.shape)


def solve(diag: Tensor, off: Tensor, b: Tensor) -> Tensor:
    """Solve G x = b for symmetric tridiagonal G by parallel cyclic reduction: the twin on CPU tensors,
    T2 on CUDA ones."""
    if diag.device.type == "cpu":
        return solve_plain(diag, off, b)
    return solve_cuda(diag, off, b)
