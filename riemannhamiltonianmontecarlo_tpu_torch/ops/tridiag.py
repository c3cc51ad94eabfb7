"""Batched symmetric-tridiagonal linear algebra for chain-structured models.

Port of ``riemannhamiltonianmontecarlo_tpu/ops/tridiag.py``.  The
stochastic-volatility latent block has a constant tridiagonal metric
G = AR(1)-precision + I/2 (``StochVol_RMHMC.m:132-141``), so a sweep needs
one factorization (momentum sampling) and ~L tridiagonal solves ``G \\ p``.
Everything is batched over the leading (chain) axes, with T last:

* ``cholesky``: the bidiagonal factor by the sequential recurrence over T
  (the JAX package's ``lax.scan``).  On a CUDA tensor it is the hand-written
  kernel T1 (``csrc/tridiag.cu``, ``cholesky_cuda``): one launch, a thread a
  chain walking T.  On a CPU tensor it is the plain twin ``cholesky_plain``,
  a Python loop of three launches per position with the chains vectorized;
  never a fallback from one to the other;
* ``matvec_chol``: L z (bidiagonal), one shifted multiply-add;
* ``matvec``: G x;
* ``solve``: parallel cyclic reduction (PCR), ceil(log2 T) lockstep rounds
  of elementwise work; shifts are pad-and-slice, with zero fill for the
  off-diagonals and identity fill (1.0) for the diagonal.

The JAX package has no Pallas kernel here: its scan and PCR are compiled
loops.  The scan is T1 on the card; ``matvec_chol``, ``matvec`` and
``solve`` are plain PyTorch (the PCR solve ~20 launches a round).  The
library is built by ``ops._build`` at the first CUDA call, never at import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.ops import _build, launches

_KERNEL_DEVICE = "cuda"  # the only device type the wrapper launches on
_COUNTED = ("bidiag_cholesky",)  # T1's name in ops.launches


class TridiagChol(NamedTuple):
    """G = L L^T with L lower bidiagonal: diag ``ld``, subdiag ``e``."""

    ld: Tensor  # (..., T)
    e: Tensor  # (..., T-1)


def launch_counts() -> dict[str, int]:
    """Launches of T1 since the last reset (``ops.launches``)."""
    return launches.counts(_COUNTED)


def reset_launch_counts() -> None:
    launches.reset(_COUNTED)


def cholesky_plain(diag: Tensor, off: Tensor) -> TridiagChol:
    """Bidiagonal Cholesky of symmetric tridiagonal (diag, off), the plain twin.

    diag: (..., T), off: (..., T-1).  ld_0 = sqrt(d_0); for t >= 1
    e_t = off_{t-1} / ld_{t-1}, ld_t = sqrt(d_t - e_t^2): three launches a
    position.
    """
    t = diag.shape[-1]
    ld = [torch.sqrt(diag[..., 0])]
    e = []
    for i in range(1, t):
        e_i = off[..., i - 1] / ld[-1]
        ld.append(torch.sqrt(torch.addcmul(diag[..., i], e_i, e_i, value=-1.0)))
        e.append(e_i)
    e_out = torch.stack(e, dim=-1) if e else off.new_empty(off.shape)
    return TridiagChol(torch.stack(ld, dim=-1), e_out)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rhmc_bidiag_cholesky.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.rhmc_bidiag_cholesky.restype = i32
    return lib


def _check(diag: Tensor, off: Tensor) -> None:
    if diag.device.type != _KERNEL_DEVICE or off.device != diag.device:
        raise ValueError(f"the CUDA kernel needs CUDA tensors on one device, got {diag.device} and {off.device}")
    if diag.dtype != torch.float32 or off.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {diag.dtype} and {off.dtype}")
    if diag.ndim < 1 or diag.shape[-1] < 1:
        raise ValueError(f"expected diag of shape (..., T) with T >= 1, got {tuple(diag.shape)}")
    want = diag.shape[:-1] + (diag.shape[-1] - 1,)
    if off.shape != want:
        raise ValueError(f"off must have shape {tuple(want)} for diag {tuple(diag.shape)}, got {tuple(off.shape)}")


def _launch(tensors: tuple[Tensor, ...], b: int, t: int) -> None:
    """Launch T1 on (diag, off, ld, e) of ``b`` chains and length ``t``, and count it."""
    for x in tensors:
        if not x.is_contiguous():  # the kernel's index arithmetic assumes it
            raise ValueError("bidiag_cholesky: kernel operand is not contiguous")
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib().rhmc_bidiag_cholesky(*(x.data_ptr() for x in tensors), b, t, stream)
    if err != 0:
        raise RuntimeError(f"bidiag_cholesky kernel launch failed with CUDA error {err}")
    launches.count("bidiag_cholesky", device)


def cholesky_cuda(diag: Tensor, off: Tensor) -> TridiagChol:
    """T1 on the card: diag (..., T), off (..., T-1) float32 CUDA -> (ld, e),
    contiguous, shaped as diag and off.  An operand that is not contiguous
    (StochVol's off is an expanded view) is copied once."""
    _check(diag, off)
    t = diag.shape[-1]
    b = diag.numel() // t
    d2, o2 = diag.reshape(b, t).contiguous(), off.reshape(b, t - 1).contiguous()
    ld, e = torch.empty_like(d2), torch.empty_like(o2)
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


def solve(diag: Tensor, off: Tensor, b: Tensor) -> Tensor:
    """Solve G x = b for symmetric tridiagonal G by parallel cyclic reduction.

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
