"""Batched symmetric-tridiagonal linear algebra for chain-structured models.

Port of ``riemannhamiltonianmontecarlo_tpu/ops/tridiag.py``.  The
stochastic-volatility latent block has a constant tridiagonal metric
G = AR(1)-precision + I/2 (``StochVol_RMHMC.m:132-141``), so a sweep needs
one factorization (momentum sampling) and ~L tridiagonal solves ``G \\ p``.
Everything is batched over the leading (chain) axes, with T last:

* ``cholesky``: the bidiagonal factor by the sequential recurrence over T,
  a Python loop of three launches per position with the chains vectorized
  (the JAX package's ``lax.scan``);
* ``matvec_chol``: L z (bidiagonal), one shifted multiply-add;
* ``matvec``: G x;
* ``solve``: parallel cyclic reduction (PCR), ceil(log2 T) lockstep rounds
  of elementwise work; shifts are pad-and-slice, with zero fill for the
  off-diagonals and identity fill (1.0) for the diagonal.

Not a Pallas kernel in the JAX package, so plain PyTorch here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor


class TridiagChol(NamedTuple):
    """G = L L^T with L lower bidiagonal: diag ``ld``, subdiag ``e``."""

    ld: Tensor  # (..., T)
    e: Tensor  # (..., T-1)


def cholesky(diag: Tensor, off: Tensor) -> TridiagChol:
    """Bidiagonal Cholesky of symmetric tridiagonal (diag, off).

    diag: (..., T), off: (..., T-1).  ld_0 = sqrt(d_0); for t >= 1
    e_t = off_{t-1} / ld_{t-1}, ld_t = sqrt(d_t - e_t^2).
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
