"""Geyer's initial-monotone-sequence ESS, alias-free, in float64.

A frozen copy of ``riemannhamiltonianmontecarlo_tpu_torch/diagnostics/ess.py``
(``ess_geyer``, lines 61-77, with ``autocorrelation``'s ``"exact"`` mode,
lines 41-58: nFFT = 2 nextpow2(N), so the linear autocorrelation is not
aliased whatever N is).  The program's default ``"reference"`` mode takes
nFFT = nextpow2(N) + 1, which aliases by an amount that depends on N; in a
window of fixed seconds N moves with the program's speed, so that mode is not
used here.

Per chain and coordinate: the autocorrelation of the demeaned series by FFT,
pair sums Gamma_j = rho_2j + rho_2j+1 made monotone by a running minimum,
tau = -rho_0 + 2 * (sum of the positive Gamma prefix) clipped at >= 1, and
ESS = N / tau.  A chain's ESS are summed over chains.  A series with no
variance (a chain that never moved) has no information and gives 0, where the
program's device estimator would give N.
"""

from __future__ import annotations

import torch
from torch import Tensor


def nextpow2(i: int) -> int:
    n = 1
    while n < i:
        n *= 2
    return n


def geyer_ess(x: Tensor) -> Tensor:
    """(C, N) series of C chains, float64 on any device -> (C,) ESS of each chain."""
    x = x.to(torch.float64)
    n = x.shape[1]
    nfft = 2 * nextpow2(n)
    f = torch.fft.rfft(x - x.mean(dim=1, keepdim=True), n=nfft, dim=1)
    acf = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=1)[:, :n]
    del f
    var = acf[:, :1]
    moved = var[:, 0] > 0
    acf = acf / torch.where(var > 0, var, 1.0)
    half = n // 2
    gamma = torch.cummin(acf[:, 0 : 2 * half : 2] + acf[:, 1 : 2 * half : 2], dim=1).values
    tau = torch.clamp(-acf[:, 0] + 2.0 * torch.clamp(gamma, min=0.0).sum(dim=1), min=1.0)
    return torch.where(moved, n / tau, 0.0)


def total_ess(series, chains: int, length: int, device, max_bytes: int = 1 << 30) -> Tensor:
    """ESS summed over ``chains`` chains of ``length`` samples, one coordinate.  ``series(lo, hi)`` gives
    chains lo:hi as a (hi - lo, length) tensor (any device, any float dtype); blocks of chains go to
    ``device`` in float64 so that the FFT's buffers stay under about ``max_bytes``."""
    per_chain = 16 * (nextpow2(length) + 1) + 8 * 3 * length  # the complex spectrum and a few real copies
    block = max(1, max_bytes // per_chain)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for lo in range(0, chains, block):
        total += geyer_ess(series(lo, min(lo + block, chains)).to(device=device, dtype=torch.float64)).sum()
    return total
