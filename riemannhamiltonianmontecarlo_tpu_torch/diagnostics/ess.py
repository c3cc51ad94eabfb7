"""Effective sample size: Geyer initial-monotone-sequence estimator.

A NumPy-only copy of the host estimator of
``riemannhamiltonianmontecarlo_tpu/diagnostics/ess.py`` (whose module imports
jax): ``nextpow2``, ``autocorrelation``, ``ess_geyer`` and ``ess_multichain``,
unchanged, so both packages report the same ESS for the same samples; plus
``ess_geyer_device``, the same estimator in float32 on ``torch.fft`` for
samples on the device, or on the host and streamed to it a slab at a time.  The
north-star metric (min-ESS/s) is *defined* by this estimator, a
re-derivation of the reference's (``code/tools.py:21-74`` / MATLAB
``Results/CalculateESS.m``):

* autocorrelation by Wiener-Khinchin FFT of the demeaned series;
* pair sums ``Gamma_j = rho_{2j} + rho_{2j+1}``, made monotone by a running min;
* ``MonoEst = -rho_0 + 2 * sum of the positive Gamma prefix`` clipped at
  >= 1;  ESS = N / MonoEst.

``nfft_mode``:
  * ``"reference"`` -- nFFT = nextpow2(N) + 1, the reference Python port's
    quirk (``code/tools.py:23``; too short for an alias-free linear ACF).
    Kept as the default because the metric is defined by it.
  * ``"exact"`` -- nFFT = 2 * nextpow2(N): alias-free linear ACF.

The host diagnostics run in float64: they are post-processing.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


def nextpow2(i: int) -> int:
    n = 1
    while n < i:
        n *= 2
    return n


def autocorrelation(samples: np.ndarray, max_lag: int, nfft_mode: str = "reference") -> np.ndarray:
    """Column-wise ACF up to ``max_lag`` inclusive.

    samples: (N, P) -> (max_lag + 1, P), normalized so lag 0 is 1.
    """
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    if nfft_mode == "reference":
        nfft = nextpow2(n) + 1
    elif nfft_mode == "exact":
        nfft = 2 * nextpow2(n)
    else:
        raise ValueError(f"nfft_mode must be 'reference' or 'exact', got {nfft_mode!r}")
    f = np.fft.fft(x - x.mean(axis=0), n=nfft, axis=0)
    acf = np.fft.ifft(f * np.conj(f), axis=0).real[: max_lag + 1]
    return acf / acf[0]


def ess_geyer(
    samples: np.ndarray, max_lag: int | None = None, nfft_mode: str = "reference"
) -> np.ndarray:
    """Geyer initial-monotone ESS per parameter.  samples: (N, P) -> (P,)."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    if max_lag is None:
        max_lag = n - 1
    acs = autocorrelation(x, max_lag, nfft_mode)  # (max_lag+1, P)
    half = (max_lag + 1) // 2
    gamma = acs[0 : 2 * half : 2] + acs[1 : 2 * half : 2]  # (half, P)
    gamma = np.minimum.accumulate(gamma, axis=0)  # initial monotone sequence
    mono = -acs[0] + 2.0 * np.sum(np.where(gamma > 0.0, gamma, 0.0), axis=0)
    mono = np.maximum(mono, 1.0)
    return n / mono


def host_array(samples, device) -> np.ndarray | None:
    """``samples`` as a float32 host array when they are to be streamed to
    ``device`` a slab at a time: an ``np.ndarray``, or a CPU tensor with
    another ``device``; else None (a tensor computed where it lies)."""
    if isinstance(samples, np.ndarray):
        return samples.astype(np.float32, copy=False)
    if device is not None and samples.device != torch.device(device):
        return samples.detach().cpu().numpy().astype(np.float32, copy=False)
    return None


def ess_geyer_device(samples, max_lag: int | None = None, max_bytes: int = 1 << 29, device=None) -> Tensor:
    """Geyer ESS on a device (exact, alias-free ACF), in float32.

    samples: (N, P) or (C, N, P) -> (P,), summed over chains.  Equal to
    ``ess_multichain(..., nfft_mode="exact")`` up to float32 precision.
    The parameter axis is processed in chunks so the complex FFT scratch
    (C x 2 nextpow2(N) x chunk complex64) stays under ``max_bytes``.

    A tensor is computed on its own device.  Samples on the host -- an
    ``np.ndarray``, or a CPU tensor with another ``device`` (kept samples
    streamed off the card because the whole trajectory does not fit, as
    StochVol's 64 x 20000 x 2003 does not twice) -- are demeaned and sliced
    on the host, and one (C, N, chunk) slab at a time goes to ``device``
    (default: the CPU); the result lies on ``device``.
    """
    host = host_array(samples, device)
    x = samples if host is None else host
    multichain = x.ndim == 3
    if not multichain:
        x = x[None]
    c, n, p = x.shape
    if max_lag is None:
        max_lag = n - 1
    nfft = 2 * nextpow2(n)
    half = (max_lag + 1) // 2

    def chunk_ess(xc_chunk: Tensor) -> Tensor:
        f = torch.fft.fft(xc_chunk, n=nfft, dim=1)
        acf = torch.fft.ifft(f * torch.conj(f), dim=1).real[:, : max_lag + 1]
        acf = acf / torch.clamp(acf[:, :1], min=1e-30)
        gamma = acf[:, 0 : 2 * half : 2] + acf[:, 1 : 2 * half : 2]
        gamma = torch.cummin(gamma, dim=1).values  # initial monotone sequence
        mono = -acf[:, 0] + 2.0 * torch.sum(torch.clamp(gamma, min=0.0), dim=1)
        return n / torch.clamp(mono, min=1.0)  # (C, chunk)

    chunk = max(int(max_bytes // (8 * c * nfft)), 1)
    if host is None:
        xc = x - x.mean(dim=1, keepdim=True)
        slabs = (xc[:, :, lo : lo + chunk] for lo in range(0, p, chunk))
    else:
        target = torch.device("cpu" if device is None else device)
        xc = x - x.mean(axis=1, keepdims=True)
        slabs = (torch.from_numpy(np.ascontiguousarray(xc[:, :, lo : lo + chunk])).to(target)
                 for lo in range(0, p, chunk))
    ess = torch.cat([chunk_ess(slab) for slab in slabs], dim=1)
    return ess.sum(dim=0) if multichain else ess[0]


def ess_multichain(
    samples: np.ndarray, max_lag: int | None = None, nfft_mode: str = "reference"
) -> np.ndarray:
    """Total ESS over independent chains: sum of per-chain Geyer ESS.

    samples: (C, N, P) -> (P,).  For independent chains, effective samples
    add; this is the quantity the ESS/s benchmark maximizes.
    """
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 2:
        return ess_geyer(x, max_lag, nfft_mode)
    c, n, p = x.shape
    # Batch the FFT across chains and parameters in one call: (N, C*P).
    flat = np.moveaxis(x, 1, 0).reshape(n, c * p)
    per = ess_geyer(flat, max_lag, nfft_mode).reshape(c, p)
    return per.sum(axis=0)
