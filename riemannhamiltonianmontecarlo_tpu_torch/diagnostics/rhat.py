"""Split R-hat.

A NumPy-only copy of ``split_rhat`` from
``riemannhamiltonianmontecarlo_tpu/diagnostics/rhat.py`` (whose module
imports jax), unchanged; and ``split_rhat_device``, the same formula in
torch on the samples' device, over the chains of every rank of a process
group when one is given (as the JAX package gets it under GSPMD).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Gelman-Rubin split-R-hat.  samples: (C, N, P) -> (P,)."""
    x = np.asarray(samples, dtype=np.float64)
    c, n, p = x.shape
    half = n // 2
    halves = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)  # (2C, half, P)
    s = halves.shape[1]
    chain_mean = halves.mean(axis=1)  # (2C, P)
    chain_var = halves.var(axis=1, ddof=1)  # (2C, P)
    w = chain_var.mean(axis=0)
    b = s * chain_mean.var(axis=0, ddof=1)
    var_plus = (s - 1) / s * w + b / s
    return np.sqrt(var_plus / w)


def split_rhat_device(samples: Tensor, group=None) -> Tensor:
    """Split R-hat on the samples' device.  samples: (C, N, P) -> (P,).

    With a ``group`` the samples are this rank's chains and the result is
    the R-hat of the chains of every rank of the group, the same on each:
    the half-chain means and variances are pooled by two all-reduces (the
    mean of the means first, then the spread around it).
    """
    half = samples.shape[1] // 2
    halves = torch.cat([samples[:, :half], samples[:, half : 2 * half]], dim=0)
    s = halves.shape[1]
    chain_mean = halves.mean(dim=1)
    chain_var = halves.var(dim=1, correction=1)
    if group is None:
        w = chain_var.mean(dim=0)
        b = s * chain_mean.var(dim=0, correction=1)
    else:
        m = chain_mean.shape[0] * collectives.group_size(group)
        sums = collectives.cross_chain_sum(torch.stack([chain_mean, chain_var], dim=1), group)
        grand, w = sums[0] / m, sums[1] / m
        b = s * collectives.cross_chain_sum((chain_mean - grand) ** 2, group) / (m - 1)
    var_plus = (s - 1) / s * w + b / s
    return torch.sqrt(var_plus / w)
