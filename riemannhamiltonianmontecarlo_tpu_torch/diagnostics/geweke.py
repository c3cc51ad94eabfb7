"""Geweke (1992) convergence diagnostic.

A NumPy-only copy of ``riemannhamiltonianmontecarlo_tpu/diagnostics/geweke.py``
(whose package imports jax), unchanged but for the import of ``ess_geyer``.

Net-new relative to the reference (which verifies convergence only by
eyeballing trace plots, e.g. ``BLR_RMHMC.m:409-415``); added per the test
strategy implied by SURVEY.md section 4(c): statistical identity tests for
the new framework.

The z-score compares the mean of the first ``first`` fraction of a chain
against the mean of the last ``last`` fraction, normalizing by
spectral-density variance estimates of each segment's mean.  The spectral
variance at frequency zero is obtained from the same Geyer
initial-monotone machinery used for ESS (``diagnostics/ess.py``):
``Var(segment mean) = Var(x) / ESS(segment)``.

Under stationarity z ~ N(0, 1); |z| well above ~3 flags an unconverged
(still-drifting) chain.
"""

from __future__ import annotations

import numpy as np

from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.ess import ess_geyer


def _segment_var_of_mean(x: np.ndarray) -> np.ndarray:
    """Variance of the segment mean: Var(x) / ESS(x).  x: (N, P) -> (P,)."""
    n = x.shape[0]
    ess = np.maximum(ess_geyer(x, nfft_mode="exact"), 1.0)
    return x.var(axis=0, ddof=1) / np.minimum(ess, n)


def geweke_z(samples: np.ndarray, first: float = 0.1, last: float = 0.5) -> np.ndarray:
    """Geweke z-scores per parameter.

    samples: (N,), (N, P) or (C, N, P).  With a chain axis, each chain is
    scored independently and the result is (C, P).
    """
    x = np.asarray(samples, dtype=np.float64)
    squeeze_param = x.ndim == 1
    if squeeze_param:
        x = x[:, None]
    if x.ndim == 3:
        out = np.stack([geweke_z(c, first, last) for c in x])
        return out

    n = x.shape[0]
    n_a, n_b = max(int(first * n), 2), max(int(last * n), 2)
    a, b = x[:n_a], x[n - n_b :]
    z = (a.mean(axis=0) - b.mean(axis=0)) / np.sqrt(
        _segment_var_of_mean(a) + _segment_var_of_mean(b)
    )
    return z[0] if squeeze_param else z
