"""Visualization: trace plots, histograms, ACF, posterior fields.

Port of ``riemannhamiltonianmontecarlo_tpu/diagnostics/plots.py``: the
reference's eyeball diagnostics as functions instead of inline scripts:
parameter traces and histograms (``code/main.py:62-67``,
``BLR_RMHMC.m:409-415``), autocorrelation plots (``code/main.py:66-67``) and
the LGC true-vs-estimated latent field images
(``Log_Gaussian_Cox/RMHMC/Results/PlotTrueAndEstimated.m:17-20``).

Every function takes NumPy arrays and returns a matplotlib figure.
matplotlib is imported inside the functions, so a machine without it (the
card's) runs the rest of the package.
"""

from __future__ import annotations

import numpy as np

from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.ess import autocorrelation


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def trace_plot(samples: np.ndarray, max_params: int = 8, title: str = ""):
    """Per-parameter traces.  samples: (S, P) or (C, S, P) (chain 0 shown)."""
    plt = _plt()
    x = np.asarray(samples)
    if x.ndim == 3:
        x = x[0]
    p = min(x.shape[1], max_params)
    fig, axes = plt.subplots(p, 1, figsize=(8, 1.4 * p), sharex=True)
    axes = np.atleast_1d(axes)
    for i in range(p):
        axes[i].plot(x[:, i], linewidth=0.4)
        axes[i].set_ylabel(f"w{i}")
    axes[-1].set_xlabel("iteration")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    return fig


def histogram_plot(samples: np.ndarray, max_params: int = 8, bins: int = 50):
    """Posterior marginals (BLR_RMHMC.m:413-415)."""
    plt = _plt()
    x = np.asarray(samples)
    x = x.reshape(-1, x.shape[-1])
    p = min(x.shape[1], max_params)
    cols = min(p, 4)
    rows = -(-p // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.2 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i in range(p):
        axes[i].hist(x[:, i], bins=bins, density=True)
        axes[i].set_title(f"w{i}")
    for ax in axes[p:]:
        ax.axis("off")
    fig.tight_layout()
    return fig


def acf_plot(samples: np.ndarray, max_lag: int = 100, nfft_mode: str = "reference"):
    """Autocorrelation of each parameter (code/main.py:66-67)."""
    plt = _plt()
    x = np.asarray(samples)
    if x.ndim == 3:
        x = x[0]
    acf = autocorrelation(x, max_lag, nfft_mode)
    fig, ax = plt.subplots(figsize=(7, 3.5))
    ax.plot(acf, linewidth=0.8)
    ax.axhline(0.0, color="k", linewidth=0.5)
    ax.set_xlabel("lag")
    ax.set_ylabel("ACF")
    fig.tight_layout()
    return fig


def field_plot(true_field: np.ndarray, estimated_field: np.ndarray, n: int | None = None):
    """LGC true vs posterior-mean latent field (PlotTrueAndEstimated.m)."""
    plt = _plt()
    t = np.asarray(true_field).reshape(-1)
    e = np.asarray(estimated_field).reshape(-1)
    if n is None:
        n = int(np.sqrt(t.shape[0]))
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    for ax, data, name in ((axes[0], t, "true"), (axes[1], e, "posterior mean")):
        im = ax.imshow(data.reshape(n, n))
        ax.set_title(name)
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    return fig
