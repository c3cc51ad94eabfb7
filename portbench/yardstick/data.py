"""The configurations' data, made from a seed, and BLR's starting point.

Frozen copies, so that a change to the program cannot change the data:

* ``synthetic_logreg``: ``riemannhamiltonianmontecarlo_tpu_torch/models/datasets.py:101-118``
  (itself bit-identical to the JAX package's), standardized Gaussian features, an
  intercept column, labels from the logistic model at a Gaussian weight;
* ``stochvol_data``: ``riemannhamiltonianmontecarlo_tpu_torch/models/stochvol.py:41-51``,
  ``StochVol_RMHMC.m:16-31``'s simulation of the AR(1) log-volatilities and the
  observations.

``map_estimate`` is the benchmark's own: Newton's method on BLR's log joint in
float64 (the Fisher metric is the negative Hessian there).
"""

from __future__ import annotations

import numpy as np


def synthetic_logreg(seed: int, n: int, d: int, *, w_scale: float = 1.5) -> tuple[np.ndarray, np.ndarray]:
    """(X (n, d) with the intercept first, t (n,) in {0, 1}), float64."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d - 1))
    x = (x - x.mean(0)) / x.std(0)
    xx = np.hstack([np.ones((n, 1)), x])
    w_true = rng.normal(size=d) * w_scale
    p = 1.0 / (1.0 + np.exp(-xx @ w_true))
    t = (rng.uniform(size=n) < p).astype(np.float64)
    return xx, t


def stochvol_data(seed: int, num_obs: int, beta: float, sigma: float, phi: float) -> tuple[np.ndarray, np.ndarray]:
    """(y (T,), the simulated log-volatilities x (T,)), float64."""
    rng = np.random.default_rng(seed)
    x = np.zeros(num_obs)
    x[0] = rng.normal(0.0, sigma / np.sqrt(1 - phi**2))
    for n in range(num_obs - 1):
        x[n + 1] = phi * x[n] + rng.normal(0.0, sigma)
    y = beta * rng.normal(size=num_obs) * np.exp(x / 2)
    return y, x


def map_estimate(x: np.ndarray, t: np.ndarray, alpha: float, steps: int = 50) -> np.ndarray:
    """The mode of BLR's log joint t^T X w - sum log(1 + e^{Xw}) - |w|^2 / (2 alpha), by Newton's method."""
    w = np.zeros(x.shape[1])
    for _ in range(steps):
        p = 1.0 / (1.0 + np.exp(-x @ w))
        grad = x.T @ (t - p) - w / alpha
        hess = x.T @ (x * (p * (1.0 - p))[:, None]) + np.eye(x.shape[1]) / alpha
        w = w + np.linalg.solve(hess, grad)
    return w
