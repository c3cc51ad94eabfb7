"""Log-Gaussian Cox point process on an N x N grid (paper sec. 10).

Port of ``riemannhamiltonianmontecarlo_tpu/models/lgc.py::LGCModel``; the
statistical contract is the same (``Log_Gaussian_Cox/RMHMC/LGC_RMHMC_LV.m``):

* hyperparameters s = 1.91, b = 1/33, mu = log(126) - s/2, m = 1/N^2
  (``:21-25``);
* GP prior covariance over unit-square grid coordinates
  ``Sigma_ij = s exp(-dist_ij / (b N))`` (``:58-79``);
* Poisson-count log joint ``y^T x - sum m e^x - (x-mu)^T Sigma^{-1}
  (x-mu)/2`` (``:86``);
* the constant metric G = Sigma^{-1} + diag(m exp(mu + diag Sigma)), the
  Fisher metric at the prior mean (``:95-101``), as ``metric_chol`` /
  ``metric_inv`` for ``samplers/phmc.py`` and ``samplers/pmala.py``;
* the position-dependent Fisher metric G(x) = Sigma^{-1} + diag(m e^x) and
  its (diagonal) dG contractions for ``samplers/mmala.py``.

D = N^2 = 4096 at the reference size.  The one-time dense algebra (inverse,
Cholesky) runs in float64 on the host and is cast to float32 on the model's
device; every per-position method is a (C, D) x (D, D) GEMM (cuBLAS, full
fp32) plus elementwise work.  ``logp_and_grad_fast`` is the TF32 variant,
for in-trajectory use only (as ``samplers/phmc.py`` runs its leapfrog
under ``trajectory_precision`` "high" / "default").
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
from torch import Tensor, nn

from riemannhamiltonianmontecarlo_tpu_torch._precision import tf32_matmuls
from riemannhamiltonianmontecarlo_tpu_torch.models.datasets import find_data_file
from riemannhamiltonianmontecarlo_tpu_torch.models.logreg import ManifoldState

REFERENCE_MAT = "TestData64.mat"  # the authors' data set (Log_Gaussian_Cox/RMHMC/)


def grid_distances(n: int) -> np.ndarray:
    """Pairwise Euclidean distances of the unit-square grid (n^2, n^2)."""
    r = np.linspace(0.0, 1.0, n)
    xs, ys = np.meshgrid(r, r)
    coords = np.stack([xs.ravel(), ys.ravel()], axis=1)  # (n^2, 2)
    diff = coords[:, None, :] - coords[None, :, :]
    return np.sqrt((diff**2).sum(-1))


def grid_covariance(n: int, s: float, b: float) -> np.ndarray:
    """Sigma_ij = s exp(-||coord_i - coord_j|| / (b n)) on the unit square
    (``LGC_RMHMC_LV.m:58-79``; meshgrid order => row-major over (y, x))."""
    return s * np.exp(-grid_distances(n) / (b * n))


def generate_data(seed: int = 0, n: int = 64, s: float = 1.91, b: float = 1.0 / 33.0) -> tuple[np.ndarray, np.ndarray]:
    """Simulate (y counts, x_true) from the model (known-truth pattern)."""
    rng = np.random.default_rng(seed)
    mu = np.log(126.0) - s / 2.0
    m = 1.0 / n**2
    sigma = grid_covariance(n, s, b)
    chol = np.linalg.cholesky(sigma + 1e-10 * np.eye(n * n))
    x = mu + chol @ rng.normal(size=n * n)
    y = rng.poisson(m * np.exp(x)).astype(np.float64)
    return y, x


def load_data(path: str | Path | None = None, n: int = 64):
    """The authors' data set (fields Y counts, X latents) if present (``path``,
    or ``REFERENCE_MAT`` in ``$RHMC_DATA_DIR`` or ``<repo>/data``), else
    ``generate_data(n=n)``."""
    p = Path(path) if path is not None else find_data_file(REFERENCE_MAT)
    if p is None or not p.exists():
        return generate_data(n=n)
    from scipy.io import loadmat

    data = loadmat(p)
    return data["Y"].reshape(-1), data["X"].reshape(-1)


def host_operators(n: int, s: float, b: float) -> dict[str, np.ndarray]:
    """Sigma^{-1}, chol(G) and G^{-1} of the constant metric, in float64 on the host
    (the reference uses lightspeed chol2inv, ``LGC_RMHMC_LV.m:81``)."""
    mu = math.log(126.0) - s / 2.0
    m = 1.0 / n**2
    sigma = grid_covariance(n, s, b)
    sigma_inv = np.linalg.inv(sigma)
    g = sigma_inv + np.diag(m * np.exp(mu + np.diag(sigma)))
    return {"sigma_inv": sigma_inv, "metric_chol": np.linalg.cholesky(g), "metric_inv": np.linalg.inv(g)}


class LGCModel(nn.Module):
    """Latent-field posterior with precomputed dense GP algebra.

    ``y``: (D,) counts.  The dense (D, D) operators are buffers on ``y``'s
    device: computed from the grid in float64 on the host, or passed in
    (``sigma_inv``, ``metric_chol``, ``metric_inv``, e.g. the JAX model's
    float32 arrays, so that two implementations compute on identical
    constants).  All per-position methods are batched over leading chain axes.
    """

    def __init__(
        self,
        y: Tensor,
        n: int = 64,
        s: float = 1.91,
        b: float = 1.0 / 33.0,
        *,
        sigma_inv: Tensor | None = None,
        metric_chol: Tensor | None = None,
        metric_inv: Tensor | None = None,
    ):
        super().__init__()
        self.n, self.s, self.b = n, s, b
        self.mu = float(np.log(126.0) - s / 2.0)
        self.m = 1.0 / n**2
        given = {"sigma_inv": sigma_inv, "metric_chol": metric_chol, "metric_inv": metric_inv}
        host = host_operators(n, s, b) if any(v is None for v in given.values()) else {}
        self.register_buffer("y", y.reshape(-1).to(torch.float32))
        for name, value in given.items():
            if value is None:
                value = torch.from_numpy(host[name])
            self.register_buffer(name, value.to(device=y.device, dtype=torch.float32))

    @property
    def dim(self) -> int:
        return self.n * self.n

    def logp(self, x: Tensor) -> Tensor:
        """y^T x - sum m e^x - (x-mu)^T Sigma^{-1} (x-mu)/2 (``:86``)."""
        centered = x - self.mu
        quad = torch.sum(centered * torch.matmul(centered, self.sigma_inv), dim=-1)
        return torch.sum(x * self.y, dim=-1) - self.m * torch.sum(torch.exp(x), dim=-1) - 0.5 * quad

    def grad(self, x: Tensor) -> Tensor:
        """y - m e^x - Sigma^{-1}(x - mu) (``:127``)."""
        return self.y - self.m * torch.exp(x) - torch.matmul(x - self.mu, self.sigma_inv)

    def logp_and_grad(self, x: Tensor) -> tuple[Tensor, Tensor]:
        centered = x - self.mu
        sx = torch.matmul(centered, self.sigma_inv)
        expx = torch.exp(x)
        logp = torch.sum(x * self.y, dim=-1) - self.m * torch.sum(expx, dim=-1) - 0.5 * torch.sum(centered * sx, dim=-1)
        return logp, self.y - self.m * expx - sx

    def logp_and_grad_fast(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """The TF32 variant, for IN-TRAJECTORY use only.

        The ``Sigma^{-1}`` GEMM runs in TF32 on the card (no change on the
        CPU).  Safe only where the caller re-evaluates the exact Hamiltonian
        at the trajectory endpoints before the MH test (``samplers/phmc.py``
        ``trajectory_precision``): integration error then moves acceptance,
        not the stationary distribution.
        """
        with tf32_matmuls():
            return self.logp_and_grad(x)

    def prior_mean(self) -> Tensor:
        return torch.full((self.dim,), self.mu, dtype=torch.float32, device=self.y.device)

    # -- position-dependent manifold interface (mMALA, ``LGC_mMALA_LV.m``) --
    #
    # The exact Fisher metric is G(x) = Sigma^{-1} + diag(m e^x), so
    # dG_d = m e^{x_d} E_dd is diagonal: every contraction a manifold sampler
    # needs is elementwise or one matvec -- no (D, D, D) tensor at D = 4096.

    def metric(self, x: Tensor) -> Tensor:
        """G(x) = Sigma^{-1} + diag(m e^x).  (..., D) -> (..., D, D).

        Materializes a dense (D, D) per chain (64 MB at D = 4096): use few chains.
        """
        return self.sigma_inv + torch.diag_embed(self.m * torch.exp(x))

    def dg_cache(self, x: Tensor) -> Tensor:
        """(..., D) diagonal weights m e^x;  dG_d = m e^{x_d} E_dd."""
        return self.m * torch.exp(x)

    def dg_bilinear(self, x: Tensor, u: Tensor, v: Tensor, *, cache: Tensor | None = None) -> Tensor:
        c = self.dg_cache(x) if cache is None else cache
        return c * u * v

    def dg_trace(self, x: Tensor, mmat: Tensor, *, cache: Tensor | None = None) -> Tensor:
        c = self.dg_cache(x) if cache is None else cache
        return c * torch.diagonal(mmat, dim1=-2, dim2=-1)

    def dg_dotted(self, x: Tensor, mmat: Tensor, *, cache: Tensor | None = None) -> Tensor:
        """[sum_e (M dG_e M)[:, e]] = M @ (c * diag M)."""
        c = self.dg_cache(x) if cache is None else cache
        weights = c * torch.diagonal(mmat, dim1=-2, dim2=-1)
        return torch.einsum("...ie,...e->...i", mmat, weights)

    def manifold_state(self, x: Tensor) -> ManifoldState:
        logp, grad = self.logp_and_grad(x)
        return ManifoldState(logp, grad, self.metric(x), self.dg_cache(x))

    # -- whitened view (MALA with transformation, ``LGC_MALA_Transient.m``) --

    def whitened(self) -> "WhitenedLGC":
        """Model over gamma with x = mu + L gamma, L = chol(Sigma) (float64 on
        the host, cast to float32); the reference's "MALA with
        transformation" (``LGC_MALA_Transient.m:32-37``).  The Jacobian is
        constant, so log densities differ by a constant."""
        sigma = grid_covariance(self.n, self.s, self.b)
        chol = np.linalg.cholesky(sigma + 1e-10 * np.eye(self.dim))
        return WhitenedLGC(self, torch.tensor(chol, dtype=torch.float32, device=self.y.device))


class WhitenedLGC:
    """The LGC posterior over gamma, x = mu + L gamma."""

    def __init__(self, model: LGCModel, chol: Tensor):
        self.model = model
        self.chol = chol
        self.dim = model.dim

    def to_x(self, gamma: Tensor) -> Tensor:
        return self.model.mu + torch.matmul(gamma, self.chol.T)

    def logp(self, gamma: Tensor) -> Tensor:
        return self.model.logp(self.to_x(gamma))

    def grad(self, gamma: Tensor) -> Tensor:
        return torch.matmul(self.model.grad(self.to_x(gamma)), self.chol)

    def logp_and_grad(self, gamma: Tensor) -> tuple[Tensor, Tensor]:
        lp, gx = self.model.logp_and_grad(self.to_x(gamma))
        return lp, torch.matmul(gx, self.chol)
