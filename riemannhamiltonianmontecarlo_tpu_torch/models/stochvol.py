"""Stochastic volatility model (Girolami & Calderhead sec. 9).

Port of ``riemannhamiltonianmontecarlo_tpu/models/stochvol.py``; the
statistical contract is the same.  Latent AR(1) log-volatilities
``x_1 ~ N(0, sigma^2/(1-phi^2))``, ``x_{t+1} = phi x_t + N(0, sigma^2)``,
observations ``y_t = beta eps_t exp(x_t / 2)``; hyperparameters
theta = (beta, sigma, phi) with the priors of ``StochVol_RMHMC.m:228-229``.

Two conditional targets (the two-block Gibbs sweep of ``samplers/stochvol.py``):

* **latent block** x | theta: log density ``StochVol_RMHMC.m:115``, gradient
  ``s - iC x`` with iC the AR(1) precision, and the constant tridiagonal
  metric G = iC + I/2 (``:132-141``), all through ``ops.tridiag``;
* **hyper block** theta | x in the transformed coordinates
  theta~ = (beta, log sigma, atanh phi), with the Jacobian
  ``log(sigma (1 - phi^2))`` added to the target (``:227,412``) and the
  analytic 3x3 Fisher + prior metric (``:245-256``).

The hyper gradient is the exact autodiff gradient of the same target (the
MATLAB hand-coded constants are inconsistent with its own Hamiltonian; see
the JAX module's docstring), here by ``torch.func.grad``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import Tensor, nn
from torch.func import grad, vmap

from riemannhamiltonianmontecarlo_tpu_torch.models.base import autodiff_manifold, with_autograd
from riemannhamiltonianmontecarlo_tpu_torch.models.datasets import find_data_file
from riemannhamiltonianmontecarlo_tpu_torch.models.logreg import ManifoldState
from riemannhamiltonianmontecarlo_tpu_torch.ops import tridiag

REFERENCE_MAT = "StochVolData1.mat"  # the authors' simulated data set (Stoch_Vol/RM-HMC/)


def generate_data(
    seed: int = 0, num_obs: int = 2000, beta: float = 0.65, sigma: float = 0.15, phi: float = 0.98
) -> tuple[np.ndarray, np.ndarray]:
    """Simulate (y, x_true) exactly as ``StochVol_RMHMC.m:16-31``."""
    rng = np.random.default_rng(seed)
    x = np.zeros(num_obs)
    x[0] = rng.normal(0.0, sigma / np.sqrt(1 - phi**2))
    for n in range(num_obs - 1):
        x[n + 1] = phi * x[n] + rng.normal(0.0, sigma)
    y = beta * rng.normal(size=num_obs) * np.exp(x / 2)
    return y, x


def load_data(path: str | Path | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The authors' simulated data set if present (``path``, or ``REFERENCE_MAT``
    in ``$RHMC_DATA_DIR`` or ``<repo>/data``), else ``generate_data()``."""
    p = Path(path) if path is not None else find_data_file(REFERENCE_MAT)
    if p is None or not p.exists():
        return generate_data()
    from scipy.io import loadmat

    data = loadmat(p)
    return data["y"].reshape(-1), data["Truex"].reshape(-1)


class StochVolModel(nn.Module):
    """Conditional densities and geometry for the two-block sampler.

    Hyperparameters are handled in transformed coordinates
    theta~ = (beta, log sigma, atanh phi) throughout.  ``y`` is a buffer.
    """

    capturable = True  # samplers.base.model_capturable: torch.func under capture, held in chip_smoke.py phase 13

    def __init__(self, y: Tensor):
        super().__init__()
        self.register_buffer("y", y.reshape(-1))

    @property
    def num_obs(self) -> int:
        return self.y.shape[0]

    # -- coordinate transform ------------------------------------------------

    @staticmethod
    def constrain(theta_t: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """theta~ -> (beta, sigma, phi)."""
        return theta_t[..., 0], torch.exp(theta_t[..., 1]), torch.tanh(theta_t[..., 2])

    @staticmethod
    def unconstrain(beta: Tensor, sigma: Tensor, phi: Tensor) -> Tensor:
        return torch.stack([beta, torch.log(sigma), torch.atanh(phi)], dim=-1)

    # -- latent block --------------------------------------------------------

    def latent_logp(self, x: Tensor, theta_t: Tensor) -> Tensor:
        """log p(x, y | theta) up to consts (``StochVol_RMHMC.m:115``).

        x: (..., T), theta_t: (..., 3) -> (...,).
        """
        beta, sigma, phi = self.constrain(theta_t)
        y2 = self.y**2
        innov = x[..., 1:] - phi[..., None] * x[..., :-1]
        return (
            -(x[..., 0] ** 2) * (1.0 - phi**2) / (2.0 * sigma**2)
            - torch.sum(x / 2.0 + y2 / (2.0 * beta[..., None] ** 2 * torch.exp(x)), dim=-1)
            - torch.sum(innov**2, dim=-1) / (2.0 * sigma**2)
        )

    def latent_grad(self, x: Tensor, theta_t: Tensor) -> Tensor:
        """d latent_logp / dx = s - iC x  (``StochVol_RMHMC.m:121-130``)."""
        beta = theta_t[..., 0, None]
        s = -0.5 + self.y**2 / (2.0 * beta**2 * torch.exp(x))
        diag, off = self.ar1_precision(theta_t)
        return s - tridiag.matvec(diag, off, x)

    def ar1_precision(self, theta_t: Tensor) -> tuple[Tensor, Tensor]:
        """AR(1) precision iC as (diag (..., T), off (..., T-1))
        (``StochVol_RMHMC.m:129-135``: iC(1,1)=iC(T,T)=1/s^2, interior
        (1+phi^2)/s^2, off-diagonals -phi/s^2)."""
        _, sigma, phi = self.constrain(theta_t)
        t = self.num_obs
        inv_s2 = 1.0 / sigma**2
        interior = (1.0 + phi**2) * inv_s2
        idx = torch.arange(t, device=theta_t.device)
        is_end = (idx == 0) | (idx == t - 1)
        diag = torch.where(is_end, inv_s2[..., None], interior[..., None])
        off = (-phi * inv_s2)[..., None].expand(theta_t.shape[:-1] + (t - 1,))
        return diag, off

    def latent_metric(self, theta_t: Tensor) -> tuple[Tensor, Tensor]:
        """G = iC + I/2 (constant in x; ``StochVol_RMHMC.m:137-139``)."""
        diag, off = self.ar1_precision(theta_t)
        return diag + 0.5, off

    # -- hyper block (transformed coordinates) -------------------------------

    def hyper_logp(self, theta_t: Tensor, x: Tensor) -> Tensor:
        """log p(theta | x, y) in theta~ coords: LJL + prior + Jacobian.

        LJL ``StochVol_RMHMC.m:226``, prior ``:229``, Jacobian
        ``log(sigma (1-phi^2))`` ``:227``.
        """
        beta, sigma, phi = self.constrain(theta_t)
        t = self.num_obs
        y2 = self.y**2
        innov = x[..., 1:] - phi[..., None] * x[..., :-1]
        ljl = (
            -torch.sum(x / 2.0, dim=-1)
            - t * torch.log(beta)
            - torch.sum(y2 / (2.0 * beta[..., None] ** 2 * torch.exp(x)), dim=-1)
            + 0.5 * torch.log(1.0 - phi**2)
            - torch.log(sigma)
            - x[..., 0] ** 2 * (1.0 - phi**2) / (2.0 * sigma**2)
            - (t - 1) * torch.log(sigma)
            - torch.sum(innov**2, dim=-1) / (2.0 * sigma**2)
        )
        prior = (
            -beta
            - 0.5 / (2.0 * sigma**2)
            - 6.0 * torch.log(sigma**2)
            + torch.log(sigma)
            + 19.0 * torch.log((phi + 1.0) / 2.0)
            + 0.5 * torch.log((1.0 - phi) / 2.0)
        )
        jacobian = torch.log(sigma) + torch.log(1.0 - phi**2)
        return ljl + prior + jacobian

    def hyper_metric(self, theta_t: Tensor) -> Tensor:
        """3x3 Fisher + prior metric in theta~ coords (``:245-256``)."""
        beta, sigma, phi = self.constrain(theta_t)
        t = self.num_obs
        z = torch.zeros_like(beta)
        g00 = 2.0 * t / beta**2
        g11 = 2.0 * t + 1.0 / sigma**2  # Fisher 2T minus prior (-1/sigma^2)
        g12 = 2.0 * phi
        g22 = 2.0 * phi**2 - (t - 1) * (phi**2 - 1.0) + 39.0 * (1.0 - phi**2)  # minus prior (-38-1)(1-phi^2)
        row0 = torch.stack([g00, z, z], dim=-1)
        row1 = torch.stack([z, g11, g12], dim=-1)
        row2 = torch.stack([z, g12, g22], dim=-1)
        return torch.stack([row0, row1, row2], dim=-2)

    def hyper_manifold(self, x: Tensor) -> "HyperManifold":
        """A ManifoldModel view of theta~ | x for the RMHMC / mMALA kernels."""
        return HyperManifold(self, x)


class HyperManifold:
    """theta~ | x: the hyper block's conditional target as a ManifoldModel.

    Gradient by ``torch.func.grad`` of ``hyper_logp`` (vmapped over the
    chains, through ``models.base.with_autograd``); dG by jacrev of the
    analytic metric (D=3: the dense (3, 3, 3) jacobian is trivially cheap;
    the reference also materializes the full dGdParas there,
    ``StochVol_RMHMC.m:265-277``).
    """

    dim = 3

    def __init__(self, model: StochVolModel, x: Tensor):
        self.model = model
        self.x = x
        self._mani = autodiff_manifold(self, model.hyper_metric)
        self.metric = self._mani.metric
        self.dg_cache = self._mani.dg_cache
        self.dg_bilinear = self._mani.dg_bilinear
        self.dg_trace = self._mani.dg_trace
        self.dg_dotted = self._mani.dg_dotted

    def logp(self, th: Tensor) -> Tensor:
        x = self.x
        if x.ndim == 1:
            x = x.expand(th.shape[:-1] + x.shape[-1:])
        return self.model.hyper_logp(th, x)

    def grad(self, th: Tensor) -> Tensor:
        grad_fn = grad(self.model.hyper_logp)
        if th.ndim == 1:
            return with_autograd(grad_fn)(th, self.x)
        flat_th = th.reshape(-1, 3)
        if self.x.ndim == 1:
            g = with_autograd(vmap(grad_fn, in_dims=(0, None)))(flat_th, self.x)
        else:
            g = with_autograd(vmap(grad_fn))(flat_th, self.x.reshape(-1, self.x.shape[-1]))
        return g.reshape(th.shape)

    def logp_and_grad(self, th: Tensor) -> tuple[Tensor, Tensor]:
        return self.logp(th), self.grad(th)

    def manifold_state(self, th: Tensor) -> ManifoldState:
        return ManifoldState(self.logp(th), self.grad(th), self.metric(th), self.dg_cache(th))
