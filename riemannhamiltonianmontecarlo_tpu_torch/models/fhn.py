"""FitzHugh-Nagumo ODE parameter inference (paper sec. 11).

Port of ``riemannhamiltonianmontecarlo_tpu/models/fhn.py``; the statistical
contract is the same (``Matlab_ODEs/RunFHN_RMHMC.m:35-52``,
``Models/FitzHughNagumo.m``):

* dynamics dV/dt = c (V - V^3/3 + R), dR/dt = -(V - a + b R)/c, both
  species observed at ``num_obs`` equispaced times on [0, 20], initial values
  (-1, 1), true parameters (a, b, c) = (0.2, 0.2, 3), iid Gaussian noise of
  known sd 0.5; the states come from fixed-step RK4 with ``substeps`` steps
  per observation interval;
* prior theta_i ~ Gamma(shape 1, scale 3), support theta > 0: ``logp`` is
  -inf outside it and where the trajectory is not finite;
* metric G = sum_species S^T S / sigma^2 + diag(2 / theta^2), S the first
  sensitivities dy/dtheta; ``dg_cache`` is the dense dG (..., 3, 3, 3) with
  ``[d] = dG/dtheta_d``, contracted as ``models.base._AutodiffManifold``
  contracts its cache.

Where the JAX model differentiates its integrator with ``jax.grad`` and
``jacfwd``, every quantity here comes from one call of
``ops.fhn_sens.fhn_sensitivities``, which integrates the augmented
sensitivity system: the hand-written CUDA kernel for a CUDA batch, its
plain twin for a CPU one.  A call returns everything up to its order, so
``manifold_state`` is one order-2 call, ``logp_and_grad`` and ``metric``
one order-1 call each and ``logp`` one order-0 call.  No ``torch.func``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor, nn

from riemannhamiltonianmontecarlo_tpu_torch.models.logreg import ManifoldState
from riemannhamiltonianmontecarlo_tpu_torch.ops import fhn_sens

THETA_TRUE = (0.2, 0.2, 3.0)  # RunFHN_RMHMC.m:41


def fhn_rhs(state: Tensor, theta: Tensor) -> Tensor:
    """FitzHugh-Nagumo vector field (``Models/FitzHughNagumo.m``).  (..., 2), (..., 3) -> (..., 2)."""
    v, r = state[..., 0], state[..., 1]
    a, b, c = theta[..., 0], theta[..., 1], theta[..., 2]
    dv = c * (v - v * v * v / 3.0 + r)
    dr = -(v - a + b * r) / c
    return torch.stack([dv, dr], dim=-1)


def integrate_rk4(
    theta: Tensor,
    *,
    t0: float = fhn_sens.T0,
    t1: float = fhn_sens.T1,
    num_obs: int = 200,
    substeps: int = 5,
    init: tuple[float, float] = fhn_sens.INIT,
) -> Tensor:
    """States at the ``num_obs`` observation times by fixed-step RK4.

    theta (..., 3) -> (..., num_obs, 2), the initial state first; the
    JAX model's ``lax.scan`` as a Python loop, batched over leading axes.
    """
    h = fhn_sens.step_size(num_obs, substeps, t0, t1)
    y = torch.tensor(init, dtype=theta.dtype, device=theta.device).expand(theta.shape[:-1] + (2,))
    traj = [y]
    for _ in range(num_obs - 1):
        for _ in range(substeps):
            k1 = fhn_rhs(y, theta)
            k2 = fhn_rhs(y + 0.5 * h * k1, theta)
            k3 = fhn_rhs(y + 0.5 * h * k2, theta)
            k4 = fhn_rhs(y + h * k3, theta)
            y = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        traj.append(y)
    return torch.stack(traj, dim=-2)


def generate_data(seed: int = 1, noise_sd: float = 0.5, **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """Noisy observations at the true parameters (``RunFHN_RMHMC.m:35-52``).

    The JAX package's recipe: the clean trajectory in float32 at 20 substeps,
    plus ``np.random.default_rng(seed).normal`` noise, so both packages see
    the same data to float32 rounding.  ``kwargs`` go to :func:`integrate_rk4`.
    Returns (noisy (num_obs, 2) float64, clean (num_obs, 2) float32).
    """
    theta_true = torch.tensor(THETA_TRUE, dtype=torch.float32)
    with torch.inference_mode():
        clean = integrate_rk4(theta_true, substeps=20, **kwargs).numpy()
    rng = np.random.default_rng(seed)
    return clean + rng.normal(size=clean.shape) * noise_sd, clean


class FHNModel(nn.Module):
    """Posterior over (a, b, c) given noisy FHN trajectories; D = 3.

    ``data`` (num_obs, 2) is a buffer; every method takes positions with any
    leading axes.
    """

    capturable = True  # samplers.base.model_capturable

    def __init__(self, data: Tensor, noise_sd: float = 0.5, substeps: int = 5, gamma_scale: float = 3.0,
                 dim: int = 3):
        super().__init__()
        if dim != fhn_sens.DIM:
            raise ValueError(f"the FitzHugh-Nagumo model has {fhn_sens.DIM} parameters, got dim={dim}")
        self.register_buffer("data", data)
        self.noise_sd = noise_sd
        self.substeps = substeps
        self.gamma_scale = gamma_scale
        self.dim = dim

    def sensitivities(self, theta: Tensor, order: int) -> fhn_sens.FHNSensitivities:
        """One call of the sensitivity system at ``order`` over all leading axes."""
        lead = theta.shape[:-1]
        out = fhn_sens.fhn_sensitivities(theta.reshape(-1, self.dim), self.data, order, substeps=self.substeps,
                                         noise_sd=self.noise_sd, gamma_scale=self.gamma_scale)
        return fhn_sens.FHNSensitivities(*(None if t is None else t.reshape(lead + t.shape[1:]) for t in out))

    def logp(self, theta: Tensor) -> Tensor:
        return self.sensitivities(theta, 0).logp

    def grad(self, theta: Tensor) -> Tensor:
        return self.sensitivities(theta, 1).grad

    def logp_and_grad(self, theta: Tensor) -> tuple[Tensor, Tensor]:
        out = self.sensitivities(theta, 1)
        return out.logp, out.grad

    def metric(self, theta: Tensor) -> Tensor:
        """G without jitter (the samplers add theirs)."""
        return self.sensitivities(theta, 1).metric

    def manifold_state(self, theta: Tensor) -> ManifoldState:
        """logp, grad, G and the dense dG cache from one order-2 call."""
        return ManifoldState(*self.sensitivities(theta, 2))

    def dg_cache(self, theta: Tensor) -> Tensor:
        """Dense metric jacobian (..., 3, 3, 3), ``[d] = dG/dtheta_d``."""
        return self.sensitivities(theta, 2).dmetric

    def _cache(self, theta: Tensor, cache) -> Tensor:
        return self.dg_cache(theta) if cache is None else cache

    def dg_bilinear(self, theta, u, v, *, cache=None):
        return torch.einsum("...dab,...a,...b->...d", self._cache(theta, cache), u, v)

    def dg_trace(self, theta, m, *, cache=None):
        return torch.einsum("...dab,...ba->...d", self._cache(theta, cache), m)

    def dg_dotted(self, theta, m, *, cache=None):
        return torch.einsum("...ia,...eab,...be->...i", m, self._cache(theta, cache), m)

    def iwls_proposal(self, theta):
        raise NotImplementedError("IWLS is a logistic-regression sampler")
