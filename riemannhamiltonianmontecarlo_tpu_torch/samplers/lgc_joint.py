"""Joint (hyperparameter, latent-field) sampler for the log-Gaussian Cox model.

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/lgc_joint.py``, with the
same statistical contract (``LGC_RMHMC_Paras_LV.m``).  Each sweep alternates

1. **hyper block** theta~ = (log sigma^2, log beta) | x: generalized-
   leapfrog RMHMC with L = 1, eps = 0.2, 3 position / 10 momentum
   fixed-point steps (``:41-44``) on the expected-Fisher + prior metric of
   ``models.lgc.LGCJointModel``, through the generic ``rmhmc`` kernel; or,
   for ``method="mmala"`` (``LGC_mMALA_Paras_LV.m:205-294``), full-curvature
   manifold MALA through the generic ``mmala`` kernel;
2. **latent block** x | theta: constant-metric leapfrog with
   G = Sigma^{-1} + diag(m exp(mu + diag Sigma)) re-evaluated at the
   *current* hyperparameters, L = 20, eps = 0.1 (``:46-47``); for mMALA the
   Langevin proposal preconditioned by the same G, eps = 0.07 (``:353-375``).

Every theta~ move costs dense (C, D, D) factorizations and GEMMs (library
calls, D = n^2 = 4096 at the reference size): batch a handful of chains.
The hyper kernel is rebuilt on ``model.hyper_manifold(x)`` and
re-initialized every sweep, and its (C, 2, 2) metric goes through ``ops``:
on a CUDA batch RMHMC takes K3 (factor, inverse and half log-determinant)
twice a sweep (``init`` and the geometry after its one leapfrog step) and
K2 (fused solve) once per
position fixed-point round, three times a sweep; mMALA takes K1 twice
(``init`` and the proposal) and no K2.

The step is split as elsewhere in the port: ``transition(state, noise)`` is
pure and takes a ``LGCJointNoise``; ``step(generator, state)`` draws it with
``draw_noise``, which reads only the state's shapes, so the chain split
(``parallel.chain_sliced``) can draw the noise of every chain.
The latent leapfrog runs the full L steps under a per-chain mask; a
factorization that fails (a proposed beta whose K is not PD in float32)
gives non-finite numbers and a masked reject, never an exception.  The
sweep takes the closed-form hyper geometry and reads nothing back to the
host, so on a card the runner replays it as one CUDA graph
(``Kernel.capturable``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch import ops
from riemannhamiltonianmontecarlo_tpu_torch.samplers import mmala as mmala_mod
from riemannhamiltonianmontecarlo_tpu_torch.samplers import rmhmc as rmhmc_mod
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, LatentResult, finish_latent, model_capturable

METHODS = ("rmhmc", "mmala")


@dataclasses.dataclass(frozen=True)
class LGCJointConfig:
    hyper_num_leapfrog: int = 1  # LGC_RMHMC_Paras_LV.m:41
    hyper_step_size: float = 0.2  # :42 (same value as LGC_mMALA_Paras_LV.m:42)
    hyper_num_fixed_point: int = 3  # :43 (position)
    hyper_num_fixed_point_momentum: int = 10  # :44
    latent_num_leapfrog: int = 20  # :46
    latent_step_size: float = 0.1  # :47 (mMALA: 0.07, LGC_mMALA_Paras_LV.m:43)
    randomize_length: bool = True
    random_direction: bool = True
    method: str = "rmhmc"  # "rmhmc" (LGC_RMHMC_Paras_LV.m) or "mmala" (LGC_mMALA_Paras_LV.m)
    # Initial latent field (D,); None = the prior mean mu (the reference
    # init).  theta | x is improper at x = mu exactly (the quadratic term
    # vanishes and -1/2 log|Sigma| is unbounded as sigma^2 -> 0), so
    # frozen-latent diagnostics must start from a realistic field.
    latent_init: Tensor | None = None


class LGCJointState(NamedTuple):
    position: Tensor  # (C, 2) constrained (sigma^2, beta) -- collected
    theta: Tensor  # (C, 2) log coords
    x: Tensor  # (C, D) latent field


class LGCJointNoise(NamedTuple):
    """All the randomness of one sweep.

    The hyper kernel's own noise (``RMHMCNoise`` or ``MMALANoise``), then the
    latent draws of the JAX step: ``z`` is the momentum's N(0, I) seed
    (rmhmc) or the proposal noise (mmala); ``u_len`` and ``u_dir`` are used
    by rmhmc only.
    """

    hyper: Any
    z: Tensor  # (C, D) N(0, 1)
    u_len: Tensor  # (C,) U[0, 1): trajectory length ceil(u_len * L)
    u_dir: Tensor  # (C,) U[0, 1): direction +1 where u_dir < 0.5
    u_acc: Tensor  # (C,) U[0, 1): latent MH test


def _matvec(a: Tensor, v: Tensor) -> Tensor:
    return torch.einsum("...ab,...b->...a", a, v)


def latent_update(model, config: LGCJointConfig, x: Tensor, theta: Tensor, noise: LGCJointNoise) -> LatentResult:
    """Constant-metric HMC on x | theta, to the maximum length under the ``active`` mask."""
    c = x.shape[0]
    sigma_inv, chol_g, g_inv = model.latent_mass(theta)
    p0 = _matvec(chol_g, noise.z)

    if config.randomize_length:
        n_steps = torch.ceil(noise.u_len * config.latent_num_leapfrog).to(torch.int32)
    else:
        n_steps = torch.full((c,), config.latent_num_leapfrog, dtype=torch.int32, device=x.device)
    if config.random_direction:
        direction = torch.where(noise.u_dir < 0.5, 1.0, -1.0).to(x.dtype)
    else:
        direction = torch.ones((c,), dtype=x.dtype, device=x.device)
    dt = (direction * config.latent_step_size)[:, None]

    logp0, grad0 = model.latent_logp_and_grad(x, sigma_inv)
    xc, pc, gc = x, p0, grad0
    for i in range(config.latent_num_leapfrog):
        active = (i < n_steps)[:, None]
        p_half = pc + 0.5 * dt * gc
        x_new = xc + dt * _matvec(g_inv, p_half)
        _, g_new = model.latent_logp_and_grad(x_new, sigma_inv)
        p_new = p_half + 0.5 * dt * g_new
        xc = torch.where(active, x_new, xc)
        pc = torch.where(active, p_new, pc)
        gc = torch.where(active, g_new, gc)

    def kinetic(p: Tensor) -> Tensor:
        return 0.5 * torch.sum(p * _matvec(g_inv, p), dim=-1)

    logp_prop, _ = model.latent_logp_and_grad(xc, sigma_inv)
    ratio = (logp_prop - kinetic(pc)) - (logp0 - kinetic(p0))
    return finish_latent(x, xc, ratio, noise.u_acc)


def latent_mmala_update(model, config: LGCJointConfig, x: Tensor, theta: Tensor, noise: LGCJointNoise) -> LatentResult:
    """Preconditioned MALA on x | theta (``LGC_mMALA_Paras_LV.m:353-375``).

    The latent metric is constant in x given theta, so the mMALA curvature
    terms vanish and the log-det parts of both proposal densities cancel in
    the MH ratio.
    """
    sigma_inv, chol_g, g_inv = model.latent_mass(theta)
    eps = config.latent_step_size

    def drift(xc: Tensor) -> tuple[Tensor, Tensor]:
        logp, grad = model.latent_logp_and_grad(xc, sigma_inv)
        return logp, xc + 0.5 * eps * _matvec(g_inv, grad)

    def quad(delta: Tensor) -> Tensor:
        t = torch.einsum("...ij,...i->...j", chol_g, delta)
        return torch.sum(t * t, dim=-1)

    logp0, mean_fwd = drift(x)
    # noise ~ N(0, G^{-1}): L^{-T} z with L = chol(G).
    step = ops.solve_upper_from_lower(chol_g, noise.z, method="library")
    x_new = mean_fwd + eps**0.5 * step
    logp_new, mean_rev = drift(x_new)
    log_q_fwd = -0.5 * quad(x_new - mean_fwd) / eps
    log_q_rev = -0.5 * quad(x - mean_rev) / eps
    return finish_latent(x, x_new, logp_new + log_q_rev - logp0 - log_q_fwd, noise.u_acc)


def hyper_kernel(config: LGCJointConfig, hyper_model) -> Kernel:
    """The hyper block's generic kernel on the conditional manifold, by method."""
    if config.method == "mmala":
        return mmala_mod.build(hyper_model, mmala_mod.MMALAConfig(step_size=config.hyper_step_size, jitter=1e-6))
    return rmhmc_mod.build(hyper_model, rmhmc_mod.RMHMCConfig(
        step_size=config.hyper_step_size,
        num_leapfrog=config.hyper_num_leapfrog,
        num_fixed_point=config.hyper_num_fixed_point,
        num_fixed_point_momentum=config.hyper_num_fixed_point_momentum,
        randomize_length=config.randomize_length,
        random_direction=config.random_direction,
        jitter=1e-6,
    ))


def draw_noise(generator: torch.Generator, state: LGCJointState, method: str) -> LGCJointNoise:
    kw = dict(generator=generator, dtype=state.x.dtype, device=state.x.device)
    c = state.x.shape[0]
    hyper = (mmala_mod.draw_noise if method == "mmala" else rmhmc_mod.draw_noise)(generator, state.theta)
    return LGCJointNoise(
        hyper=hyper,
        z=torch.randn(state.x.shape, **kw),
        u_len=torch.rand((c,), **kw),
        u_dir=torch.rand((c,), **kw),
        u_acc=torch.rand((c,), **kw),
    )


def build(model, config: LGCJointConfig = LGCJointConfig()) -> Kernel:
    if config.method not in METHODS:
        raise ValueError(f"unknown lgc_joint method {config.method!r}; options: {METHODS}")
    latent = latent_mmala_update if config.method == "mmala" else latent_update

    def init(position: Tensor) -> LGCJointState:
        """position: (C, 2) constrained initial (sigma^2, beta)."""
        c = position.shape[0]
        if config.latent_init is None:
            x0 = torch.full((model.dim,), model.mu, dtype=position.dtype, device=position.device)
        else:
            x0 = config.latent_init.to(device=position.device, dtype=position.dtype)
        return LGCJointState(position, torch.log(position), x0.expand(c, model.dim).clone())

    def transition(state: LGCJointState, noise: LGCJointNoise) -> tuple[LGCJointState, Info]:
        # Block 1: hyperparameters (reference order: theta first, :168).
        # init() computes the full fused geometry once and the step reuses
        # it through the state.
        kernel = hyper_kernel(config, model.hyper_manifold(state.x))
        h_new, h_info = kernel.transition(kernel.init(state.theta), noise.hyper)
        theta = h_new.position

        # Block 2: latents at the current hyperparameters.
        lat = latent(model, config, state.x, theta, noise)

        # Sweep-level Info: accept_prob / accepted are the mean over the two
        # blocks, divergent is true if either block diverged.
        dtype = lat.x.dtype
        info = Info(
            accept_prob=0.5 * (lat.accept_prob + h_info.accept_prob),
            accepted=0.5 * (lat.accepted.to(dtype) + h_info.accepted.to(dtype)),
            divergent=lat.divergent | h_info.divergent,
        )
        return LGCJointState(torch.exp(theta), theta, lat.x), info

    def noise(generator: torch.Generator, state: LGCJointState) -> LGCJointNoise:
        return draw_noise(generator, state, config.method)

    def step(generator: torch.Generator, state: LGCJointState) -> tuple[LGCJointState, Info]:
        return transition(state, noise(generator, state))

    return Kernel(init, step, transition, noise, noise_from_state=True, capturable=model_capturable(model))
