"""Two-block Gibbs sampler for stochastic volatility (RMHMC-within-Gibbs).

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/stochvol.py``, with the
same statistical contract (``Stoch_Vol/RM-HMC/StochVol_RMHMC.m``).  Each
sweep alternates

1. **latent block** x | theta: HMC with the constant tridiagonal metric
   G = AR(1)-precision + I/2 (``:152-185``), L = 50, eps = 5/50; the
   log-det terms cancel in the MH ratio.  The "hmc" comparator uses the
   identity mass, "mala" a Langevin proposal and "mmala" the tridiagonally
   preconditioned Langevin proposal;
2. **hyper block** theta | x: the generic kernel (``rmhmc``, ``hmc``,
   ``mala`` or ``mmala``) rebuilt each sweep on the conditional manifold
   ``StochVolModel.hyper_manifold(x)`` in (beta, log sigma, atanh phi).

The latent leapfrog runs the full L steps under a per-chain mask.  On a
CUDA batch the hyper block's D=3 factorizations go to the Hopper kernels
through ``ops``: RMHMC takes one K3 per geometry build (1 + L per sweep)
and one K2 per position fixed-point round (L x 5 per sweep); mMALA one K1
in ``init`` and one per proposal (2 per sweep, since the hyper kernel is
rebuilt and re-initialized every sweep).  The latent update of rmhmc, hmc
and mmala factors its tridiagonal metric once a sweep, on a card by the
scan kernel T1 (``ops.tridiag.cholesky``), and solves with it by parallel
cyclic reduction, on a card by the kernel T2 (``ops.tridiag.solve``, one
launch a call): once a latent leapfrog step and twice for the kinetic
energies under rmhmc and hmc (L + 2 a sweep), three times under mmala.  On
a CPU batch both are their plain twins.

The step is split as elsewhere in the port: ``transition(state, noise)`` is
pure and takes a ``StochVolNoise``; ``step(generator, state)`` draws it with
``draw_noise``, which reads only the state's shapes, so the chain split
(``parallel.chain_sliced``) can draw the noise of every chain.  The sweep
reads nothing back to the host, so on a card the runner replays it as one
CUDA graph (``Kernel.capturable``), hyper gradient and dG by ``torch.func``
included; the latent block's scan and solves are nodes of it.
Initialization per the reference: x = y, (beta, sigma, phi) = 0.5
(``StochVol_RMHMC.m:86-89``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.ops import tridiag
from riemannhamiltonianmontecarlo_tpu_torch.samplers import hmc as hmc_mod
from riemannhamiltonianmontecarlo_tpu_torch.samplers import mala as mala_mod
from riemannhamiltonianmontecarlo_tpu_torch.samplers import mmala as mmala_mod
from riemannhamiltonianmontecarlo_tpu_torch.samplers import rmhmc as rmhmc_mod
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, LatentResult, finish_latent, model_capturable

METHODS = ("rmhmc", "hmc", "mala", "mmala")


@dataclasses.dataclass(frozen=True)
class StochVolConfig:
    latent_num_leapfrog: int = 50  # StochVol_RMHMC.m:66
    latent_step_size: float = 0.1  # Dist/L = 5/50, :67-68
    hyper_num_leapfrog: int = 6  # :71
    hyper_step_size: float = 0.5  # HPDist/L = 3/6, :72-73
    hyper_num_fixed_point: int = 5  # :74
    hyper_jitter: float = 1e-6  # :258
    randomize_length: bool = True
    random_direction: bool = True
    # Comparator variants (paper Tables 8-9): "rmhmc" (StochVol_RMHMC.m),
    # "hmc" (identity mass both blocks, StochVol_HMC.m:57-67), "mala"
    # (StochVol_MALA.m:57-67), "mmala" (StochVol_mMALA.m:66-72; the latent
    # metric is constant in x, so the latent update is tridiagonally
    # preconditioned MALA).
    method: str = "rmhmc"


class StochVolState(NamedTuple):
    position: Tensor  # (C, 3) constrained (beta, sigma, phi) -- what is collected
    theta: Tensor  # (C, 3) transformed coords (beta, log sigma, atanh phi)
    x: Tensor  # (C, T) latent volatilities


class StochVolNoise(NamedTuple):
    """All the randomness of one sweep.

    The latent draws of the JAX step (``normal`` is the momentum of
    rmhmc / hmc or the proposal noise of mala / mmala; ``u_len`` and
    ``u_dir`` are used by rmhmc / hmc only), then the hyper kernel's own
    noise tuple (``RMHMCNoise``, ``HMCNoise``, ``MALANoise`` or ``MMALANoise``).
    """

    normal: Tensor  # (C, T) N(0, 1)
    u_len: Tensor  # (C,) U[0, 1): trajectory length ceil(u_len * L)
    u_dir: Tensor  # (C,) U[0, 1): direction +1 where u_dir < 0.5
    u_acc: Tensor  # (C,) U[0, 1): latent MH test
    hyper: Any


def latent_update(model, config: StochVolConfig, x: Tensor, theta: Tensor, noise: StochVolNoise) -> LatentResult:
    """One MH update of the latent block x | theta by ``config.method``."""
    eps = config.latent_step_size
    if config.method == "mala":
        # Langevin proposal on the latent conditional (StochVol_MALA.m).
        mean_fwd = x + 0.5 * eps * model.latent_grad(x, theta)
        x_new = mean_fwd + eps**0.5 * noise.normal
        mean_rev = x_new + 0.5 * eps * model.latent_grad(x_new, theta)
        log_q_fwd = -0.5 * torch.sum((x_new - mean_fwd) ** 2, dim=-1) / eps
        log_q_rev = -0.5 * torch.sum((x - mean_rev) ** 2, dim=-1) / eps
        ratio = model.latent_logp(x_new, theta) + log_q_rev - model.latent_logp(x, theta) - log_q_fwd
        return finish_latent(x, x_new, ratio, noise.u_acc)

    if config.method == "mmala":
        # Tridiagonally preconditioned MALA (StochVol_mMALA.m latents): G is
        # constant in x, so mean = x + eps/2 G^-1 grad, cov = eps G^-1, and
        # the log-dets cancel between the forward and reverse densities.
        diag, off = model.latent_metric(theta)
        chol = tridiag.cholesky(diag, off)

        def drift(xc: Tensor) -> Tensor:
            return xc + 0.5 * eps * tridiag.solve(diag, off, model.latent_grad(xc, theta))

        def quad(delta: Tensor) -> Tensor:
            return torch.sum(delta * tridiag.matvec(diag, off, delta), dim=-1)

        mean_fwd = drift(x)
        # G^-1 L z has covariance G^-1.
        x_new = mean_fwd + eps**0.5 * tridiag.solve(diag, off, tridiag.matvec_chol(chol, noise.normal))
        mean_rev = drift(x_new)
        log_q_fwd = -0.5 * quad(x_new - mean_fwd) / eps
        log_q_rev = -0.5 * quad(x - mean_rev) / eps
        ratio = model.latent_logp(x_new, theta) + log_q_rev - model.latent_logp(x, theta) - log_q_fwd
        return finish_latent(x, x_new, ratio, noise.u_acc)

    c = x.shape[0]
    if config.method == "rmhmc":
        diag, off = model.latent_metric(theta)
    else:  # "hmc": identity mass (StochVol_HMC.m)
        diag = torch.ones_like(x)
        off = x.new_zeros(x.shape[:-1] + (x.shape[-1] - 1,))
    chol = tridiag.cholesky(diag, off)
    p0 = tridiag.matvec_chol(chol, noise.normal)

    if config.randomize_length:
        n_steps = torch.ceil(noise.u_len * config.latent_num_leapfrog).to(torch.int32)
    else:
        n_steps = torch.full((c,), config.latent_num_leapfrog, dtype=torch.int32, device=x.device)
    if config.random_direction:
        direction = torch.where(noise.u_dir < 0.5, 1.0, -1.0).to(x.dtype)
    else:
        direction = torch.ones((c,), dtype=x.dtype, device=x.device)
    dt = (direction * eps)[:, None]

    logp0 = model.latent_logp(x, theta)
    xc, pc, gc = x, p0, model.latent_grad(x, theta)
    for i in range(config.latent_num_leapfrog):
        active = (i < n_steps)[:, None]
        p_half = pc + 0.5 * dt * gc
        x_new = xc + dt * tridiag.solve(diag, off, p_half)
        g_new = model.latent_grad(x_new, theta)
        p_new = p_half + 0.5 * dt * g_new
        xc = torch.where(active, x_new, xc)
        pc = torch.where(active, p_new, pc)
        gc = torch.where(active, g_new, gc)

    # Constant G within the update: the log-det cancels in the ratio.
    def kinetic(p: Tensor) -> Tensor:
        return 0.5 * torch.sum(p * tridiag.solve(diag, off, p), dim=-1)

    ratio = (model.latent_logp(xc, theta) - kinetic(pc)) - (logp0 - kinetic(p0))
    return finish_latent(x, xc, ratio, noise.u_acc)


def hyper_kernel(config: StochVolConfig, hyper_model) -> Kernel:
    """The hyper block's generic kernel on the conditional manifold, by method."""
    if config.method == "rmhmc":
        return rmhmc_mod.build(hyper_model, rmhmc_mod.RMHMCConfig(
            step_size=config.hyper_step_size,
            num_leapfrog=config.hyper_num_leapfrog,
            num_fixed_point=config.hyper_num_fixed_point,
            randomize_length=config.randomize_length,
            random_direction=config.random_direction,
            jitter=config.hyper_jitter,
        ))
    if config.method == "hmc":
        return hmc_mod.build(hyper_model, hmc_mod.HMCConfig(
            step_size=config.hyper_step_size,
            num_leapfrog=config.hyper_num_leapfrog,
            randomize_length=config.randomize_length,
        ))
    if config.method == "mala":
        return mala_mod.build(hyper_model, mala_mod.MALAConfig(step_size=config.hyper_step_size))
    if config.method == "mmala":
        return mmala_mod.build(hyper_model, mmala_mod.MMALAConfig(step_size=config.hyper_step_size, jitter=1e-6))
    raise ValueError(f"unknown stochvol method {config.method!r}; options: {METHODS}")


def _hyper_init(config: StochVolConfig, kernel: Kernel, hyper_model, theta: Tensor):
    """The hyper kernel's state at theta, as the JAX step builds it."""
    if config.method == "rmhmc":
        return rmhmc_mod.RMHMCState(theta, hyper_model.logp(theta))  # geometry rebuilt in the step
    if config.method == "hmc":
        return hmc_mod.HMCState(theta, hyper_model.logp(theta))
    return kernel.init(theta)


_HYPER_NOISE = {"rmhmc": rmhmc_mod.draw_noise, "hmc": hmc_mod.draw_noise,
                "mala": mala_mod.draw_noise, "mmala": mmala_mod.draw_noise}


def draw_noise(generator: torch.Generator, state: StochVolState, method: str) -> StochVolNoise:
    kw = dict(generator=generator, dtype=state.x.dtype, device=state.x.device)
    c = state.x.shape[0]
    return StochVolNoise(
        normal=torch.randn(state.x.shape, **kw),
        u_len=torch.rand((c,), **kw),
        u_dir=torch.rand((c,), **kw),
        u_acc=torch.rand((c,), **kw),
        hyper=_HYPER_NOISE[method](generator, state.theta),
    )


def build(model, config: StochVolConfig = StochVolConfig()) -> Kernel:
    if config.method not in METHODS:
        raise ValueError(f"unknown stochvol method {config.method!r}; options: {METHODS}")

    def init(position: Tensor) -> StochVolState:
        """position: (C, 3) constrained initial (beta, sigma, phi)."""
        c = position.shape[0]
        theta = model.unconstrain(position[:, 0], position[:, 1], position[:, 2])
        x = model.y.to(position.dtype).expand(c, model.num_obs).clone()
        return StochVolState(position, theta, x)

    def transition(state: StochVolState, noise: StochVolNoise) -> tuple[StochVolState, Info]:
        # Block 1: latents.
        lat = latent_update(model, config, state.x, state.theta, noise)

        # Block 2: hyperparameters via a generic kernel on the conditional
        # manifold model (method-selected comparator, Tables 8-9).
        hyper_model = model.hyper_manifold(lat.x)
        kernel = hyper_kernel(config, hyper_model)
        h_new, h_info = kernel.transition(_hyper_init(config, kernel, hyper_model, state.theta), noise.hyper)
        theta = h_new.position

        position = torch.stack(model.constrain(theta), dim=-1)
        # Sweep-level Info: accept_prob / accepted are the mean over the two
        # blocks (accepted in {0, 0.5, 1}); divergent is true if either
        # block diverged.
        dtype = lat.x.dtype
        info = Info(
            accept_prob=0.5 * (lat.accept_prob + h_info.accept_prob),
            accepted=0.5 * (lat.accepted.to(dtype) + h_info.accepted.to(dtype)),
            divergent=lat.divergent | h_info.divergent,
        )
        return StochVolState(position, theta, lat.x), info

    def noise(generator: torch.Generator, state: StochVolState) -> StochVolNoise:
        return draw_noise(generator, state, config.method)

    def step(generator: torch.Generator, state: StochVolState) -> tuple[StochVolState, Info]:
        return transition(state, noise(generator, state))

    return Kernel(init, step, transition, noise, noise_from_state=True, capturable=model_capturable(model))
