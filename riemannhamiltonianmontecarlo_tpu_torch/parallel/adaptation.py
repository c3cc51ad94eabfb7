"""Dual-averaging step-size adaptation on the pooled acceptance of all chains.

Port of ``riemannhamiltonianmontecarlo_tpu/parallel/adaptation.py``: Nesterov
dual averaging (Hoffman & Gelman 2014, sec 3.2) driven by the mean
acceptance probability over every chain -- thousands of chains give a
near-noiseless per-step estimate, so the step size settles in tens of
iterations.  Divergences are not looked at, as in the JAX package.

The wrapped kernel is rebuilt each step with the current step size via
``dataclasses.replace(config, step_size=eps)``, where ``eps`` is a 0-dim
tensor on the chains' device: the samplers do their arithmetic with it on
the device, so an adaptive step never waits for the host.  After warmup
the step size freezes at the averaged iterate ``exp(log_eps_avg)``;
``frozen_step_size`` is the one place it becomes a Python float.

The pooled acceptance is ``collectives.cross_chain_mean`` over the mesh's
chain group, so with chains split over ranks every rank adapts the same step
size (a plain mean over the chain axis without a mesh).  The wrapped kernel
keeps the sampler's ``transition`` / ``draw_noise`` split, so the runner can
split its chains like any other.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.parallel.collectives import cross_chain_mean
from riemannhamiltonianmontecarlo_tpu_torch.parallel.mesh import CHAIN_AXIS, Mesh
from riemannhamiltonianmontecarlo_tpu_torch.parallel.runner import run
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel


class DualAveragingState(NamedTuple):
    log_eps: Tensor  # () float32
    log_eps_avg: Tensor  # () float32
    h_bar: Tensor  # () float32
    mu: Tensor  # () float32
    t: Tensor  # () int32


def da_init(eps0: float, device: str | torch.device = "cuda") -> DualAveragingState:
    def scalar(value: float) -> Tensor:
        return torch.tensor(value, dtype=torch.float32, device=device)

    return DualAveragingState(
        log_eps=torch.log(scalar(eps0)),
        log_eps_avg=torch.log(scalar(eps0)),
        h_bar=scalar(0.0),
        mu=torch.log(10.0 * scalar(eps0)),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )


def da_update(
    state: DualAveragingState,
    accept_rate: Tensor,
    target: float,
    *,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    t = state.t + 1
    tf = t.to(torch.float32)
    eta_h = 1.0 / (tf + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_rate)
    log_eps = state.mu - torch.sqrt(tf) / gamma * h_bar
    eta = tf**-kappa
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_bar, state.mu, t)


class AdaptiveState(NamedTuple):
    inner: Any
    da: DualAveragingState

    @property
    def position(self) -> Tensor:  # runner collection passthrough
        return self.inner.position


@dataclasses.dataclass(frozen=True)
class AdaptationConfig:
    target_accept: float = 0.8
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75


def adaptive(
    build_fn: Callable[..., Kernel],
    model,
    config,
    adapt: AdaptationConfig = AdaptationConfig(),
    mesh: Mesh | None = None,
) -> Kernel:
    """Wrap a step-size-bearing kernel with dual-averaging warmup.

    ``build_fn(model, config)`` must be a sampler ``build`` whose config
    carries ``step_size`` (hmc / rmhmc / mala / mmala).  With a ``mesh`` the
    acceptance is pooled over the chains of every rank.
    """
    group = None if mesh is None else mesh.group(CHAIN_AXIS)
    draw_noise = build_fn(model, config).draw_noise

    def init(position: Tensor) -> AdaptiveState:
        inner = build_fn(model, config).init(position)
        return AdaptiveState(inner, da_init(config.step_size, position.device))

    def transition(state: AdaptiveState, noise) -> tuple[AdaptiveState, Info]:
        eps = torch.exp(state.da.log_eps)
        kernel = build_fn(model, dataclasses.replace(config, step_size=eps))
        inner, info = kernel.transition(state.inner, noise)
        da = da_update(
            state.da,
            cross_chain_mean(info.accept_prob, group),
            adapt.target_accept,
            gamma=adapt.gamma,
            t0=adapt.t0,
            kappa=adapt.kappa,
        )
        return AdaptiveState(inner, da), info

    def step(generator: torch.Generator, state: AdaptiveState) -> tuple[AdaptiveState, Info]:
        return transition(state, draw_noise(generator, state.position))

    return Kernel(init, step, transition, draw_noise)


def frozen_step_size(state: AdaptiveState) -> float:
    """The dual-averaged step size after warmup (host scalar)."""
    return float(torch.exp(state.da.log_eps_avg))


def run_adaptive(
    build_fn: Callable[..., Kernel],
    model,
    config,
    generator: torch.Generator,
    init_position: Tensor,
    *,
    num_samples: int,
    warmup: int,
    adapt: AdaptationConfig = AdaptationConfig(),
    mesh: Mesh | None = None,
    **run_kwargs,
):
    """Dual-averaging warmup, then sampling at the frozen step size.

    Returns (RunResult, eps) where eps is the adapted step size.
    """
    warm = run(
        adaptive(build_fn, model, config, adapt, mesh),
        generator,
        init_position,
        num_samples=warmup,
        collect=False,
        mesh=mesh,
    )
    eps = frozen_step_size(warm.final_state)
    kernel = build_fn(model, dataclasses.replace(config, step_size=eps))
    res = run(kernel, generator, None, num_samples=num_samples, init_state=warm.final_state.inner, mesh=mesh,
              **run_kwargs)
    return res, eps
