"""Metropolis-adjusted Langevin algorithm (MALA).

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/mala.py``, with the
same contract (``MCMC/BLR_MALA.m``):

* proposal mean ``w + eps/(2 s) * grad log pi(w)``, covariance ``(eps/s) I``;
* MH correction with both asymmetric proposal densities;
* transient scaling ``s = k sqrt(D)`` during burn-in, stationary
  ``s = D^(1/3)`` afterwards: build one kernel per phase (``transient=True``
  for warmup) and pass the warmup kernel to ``parallel.run(...,
  warmup_kernel=...)``.

``step_size`` may be a 0-dim tensor (dual-averaging adaptation): the
square root is ``** 0.5``, which keeps a tensor on the device and a float a
float.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept, model_capturable, tree_where


@dataclasses.dataclass(frozen=True)
class MALAConfig:
    step_size: float | Tensor = 0.1  # per-dataset switch block, e.g. BLR_MALA.m:35
    transient: bool = False  # True -> scaling k sqrt(D); False -> D^(1/3)
    # Transient-phase multiplier on sqrt(D): 1 for most datasets
    # (BLR_MALA.m:36), 2 for ripley (BLR_MALA.m:167).
    transient_factor: float = 1.0

    def scaling(self, dim: int) -> float:
        if self.transient:
            return self.transient_factor * dim**0.5
        return dim ** (1.0 / 3.0)


class MALAState(NamedTuple):
    position: Tensor  # (C, D)
    logp: Tensor  # (C,)
    grad: Tensor  # (C, D)


class MALANoise(NamedTuple):
    """All the randomness of one transition (the JAX step's two draws)."""

    eps: Tensor  # (C, D) N(0, 1) proposal noise
    u_acc: Tensor  # (C,) U[0, 1)


def draw_noise(generator: torch.Generator, position: Tensor) -> MALANoise:
    kw = dict(generator=generator, dtype=position.dtype, device=position.device)
    return MALANoise(torch.randn(position.shape, **kw), torch.rand(position.shape[:1], **kw))


def build(model, config: MALAConfig = MALAConfig()) -> Kernel:
    def init(position: Tensor) -> MALAState:
        logp, grad = model.logp_and_grad(position)
        return MALAState(position, logp, grad)

    def transition(state: MALAState, noise: MALANoise) -> tuple[MALAState, Info]:
        s = config.scaling(state.position.shape[-1])
        drift = config.step_size / (2.0 * s)
        var = config.step_size / s

        mean_fwd = state.position + drift * state.grad
        w_new = mean_fwd + var**0.5 * noise.eps

        logp_new, grad_new = model.logp_and_grad(w_new)
        mean_rev = w_new + drift * grad_new

        # log q densities up to the shared normalizing constant.
        log_q_fwd = -0.5 * torch.sum((w_new - mean_fwd) ** 2, dim=-1) / var
        log_q_rev = -0.5 * torch.sum((state.position - mean_rev) ** 2, dim=-1) / var

        ratio = logp_new + log_q_rev - state.logp - log_q_fwd
        divergent = ~torch.isfinite(ratio)
        accept, accept_prob = metropolis_accept(noise.u_acc, ratio, divergent)
        new_state = tree_where(accept, MALAState(w_new, logp_new, grad_new), state)
        return new_state, Info(accept_prob, accept, divergent)

    def step(generator: torch.Generator, state: MALAState) -> tuple[MALAState, Info]:
        return transition(state, draw_noise(generator, state.position))

    return Kernel(init, step, transition, draw_noise, capturable=model_capturable(model))
