"""Standard HMC with identity mass and randomized trajectory length.

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/hmc.py``, with the same
statistical contract (``code/hmc.py:12-99``):

* identity mass matrix, momentum ~ N(0, I);
* per-iteration trajectory length ``ceil(U * L)`` (L = 100, eps = 0.14 by
  default);
* explicit leapfrog with the model gradient, MH accept on the Hamiltonian
  difference, a non-finite trajectory masked to a per-chain rejection.

Every chain runs the maximum L leapfrog steps under a per-chain active
mask; there is no early exit.  The gradient at the end of one leapfrog step
is carried into the next, so each step takes one gradient.

``step_size`` may be a 0-dim tensor (dual-averaging adaptation); all
arithmetic on it stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept, tree_where


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    step_size: float | Tensor = 0.14  # reference default, code/hmc.py:12
    num_leapfrog: int = 100  # reference default, code/hmc.py:12
    randomize_length: bool = True  # ceil(U * L) steps per chain, code/hmc.py:48


class HMCState(NamedTuple):
    position: Tensor  # (C, D)
    logp: Tensor  # (C,)


class HMCNoise(NamedTuple):
    """All the randomness of one transition (the JAX step's three draws)."""

    p0: Tensor  # (C, D) N(0, 1) momentum
    u_len: Tensor  # (C,) U[0, 1): trajectory length ceil(u_len * L)
    u_acc: Tensor  # (C,) U[0, 1): MH accept test ratio > log(u_acc)


def draw_noise(generator: torch.Generator, position: Tensor) -> HMCNoise:
    c, d = position.shape
    kw = dict(generator=generator, dtype=position.dtype, device=position.device)
    return HMCNoise(torch.randn((c, d), **kw), torch.rand((c,), **kw), torch.rand((c,), **kw))


def build(model, config: HMCConfig = HMCConfig()) -> Kernel:
    eps = config.step_size
    max_steps = config.num_leapfrog

    def init(position: Tensor) -> HMCState:
        return HMCState(position, model.logp(position))

    def transition(state: HMCState, noise: HMCNoise) -> tuple[HMCState, Info]:
        c = state.position.shape[0]
        p0 = noise.p0
        if config.randomize_length:
            n_steps = torch.ceil(noise.u_len * max_steps).to(torch.int32)  # in {1..L}
        else:
            n_steps = torch.full((c,), max_steps, dtype=torch.int32, device=p0.device)

        w, p = state.position, p0
        g = model.grad(w)
        for i in range(max_steps):
            active = (i < n_steps)[:, None]
            p_half = p + 0.5 * eps * g
            w_new = w + eps * p_half
            g_new = model.grad(w_new)
            p_new = p_half + 0.5 * eps * g_new
            w = torch.where(active, w_new, w)
            p = torch.where(active, p_new, p)
            g = torch.where(active, g_new, g)

        logp_prop = model.logp(w)
        h_prop = -logp_prop + 0.5 * torch.sum(p * p, dim=-1)
        h_cur = -state.logp + 0.5 * torch.sum(p0 * p0, dim=-1)
        ratio = h_cur - h_prop

        divergent = ~(
            torch.isfinite(ratio) & torch.isfinite(w).all(dim=-1) & torch.isfinite(p).all(dim=-1)
        )
        accept, accept_prob = metropolis_accept(noise.u_acc, ratio, divergent)
        new_state = tree_where(accept, HMCState(w, logp_prop), state)
        return new_state, Info(accept_prob, accept, divergent)

    def step(generator: torch.Generator, state: HMCState) -> tuple[HMCState, Info]:
        return transition(state, draw_noise(generator, state.position))

    return Kernel(init, step, transition, draw_noise)
