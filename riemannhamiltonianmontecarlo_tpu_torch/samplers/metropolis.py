"""Component-wise adaptive random-walk Metropolis-Hastings.

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/metropolis.py``, with
the same contract (``code/metropolis.py:14-95``):

* one sweep = a Gaussian proposal on each coordinate in turn, each
  accepted or rejected on the full joint density;
* per-coordinate proposal SD, adapted every 100 iterations while
  ``iteration < adapt_until``: x1.2 if the window acceptance rate > 0.5,
  x0.8 if < 0.2.

The sweep is a Python loop over the D coordinates (each accept changes the
state the next coordinate sees).  The window counters and ``iteration``
are device tensors, so the adaptation pulse is a masked select, not a
branch on the host.  ``Info`` is reported at sweep level: ``accepted`` is
the float fraction of the D coordinate moves taken.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, model_capturable


@dataclasses.dataclass(frozen=True)
class AMHConfig:
    init_proposal_sd: float = 1.0  # code/metropolis.py:23
    adapt_interval: int = 100  # code/metropolis.py:66
    adapt_until: int = 5000  # reference BurnIn, code/metropolis.py:14
    grow: float = 1.2  # code/metropolis.py:76
    shrink: float = 0.8  # code/metropolis.py:78
    hi_rate: float = 0.5  # code/metropolis.py:75
    lo_rate: float = 0.2  # code/metropolis.py:77


class AMHState(NamedTuple):
    position: Tensor  # (C, D)
    logp: Tensor  # (C,)
    proposal_sd: Tensor  # (C, D)
    window_accepts: Tensor  # (C, D) accepted count since last adaptation pulse
    window_sweeps: Tensor  # () int32 sweeps since last adaptation pulse
    iteration: Tensor  # () int32 total sweeps done


class AMHNoise(NamedTuple):
    """All the randomness of one sweep, coordinate-major."""

    normal: Tensor  # (D, C) N(0, 1): proposal delta = normal * proposal_sd
    u_acc: Tensor  # (D, C) U[0, 1)


def draw_noise(generator: torch.Generator, position: Tensor) -> AMHNoise:
    shape = position.shape[::-1]
    kw = dict(generator=generator, dtype=position.dtype, device=position.device)
    return AMHNoise(torch.randn(shape, **kw), torch.rand(shape, **kw))


def build(model, config: AMHConfig = AMHConfig()) -> Kernel:
    def init(position: Tensor) -> AMHState:
        c, d = position.shape
        counter = torch.zeros((), dtype=torch.int32, device=position.device)
        return AMHState(
            position=position,
            logp=model.logp(position),
            proposal_sd=torch.full((c, d), config.init_proposal_sd, dtype=position.dtype, device=position.device),
            window_accepts=torch.zeros_like(position),
            window_sweeps=counter,
            iteration=counter,
        )

    def transition(state: AMHState, noise: AMHNoise) -> tuple[AMHState, Info]:
        c, d = state.position.shape
        eye = torch.eye(d, dtype=state.position.dtype, device=state.position.device)
        w, logp, acc_counts = state.position, state.logp, state.window_accepts
        acc_prob_sum = torch.zeros((c,), dtype=w.dtype, device=w.device)
        for coord in range(d):
            delta = noise.normal[coord] * state.proposal_sd[:, coord]
            w_new = w + delta[:, None] * eye[coord]
            logp_new = model.logp(w_new)
            ratio = logp_new - logp
            ok = torch.isfinite(ratio)
            accept = ok & (ratio > torch.log(noise.u_acc[coord]))
            w = torch.where(accept[:, None], w_new, w)
            logp = torch.where(accept, logp_new, logp)
            acc_counts = acc_counts + eye[coord] * accept[:, None]
            acc_prob_sum = acc_prob_sum + torch.where(ok, torch.exp(torch.clamp(ratio, max=0.0)), 0.0)

        sweeps = state.window_sweeps + 1
        iteration = state.iteration + 1
        # Fraction of coordinate moves taken this sweep (before window reset).
        frac_accepted = torch.sum(acc_counts - state.window_accepts, dim=-1) / d

        # Adaptation pulse (every adapt_interval sweeps while in burn-in,
        # code/metropolis.py:66-78; counters reset each window).
        pulse = (iteration % config.adapt_interval == 0) & (iteration < config.adapt_until)
        rate = acc_counts / torch.clamp(sweeps, min=1).to(acc_counts.dtype)
        factor = torch.where(
            rate > config.hi_rate,
            config.grow,
            torch.where(rate < config.lo_rate, config.shrink, 1.0),
        ).to(state.proposal_sd.dtype)
        sd = torch.where(pulse, state.proposal_sd * factor, state.proposal_sd)
        acc_counts = torch.where(pulse, torch.zeros_like(acc_counts), acc_counts)
        sweeps = torch.where(pulse, torch.zeros_like(sweeps), sweeps)

        new_state = AMHState(w, logp, sd, acc_counts, sweeps, iteration)
        divergent = torch.zeros((c,), dtype=torch.bool, device=w.device)
        return new_state, Info(acc_prob_sum / d, frac_accepted, divergent)

    def step(generator: torch.Generator, state: AMHState) -> tuple[AMHState, Info]:
        return transition(state, draw_noise(generator, state.position))

    return Kernel(init, step, transition, draw_noise, capturable=model_capturable(model))
