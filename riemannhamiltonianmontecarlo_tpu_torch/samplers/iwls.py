"""Iterated-weighted-least-squares MH sampler (Gamerman 1997).

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/iwls.py``, with the
same contract (``code/iwls.py:13-89`` / MATLAB ``MCMC/BLR_IWLS.m:190-240``):

* proposal = the Gaussian of one Newton/IWLS step at the current point
  (``model.iwls_proposal``), cached and refreshed only on accept;
* asymmetric MH correction with both proposal densities; the 1e-6 jitter
  on the covariance feeds both the log-det and the quadratic form.

On a CUDA batch the covariance factorization is K1 (``ops.cholesky``): once
in ``init`` and once per transition, at the proposed point.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch import ops
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept, model_capturable, tree_where


@dataclasses.dataclass(frozen=True)
class IWLSConfig:
    jitter: float = 1e-6  # code/iwls.py:64


class IWLSState(NamedTuple):
    position: Tensor  # (C, D)
    logp: Tensor  # (C,)
    mean: Tensor  # (C, D) IWLS proposal mean at the current position
    chol_cov: Tensor  # (C, D, D) lower Cholesky factor of the proposal covariance


class IWLSNoise(NamedTuple):
    """All the randomness of one transition (the JAX step's two draws)."""

    eps: Tensor  # (C, D) N(0, 1): proposal w' = mean + chol_cov @ eps
    u_acc: Tensor  # (C,) U[0, 1)


def draw_noise(generator: torch.Generator, position: Tensor) -> IWLSNoise:
    kw = dict(generator=generator, dtype=position.dtype, device=position.device)
    return IWLSNoise(torch.randn(position.shape, **kw), torch.rand(position.shape[:1], **kw))


def build(model, config: IWLSConfig = IWLSConfig()) -> Kernel:
    def proposal(w: Tensor) -> tuple[Tensor, Tensor]:
        mean, cov = model.iwls_proposal(w)
        cov = cov + config.jitter * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        return mean, ops.cholesky(cov)

    def log_q(mean: Tensor, chol_cov: Tensor, x: Tensor) -> Tensor:
        y = ops.solve_lower_triangular(chol_cov, x - mean)
        half_logdet = torch.sum(torch.log(torch.diagonal(chol_cov, dim1=-2, dim2=-1)), dim=-1)
        return -half_logdet - 0.5 * torch.sum(y * y, dim=-1)

    def init(position: Tensor) -> IWLSState:
        return IWLSState(position, model.logp(position), *proposal(position))

    def transition(state: IWLSState, noise: IWLSNoise) -> tuple[IWLSState, Info]:
        w_new = state.mean + ops.mvn_sample(state.chol_cov, noise.eps)
        logp_new = model.logp(w_new)
        mean_new, chol_new = proposal(w_new)

        log_q_fwd = log_q(state.mean, state.chol_cov, w_new)
        log_q_rev = log_q(mean_new, chol_new, state.position)

        ratio = logp_new + log_q_rev - state.logp - log_q_fwd
        divergent = ~(torch.isfinite(ratio) & torch.isfinite(w_new).all(dim=-1))
        accept, accept_prob = metropolis_accept(noise.u_acc, ratio, divergent)
        new_state = tree_where(accept, IWLSState(w_new, logp_new, mean_new, chol_new), state)
        return new_state, Info(accept_prob, accept, divergent)

    def step(generator: torch.Generator, state: IWLSState) -> tuple[IWLSState, Info]:
        return transition(state, draw_noise(generator, state.position))

    return Kernel(init, step, transition, draw_noise, capturable=model_capturable(model))
