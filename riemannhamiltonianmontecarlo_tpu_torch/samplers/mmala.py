"""Manifold MALA (mMALA) and simplified mMALA.

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/mmala.py``, with the
same contract (``MCMC/BLR_mMALA.m``, ``MCMC/BLR_mMALA_Simp.m``):

* drift mean::

      mu(w) = w + eps/2 * G^{-1} grad
                - eps  * sum_d (G^{-1} dG_d G^{-1})[:, d]
                + eps/2 * G^{-1} [tr(G^{-1} dG_d)]_d

  (simplified mMALA keeps only the first term);
* proposal N(mu(w), eps G(w)^{-1}), sampled with the factor
  ``chol(G)^{-T}`` of ``G^{-1}`` (one factorization per geometry build);
* asymmetric MH correction with both proposal densities;
* the geometry of the current point lives in the state and is refreshed
  only on accept.

On a CUDA batch the factorization is K1 (``ops.cholesky``): once in
``init`` and once per transition, at the proposed point.  K1 returns a view
of chains-last storage; the unrolled triangular solves index into it.

``step_size`` may be a 0-dim tensor (dual-averaging adaptation): its square
root and log stay on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch import ops
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept, tree_where


@dataclasses.dataclass(frozen=True)
class MMALAConfig:
    step_size: float | Tensor = 1.0
    simplified: bool = False  # drop curvature terms (BLR_mMALA_Simp.m)
    jitter: float = 0.0


class MMALAState(NamedTuple):
    position: Tensor  # (C, D)
    logp: Tensor  # (C,)
    mean: Tensor  # (C, D) drift mean at the current position
    metric: Tensor  # (C, D, D) G(w)
    # (C, D, D) UPPER-triangular A with A A^T = G^{-1} (= chol(G)^{-T}), not a
    # lower Cholesky factor: every consumer is factor-agnostic.
    cov_factor: Tensor


class MMALANoise(NamedTuple):
    """All the randomness of one transition (the JAX step's two draws)."""

    eps: Tensor  # (C, D) N(0, 1): proposal noise sqrt(step) * cov_factor @ eps
    u_acc: Tensor  # (C,) U[0, 1)


def draw_noise(generator: torch.Generator, position: Tensor) -> MMALANoise:
    kw = dict(generator=generator, dtype=position.dtype, device=position.device)
    return MMALANoise(torch.randn(position.shape, **kw), torch.rand(position.shape[:1], **kw))


def build(model, config: MMALAConfig = MMALAConfig()) -> Kernel:
    eps = config.step_size
    log_eps = torch.log(eps) if isinstance(eps, Tensor) else math.log(eps)

    def geometry(w: Tensor):
        ms = model.manifold_state(w)
        g = ms.metric
        if config.jitter:
            g = g + config.jitter * torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
        # From L = chol(G): G^{-1} = L^{-T} L^{-1}, and L^{-T} is itself a
        # factor of G^{-1}, so the proposal covariance needs no second
        # factorization.  diag(L^{-T}) = 1 / diag(L) gives the half log-det.
        chol_g = ops.cholesky(g)
        eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device).expand(g.shape)
        linv = ops.solve_lower_triangular(chol_g, eye)
        cov_factor = linv.mT
        mean = w + 0.5 * eps * ops.cho_solve(chol_g, ms.grad)
        if not config.simplified:
            inv_g = torch.matmul(cov_factor, linv)
            second = model.dg_dotted(w, inv_g, cache=ms.cache)
            trace_vec = model.dg_trace(w, inv_g, cache=ms.cache)
            third = ops.cho_solve(chol_g, trace_vec)
            mean = mean - eps * second + 0.5 * eps * third
        return ms.logp, mean, g, cov_factor

    def log_q(mean: Tensor, x: Tensor, g: Tensor, cov_factor: Tensor) -> Tensor:
        """log N(x; mean, eps G^{-1}) up to the 2 pi constant."""
        delta = mean - x
        quad = torch.einsum("...a,...ab,...b->...", delta, g, delta) / eps
        d = x.shape[-1]
        half_logdet = torch.sum(torch.log(torch.diagonal(cov_factor, dim1=-2, dim2=-1)), dim=-1) + 0.5 * d * log_eps
        return -half_logdet - 0.5 * quad

    def init(position: Tensor) -> MMALAState:
        return MMALAState(position, *geometry(position))

    def transition(state: MMALAState, noise: MMALANoise) -> tuple[MMALAState, Info]:
        w_new = state.mean + ops.mvn_sample(state.cov_factor, noise.eps) * eps**0.5

        logp_new, mean_new, g_new, cov_factor_new = geometry(w_new)

        log_q_fwd = log_q(state.mean, w_new, state.metric, state.cov_factor)
        log_q_rev = log_q(mean_new, state.position, g_new, cov_factor_new)

        ratio = logp_new + log_q_rev - state.logp - log_q_fwd
        divergent = ~(torch.isfinite(ratio) & torch.isfinite(w_new).all(dim=-1))
        accept, accept_prob = metropolis_accept(noise.u_acc, ratio, divergent)
        new_state = tree_where(accept, MMALAState(w_new, logp_new, mean_new, g_new, cov_factor_new), state)
        return new_state, Info(accept_prob, accept, divergent)

    def step(generator: torch.Generator, state: MMALAState) -> tuple[MMALAState, Info]:
        return transition(state, draw_noise(generator, state.position))

    return Kernel(init, step, transition, draw_noise)
