"""Manifold MALA with a constant dense metric (preconditioned MALA).

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/pmala.py`` (its default
path).  The reference's LGC latent-field mMALA freezes the Fisher metric at
the prior mean before the sampling loop (``LGC_mMALA_LV.m:85-92``), and each
iteration is a preconditioned Langevin proposal: mean = x + (eps/2) G^{-1}
grad, covariance eps G^{-1} (``:115-121``; StepSize scales the variance),
accepted with both proposal densities, whose log-dets cancel (``:120,129``).

Supply (chol(G), G^{-1}) as for ``phmc``; identity matrices recover plain
MALA.  The triangular inverse L^{-1} is built once with
``torch.linalg.solve_triangular``, so each step's noise is one (C, D) x
(D, D) GEMM: z @ L^{-1} has covariance (L L^T)^{-1} = G^{-1}.

The operators may be row-sharded over ranks (``collectives.RowShards``, from
``LGCModel.with_sharding``): every product is then a partial product and an
all-reduce (``collectives.matmul``), and L^{-1} is built once from the whole
L, gathered at build, of which each rank keeps its rows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.parallel.collectives import RowShards, gather_rows, matmul
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept, tree_where


@dataclasses.dataclass(frozen=True)
class PMALAConfig:
    # Variance-scale step: cov = step_size * G^{-1} (LGC_mMALA_LV.m:34,121).
    step_size: float = 0.07  # LGC_mMALA_LV.m:34


class PMALAState(NamedTuple):
    position: Tensor  # (C, D)
    logp: Tensor  # (C,)
    grad: Tensor  # (C, D) cached grad log-posterior at position


class PMALANoise(NamedTuple):
    """All the randomness of one transition (the JAX step's two draws)."""

    z: Tensor  # (C, D) N(0, 1): proposal noise sqrt(eps) z @ L^{-1}
    u_acc: Tensor  # (C,) U[0, 1)


def draw_noise(generator: torch.Generator, position: Tensor) -> PMALANoise:
    kw = dict(generator=generator, dtype=position.dtype, device=position.device)
    return PMALANoise(torch.randn(position.shape, **kw), torch.rand(position.shape[:1], **kw))


def build(model, mass_chol: Tensor | RowShards, mass_inv: Tensor | RowShards,
          config: PMALAConfig = PMALAConfig()) -> Kernel:
    """``mass_chol``: lower Cholesky L of the constant metric G (D, D);
    ``mass_inv``: G^{-1}; each whole or this rank's rows.  One
    ``logp_and_grad`` per step: the reverse drift reuses the proposal's
    gradient, which the next step inherits on accept."""
    eps = config.step_size
    half = 0.5 * eps
    sqrt_eps = eps**0.5
    whole = mass_chol if isinstance(mass_chol, Tensor) else gather_rows(mass_chol)
    eye = torch.eye(whole.shape[0], dtype=whole.dtype, device=whole.device)
    inv_chol = torch.linalg.solve_triangular(whole, eye, upper=False)
    if isinstance(mass_chol, RowShards):
        inv_chol = RowShards.of(inv_chol, mass_chol.lo, mass_chol.hi, mass_chol.group)
    del whole, eye

    def quad(delta: Tensor) -> Tensor:
        """delta^T G delta via the factor: ||delta @ L||^2."""
        y = matmul(delta, mass_chol)
        return torch.sum(y * y, dim=-1)

    def drift(position: Tensor, grad: Tensor) -> Tensor:
        return position + half * matmul(grad, mass_inv)

    def init(position: Tensor) -> PMALAState:
        logp, grad = model.logp_and_grad(position)
        return PMALAState(position, logp, grad)

    def transition(state: PMALAState, noise: PMALANoise) -> tuple[PMALAState, Info]:
        mean_fwd = drift(state.position, state.grad)
        x_prop = mean_fwd + sqrt_eps * matmul(noise.z, inv_chol)

        logp_prop, grad_prop = model.logp_and_grad(x_prop)
        mean_rev = drift(x_prop, grad_prop)
        log_q_fwd = -(0.5 / eps) * quad(x_prop - mean_fwd)
        log_q_rev = -(0.5 / eps) * quad(state.position - mean_rev)
        ratio = (logp_prop + log_q_rev) - (state.logp + log_q_fwd)

        divergent = ~(torch.isfinite(ratio) & torch.isfinite(x_prop).all(dim=-1))
        accept, accept_prob = metropolis_accept(noise.u_acc, ratio, divergent)
        new_state = tree_where(accept, PMALAState(x_prop, logp_prop, grad_prop), state)
        return new_state, Info(accept_prob, accept, divergent)

    def step(generator: torch.Generator, state: PMALAState) -> tuple[PMALAState, Info]:
        return transition(state, draw_noise(generator, state.position))

    return Kernel(init, step, transition, draw_noise)
