"""HMC with a constant dense preconditioner (constant-metric RMHMC).

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/phmc.py``.  The LGC
latent-field sampler of the reference is RMHMC whose Fisher metric is frozen
at the prior mean (``LGC_RMHMC_LV.m:95-101``): the generalized leapfrog
becomes a plain leapfrog with a constant dense mass matrix G, momentum
~ N(0, G), position updates through G^{-1}, and the log-det / trace terms
cancel (``:154-196``).  Supply any (chol(G), G^{-1}) pair: the identity
recovers standard HMC, ``LGCModel.metric_chol`` / ``metric_inv`` the
reference LGC sampler (L = 30, eps = 0.1, ``:32-33``).

The two dense ops per leapfrog step are (C, D) x (D, D) GEMMs (cuBLAS).
The operators may be row-sharded over ranks (``collectives.RowShards``, from
``LGCModel.with_sharding``): the products go through ``collectives.matmul``
(partial products + all-reduce) and ``matmul_t`` (the momentum's columns,
gathered), which are one ``torch.matmul`` on a plain tensor.
``trajectory_precision``: "highest" (default) keeps everything in full fp32;
"high" and "default" allow TF32 in every matmul inside the leapfrog only
(``_precision.tf32_matmuls``, which also covers the model's gradient).  The
endpoint ``logp`` and kinetic terms always run in full fp32, so reduced
trajectory precision can move the acceptance rate, never the stationary
distribution.  On a TPU the JAX package measured acceptance
collapsing (0.958 -> 0.016) with one bf16 pass at LGC's D = 4096.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch._precision import tf32_matmuls
from riemannhamiltonianmontecarlo_tpu_torch.parallel.collectives import RowShards, matmul, matmul_t
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept, model_capturable, tree_where

PRECISIONS = ("highest", "high", "default")


@dataclasses.dataclass(frozen=True)
class PHMCConfig:
    step_size: float = 0.1  # LGC_RMHMC_LV.m:33
    num_leapfrog: int = 30  # LGC_RMHMC_LV.m:32
    randomize_length: bool = True
    random_direction: bool = True  # LGC_RMHMC_LV.m:144
    trajectory_precision: str = "highest"  # highest | high | default (TF32 inside the leapfrog)


class PHMCState(NamedTuple):
    position: Tensor  # (C, D)
    logp: Tensor  # (C,)


class PHMCNoise(NamedTuple):
    """All the randomness of one transition (the JAX step's four draws)."""

    z: Tensor  # (C, D) N(0, 1): momentum p0 = z @ chol(G)^T
    u_len: Tensor  # (C,) U[0, 1): trajectory length ceil(u_len * L)
    u_dir: Tensor  # (C,) U[0, 1): direction +1 where u_dir < 0.5
    u_acc: Tensor  # (C,) U[0, 1)


def draw_noise(generator: torch.Generator, position: Tensor) -> PHMCNoise:
    c = position.shape[0]
    kw = dict(generator=generator, dtype=position.dtype, device=position.device)
    return PHMCNoise(torch.randn(position.shape, **kw), torch.rand((c,), **kw),
                     torch.rand((c,), **kw), torch.rand((c,), **kw))


def build(model, mass_chol: Tensor | RowShards, mass_inv: Tensor | RowShards, config: PHMCConfig = PHMCConfig()) -> Kernel:
    """``mass_chol``: lower Cholesky of G (D, D); ``mass_inv``: G^{-1}; each
    whole or this rank's rows."""
    if config.trajectory_precision not in PRECISIONS:
        raise ValueError(f"trajectory_precision must be one of {PRECISIONS}, got {config.trajectory_precision!r}")
    eps = config.step_size
    max_steps = config.num_leapfrog
    exact = config.trajectory_precision == "highest"

    def init(position: Tensor) -> PHMCState:
        return PHMCState(position, model.logp(position))

    def kinetic(p: Tensor) -> Tensor:
        return 0.5 * torch.sum(p * matmul(p, mass_inv), dim=-1)

    def transition(state: PHMCState, noise: PHMCNoise) -> tuple[PHMCState, Info]:
        c = state.position.shape[0]
        p0 = matmul_t(noise.z, mass_chol)  # N(0, G)
        if config.randomize_length:
            n_steps = torch.ceil(noise.u_len * max_steps).to(torch.int32)
        else:
            n_steps = torch.full((c,), max_steps, dtype=torch.int32, device=p0.device)
        if config.random_direction:
            direction = torch.where(noise.u_dir < 0.5, 1.0, -1.0).to(p0.dtype)
        else:
            direction = torch.ones((c,), dtype=p0.dtype, device=p0.device)
        dt = (direction * eps)[:, None]

        logp0 = model.logp(state.position)  # endpoint: always exact
        w, p = state.position, p0
        with contextlib.nullcontext() if exact else tf32_matmuls():
            _, g = model.logp_and_grad(w)
            for i in range(max_steps):
                active = (i < n_steps)[:, None]
                p_half = p + 0.5 * dt * g
                w_new = w + dt * matmul(p_half, mass_inv)
                _, g_new = model.logp_and_grad(w_new)
                p_new = p_half + 0.5 * dt * g_new
                w = torch.where(active, w_new, w)
                p = torch.where(active, p_new, p)
                g = torch.where(active, g_new, g)

        logp_prop = model.logp(w)
        ratio = (logp_prop - kinetic(p)) - (logp0 - kinetic(p0))
        divergent = ~(torch.isfinite(ratio) & torch.isfinite(w).all(dim=-1))
        accept, accept_prob = metropolis_accept(noise.u_acc, ratio, divergent)
        new_state = tree_where(accept, PHMCState(w, logp_prop), state)
        return new_state, Info(accept_prob, accept, divergent)

    def step(generator: torch.Generator, state: PHMCState) -> tuple[PHMCState, Info]:
        return transition(state, draw_noise(generator, state.position))

    return Kernel(init, step, transition, draw_noise, capturable=model_capturable(model))
