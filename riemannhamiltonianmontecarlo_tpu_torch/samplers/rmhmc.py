"""Riemann-manifold HMC with the generalized (implicit) leapfrog.

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/rmhmc.py``, with the
same statistical contract (``code/rmhmc.py:13-201`` / MATLAB
``BLR_RMHMC.m:222-376``):

* momentum ~ N(0, G(w)) (the MATLAB contract, see ``ops.mvn_sample``);
* randomized trajectory length ``ceil(U * L)`` (0 when U == 0) and a
  fair-coin direction sign;
* generalized leapfrog: fixed-point iteration on the implicit momentum
  half-step and on the implicit position step with G recomputed inside the
  loop, then an explicit momentum half-step with fresh geometry;
* H = -log pi(w) + 1/2 log|G| + 1/2 p^T G^{-1} p; MH accept on dH;
* the Student-t momentum variant (``MCMC/BLR_RMHMC_StudentT.m``).

Fixed iteration counts are Python loops of static length; per-chain
trajectory lengths run the max-L loop under a lockstep active mask, and a
non-finite step masks to a rejection.  There is no data-dependent control
flow, so a step keeps the same sequence of launches every time.

The step is split in two: ``transition(state, noise)`` is pure and takes
all its randomness in an ``RMHMCNoise``; ``step(generator, state)`` draws
that noise and calls it.  On a CUDA batch the factorizations go to the
Hopper kernels through ``ops`` (``config.linalg`` passes ``method``): one
K3 (factor, inverse and half log-determinant, ``ops.chol_inv_logdet``) per
geometry build.  The two fixed points are the model's
``position_fixed_point`` / ``momentum_fixed_point`` where it has them (a
logistic regression: on a whole model's CUDA batch the kernels K4 / K5, one
launch a fixed point and one a half-step, unless ``config.linalg`` is
``"unrolled"`` or ``"library"``); for every other model they are the loops
of ``ops.logreg_fixed_point`` (``*_plain``), one K2 (fused solve) per
position round on a card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch import ops
from riemannhamiltonianmontecarlo_tpu_torch.ops import logreg_fixed_point
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept, model_capturable, tree_where


@dataclasses.dataclass(frozen=True)
class RMHMCConfig:
    step_size: float = 0.5  # code/rmhmc.py:13
    num_leapfrog: int = 6  # code/rmhmc.py:13
    num_fixed_point: int = 4  # NumOfNewtonSteps, code/rmhmc.py:13
    randomize_length: bool = True  # ceil(U*L), code/rmhmc.py:89
    random_direction: bool = True  # time-reversal sign, code/rmhmc.py:90-93
    jitter: float = 0.0  # optional diagonal jitter on G for f32 stability
    # Heavy-tailed momentum: t_1(0, G), kinetic ((1+D)/2) log(1 + p^T G^-1 p).
    student_t: bool = False
    # ops.linalg method for the factorizations: None (auto), "unrolled",
    # "library", "kernel".
    linalg: str | None = None
    # Separate fixed-point count for the momentum update (None = num_fixed_point).
    num_fixed_point_momentum: int | None = None


class RMHMCState(NamedTuple):
    position: Tensor  # (C, D)
    logp: Tensor  # (C,)
    # Cached _Geometry at ``position`` (None = recompute lazily).  The
    # geometry of the accepted point is always known at the end of a step,
    # so steady-state sampling never rebuilds it at the current point.
    geo: object = None


class _Geometry(NamedTuple):
    """Carried per-position manifold quantities (all chain-batched)."""

    logp: Tensor
    grad: Tensor
    metric: Tensor
    cache: object  # model dG cache
    chol: Tensor
    inv: Tensor
    half_logdet: Tensor


class RMHMCNoise(NamedTuple):
    """All the randomness of one transition (the JAX step's five draws)."""

    eps: Tensor  # (C, D) N(0, 1): momentum p0 = chol(G) @ eps
    chi_normal: Tensor  # (C,) N(0, 1): Student-t scale chi^2 = chi_normal^2
    u_len: Tensor  # (C,) U[0, 1): trajectory length ceil(u_len * L)
    u_dir: Tensor  # (C,) U[0, 1): direction +1 where u_dir < 0.5, else -1
    u_acc: Tensor  # (C,) U[0, 1): MH accept test ratio > log(u_acc)


def draw_noise(generator: torch.Generator, position: Tensor) -> RMHMCNoise:
    c, d = position.shape
    kw = dict(generator=generator, dtype=position.dtype, device=position.device)
    return RMHMCNoise(
        eps=torch.randn((c, d), **kw),
        chi_normal=torch.randn((c,), **kw),
        u_len=torch.rand((c,), **kw),
        u_dir=torch.rand((c,), **kw),
        u_acc=torch.rand((c,), **kw),
    )


def build(model, config: RMHMCConfig = RMHMCConfig()) -> Kernel:
    eps = config.step_size
    max_steps = config.num_leapfrog
    n_fp = config.num_fixed_point
    n_fp_mom = (
        config.num_fixed_point
        if config.num_fixed_point_momentum is None
        else config.num_fixed_point_momentum
    )

    def add_jitter(g: Tensor) -> Tensor:
        if not config.jitter:
            return g
        return g + config.jitter * torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)

    def geometry(w: Tensor) -> _Geometry:
        ms = model.manifold_state(w)
        g = add_jitter(ms.metric)
        l, inv, half_logdet = ops.chol_inv_logdet(g, method=config.linalg)
        return _Geometry(ms.logp, ms.grad, g, ms.cache, l, inv, half_logdet)

    def hamiltonian(geo: _Geometry, p: Tensor) -> Tensor:
        quad = torch.einsum("...a,...ab,...b->...", p, geo.inv, p)
        if config.student_t:
            kinetic = 0.5 * (1.0 + p.shape[-1]) * torch.log1p(quad)
        else:
            kinetic = 0.5 * quad
        return -geo.logp + geo.half_logdet + kinetic

    def init(position: Tensor) -> RMHMCState:
        geo = geometry(position)
        return RMHMCState(position, geo.logp, geo)

    def force_base(w: Tensor, geo: _Geometry) -> Tensor:
        """grad - 1/2 tr(G^-1 dG_d): constant across the fixed point."""
        return geo.grad - 0.5 * model.dg_trace(w, geo.inv, cache=geo.cache)

    fixed_points = hasattr(model, "position_fixed_point") and hasattr(model, "momentum_fixed_point")

    def momentum_update(w: Tensor, geo: _Geometry, p: Tensor, base: Tensor, dt: Tensor, rounds: int) -> Tensor:
        """``rounds`` rounds of pm = p + 0.5 dt (base + weight u^T dG_d u), u = G^-1 pm, from pm = p
        (weight 1/2, or ((1+D)/2) / (1 + p^T G^-1 p) for Student-t, StudentT.m:296)."""
        kw = dict(rounds=rounds, student_t=config.student_t)
        if fixed_points:
            return model.momentum_fixed_point(w, geo.inv, geo.cache, p, p, base, dt, linalg=config.linalg, **kw)
        return logreg_fixed_point.momentum_fixed_point_plain(model, w, geo.inv, geo.cache, p, p, base, dt, **kw)

    def position_update(w: Tensor, pm: Tensor, u0: Tensor, dt: Tensor) -> Tensor:
        """The implicit position step: n_fp rounds of wf = w + 0.5 dt (u0 + G(wf)^-1 pm), G recomputed
        inside the loop (reference code/rmhmc.py:113-123)."""
        kw = dict(rounds=n_fp, student_t=config.student_t, jitter=config.jitter)
        if fixed_points:
            return model.position_fixed_point(w, pm, u0, dt, linalg=config.linalg, **kw)
        return logreg_fixed_point.position_fixed_point_plain(model, w, pm, u0, dt, method=config.linalg, **kw)

    def transition(state: RMHMCState, noise: RMHMCNoise) -> tuple[RMHMCState, Info]:
        c, d = state.position.shape
        geo0 = geometry(state.position) if state.geo is None else state.geo
        p0 = ops.mvn_sample(geo0.chol, noise.eps)
        if config.student_t:
            # t_1(0, G) = N(0, G) / sqrt(chi^2_1)  (mvtrnd(G,1), StudentT.m:265)
            p0 = p0 / torch.sqrt(noise.chi_normal**2)[:, None]
        h_cur = hamiltonian(geo0, p0)

        if config.randomize_length:
            n_steps = torch.ceil(noise.u_len * max_steps).to(torch.int32)
        else:
            n_steps = torch.full((c,), max_steps, dtype=torch.int32, device=p0.device)
        if config.random_direction:
            direction = torch.where(noise.u_dir < 0.5, 1.0, -1.0).to(p0.dtype)
        else:
            direction = torch.ones((c,), dtype=p0.dtype, device=p0.device)
        dt = direction * eps  # (C,)

        w, p, geo = state.position, p0, geo0
        bad = torch.zeros((c,), dtype=torch.bool, device=p0.device)
        for i in range(max_steps):
            active = i < n_steps

            # (a) implicit momentum half-step: fixed point on p'
            pm = momentum_update(w, geo, p, force_base(w, geo), dt, n_fp_mom)

            # (b) implicit position step: fixed point on w', G recomputed inside
            u0 = torch.einsum("...ab,...b->...a", geo.inv, pm)
            if config.student_t:
                q0 = torch.sum(pm * u0, dim=-1, keepdim=True)
                u0 = (1.0 + d) * u0 / (1.0 + q0)  # StudentT.m:327
            wf = position_update(w, pm, u0, dt)

            # (c) explicit momentum half-step with fresh geometry at w'.
            geo_new = geometry(wf)
            p_new = momentum_update(wf, geo_new, pm, force_base(wf, geo_new), dt, 1)

            step_bad = ~(torch.isfinite(wf).all(dim=-1) & torch.isfinite(p_new).all(dim=-1))
            ok = active & ~bad & ~step_bad
            w = torch.where(ok[:, None], wf, w)
            p = torch.where(ok[:, None], p_new, p)
            geo = tree_where(ok, geo_new, geo)
            bad = bad | (active & step_bad)

        h_prop = hamiltonian(geo, p)
        ratio = h_cur - h_prop
        divergent = bad | ~torch.isfinite(ratio)
        accept, accept_prob = metropolis_accept(noise.u_acc, ratio, divergent)

        cur_state = RMHMCState(state.position, state.logp, geo0)
        new_state = tree_where(accept, RMHMCState(w, geo.logp, geo), cur_state)
        return new_state, Info(accept_prob, accept, divergent)

    def step(generator: torch.Generator, state: RMHMCState) -> tuple[RMHMCState, Info]:
        return transition(state, draw_noise(generator, state.position))

    return Kernel(init, step, transition, draw_noise, capturable=model_capturable(model))
