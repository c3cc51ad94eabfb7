"""Holmes-Held auxiliary-variable Gibbs sampler for logistic regression.

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/gibbs.py``, with the
same contract (``code/gibbs_sampler.py:73-139`` / MATLAB
``BLR_holmes_joint_update.m:183-220``):

* latent z_j: one-sided truncated normals with the sign of the label;
* per step: V = (X^T Lambda^{-1} X + I/v)^{-1}, L = chol(V), S = V X^T,
  B = S Lambda^{-1} z;
* a sequential sweep over the N data points updating z_j from its full
  conditional and B by a rank-one correction -- a true serial dependency,
  a Python loop over j with all chains in lockstep;
* beta = B + L T, T ~ N(0, I);
* mixing weights lambda_j ~ GIG(1/2, 1, r_j^2) by batched rejection
  (``ops/gig.py``).

``init`` sets z to the truncated normal's mean (+-sqrt(2/pi)) and lambda
to 1, as the JAX package does.

The randomness: ``transition(state, noise)`` takes every uniform of the
sweep, predrawn as (N, C) tensors in one call, and beta's normal draw; the
GIG rounds draw from ``noise.gig`` (``ops.gig.GigDraws``: a generator, and
under a chain split this rank's rows), because the number of rounds is
data-dependent and 64 predrawn rounds at (C, N) would not fit.
``draw_noise`` reads the state's shapes (``Kernel.noise_from_state``).
On a CUDA batch K1 runs twice per step: once inside ``ops.inv_psd`` and
once for chol(V).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch import ops
from riemannhamiltonianmontecarlo_tpu_torch.ops import gig as gig_mod
from riemannhamiltonianmontecarlo_tpu_torch.ops import truncnorm
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    prior_variance: float = 100.0  # v, code/gibbs_sampler.py:73
    max_rejection_rounds: int = 64


class GibbsState(NamedTuple):
    position: Tensor  # (C, D) current beta draw
    z: Tensor  # (C, N) latent utilities
    lam: Tensor  # (C, N) logistic mixing weights


class GibbsNoise(NamedTuple):
    sweep: truncnorm.TruncNormNoise  # (N, C) raw uniforms of the z_j draws, j-major
    beta: Tensor  # (C, D) N(0, 1): beta = B + chol(V) @ beta
    gig: torch.Generator | gig_mod.GigDraws  # the GIG rejection rounds draw from it


class Conditionals(NamedTuple):
    """The step's quantities given lambda (and z, for B)."""

    v: Tensor  # (C, D, D) posterior covariance V
    chol_v: Tensor  # (C, D, D) lower factor of V
    s: Tensor  # (C, D, N) S = V X^T
    b: Tensor  # (C, D) B = S Lambda^{-1} z
    h: Tensor  # (C, N) h_j = x_j^T V x_j


def draw_noise(generator: torch.Generator, state: GibbsState) -> GibbsNoise:
    c, n = state.z.shape
    z = state.z
    sweep = truncnorm.draw_noise(generator, (n, c), dtype=z.dtype, device=z.device)
    beta = torch.randn(state.position.shape, generator=generator, dtype=z.dtype, device=z.device)
    return GibbsNoise(sweep, beta, gig_mod.GigDraws(generator))


def conditionals(model, state: GibbsState, prior_variance: float = GibbsConfig.prior_variance) -> Conditionals:
    """V, chol(V), S, B and h given the state's lambda and z."""
    x, d = model.X, model.dim
    inv_lam = 1.0 / state.lam  # (C, N)
    # X^T Lambda^{-1} X as one (C, N) x (N, D^2) GEMM over the outer features.
    prec = torch.matmul(inv_lam, model.outer_features).reshape(-1, d, d)
    prec = prec + torch.eye(d, dtype=prec.dtype, device=prec.device) / prior_variance
    v = ops.inv_psd(prec)  # posterior covariance given lambda
    chol_v = ops.cholesky(v)
    s = torch.matmul(v, x.T)  # (C, D, N)
    b = torch.einsum("cdn,cn->cd", s, inv_lam * state.z)
    h = model.quadratic_forms(v)  # h_j = x_j^T V x_j
    return Conditionals(v, chol_v, s, b, h)


def sweep(model, state: GibbsState, cond: Conditionals, noise: truncnorm.TruncNormNoise) -> tuple[Tensor, Tensor]:
    """The sequential z / B sweep (``code/gibbs_sampler.py:109-126``).

    ``noise`` holds (N, C) uniforms, j-major.  Returns (B after the sweep
    (C, D), z (C, N)).  What does not depend on the running B is computed
    for all j at once before the loop, which leaves some 30 launches per j:
    with m_j = B x_j, the conditional mean is m_j (1 + w_j) - w_j z_j and
    the truncated draw is mean + sign_j std_j TN_above(-sign_j mean / std_j).
    """
    positive = (model.t == 1.0)[:, None]  # (N, 1)
    lam_t = state.lam.T  # (N, C)
    h_t = cond.h.T
    # lambda_j > h_j holds exactly (V^{-1} >= x_j x_j^T / lambda_j); clamp
    # the gap against float32 rounding.
    w_t = h_t / torch.clamp(lam_t - h_t, min=1e-12)
    std_t = torch.sqrt(lam_t * (w_t + 1.0))
    z_old_t = state.z.T
    one_plus_w, neg_w_z_old = 1.0 + w_t, -w_t * z_old_t
    signed_std = torch.where(positive, std_t, -std_t)
    bound_scale = -1.0 / signed_std  # a = -sign m / std
    inv_lam = 1.0 / lam_t
    terms = truncnorm.prepare(noise)
    s_t = cond.s.permute(2, 0, 1)  # (N, C, D)
    x, b = model.X, cond.b
    z_new = []
    for j in range(x.shape[0]):
        m = torch.addcmul(neg_w_z_old[j], one_plus_w[j], torch.mv(b, x[j]))
        z_std = truncnorm.std_truncnorm_above(m * bound_scale[j], truncnorm.TailTerms(*(t[..., j, :] for t in terms)))
        z_j = torch.addcmul(m, signed_std[j], z_std)
        b = torch.addcmul(b, ((z_j - z_old_t[j]) * inv_lam[j])[:, None], s_t[j])
        z_new.append(z_j)
    return b, torch.stack(z_new, dim=1)


def build(model, config: GibbsConfig = GibbsConfig()) -> Kernel:
    x = model.X  # (N, D)
    n = model.num_data
    positive = model.t == 1.0

    def init(position: Tensor) -> GibbsState:
        c = position.shape[0]
        half_mean = math.sqrt(2.0 / math.pi)
        z0 = torch.where(positive, half_mean, -half_mean).to(position.dtype)
        lam = torch.ones((c, n), dtype=position.dtype, device=position.device)
        return GibbsState(position, z0.expand(c, n).clone(), lam)

    def transition(state: GibbsState, noise: GibbsNoise) -> tuple[GibbsState, Info]:
        c = state.position.shape[0]
        cond = conditionals(model, state, config.prior_variance)
        b, z = sweep(model, state, cond, noise.sweep)

        # beta = B + L T (code/gibbs_sampler.py:128-129).
        beta = b + ops.mvn_sample(cond.chol_v, noise.beta)

        # lambda_j ~ GIG(1/2, 1, (z_j - x_j beta)^2) (code/gibbs_sampler.py:133-135).
        resid = z - torch.matmul(beta, x.T)
        lam = ops.sample_gig_half(noise.gig, resid**2, max_rejection_rounds=config.max_rejection_rounds)

        bad = ~(torch.isfinite(beta).all(dim=-1) & torch.isfinite(z).all(dim=-1) & torch.isfinite(lam).all(dim=-1))
        ones = torch.ones((c,), dtype=beta.dtype, device=beta.device)
        return GibbsState(beta, z, lam), Info(ones, ones > 0, bad)

    def step(generator: torch.Generator, state: GibbsState) -> tuple[GibbsState, Info]:
        return transition(state, draw_noise(generator, state))

    return Kernel(init, step, transition, draw_noise, noise_from_state=True)
