"""Batched one-sided truncated-normal sampling, float32-tail-safe.

Port of ``riemannhamiltonianmontecarlo_tpu/ops/truncnorm.py``; the scheme is
the same, vectorized with no unbounded loop:

* bound <= 3: inverse CDF on [ndtr(a), 1), with ``a`` clipped to [-12, 3]
  and the uniform clipped to [1e-30, 1 - 1e-7];
* bound > 3 (the far tail): Rayleigh-tail inversion
  ``z = sqrt(a^2 - 2 log e)`` thinned to the normal tail by accept
  probability ``a / z`` (Robert 1995), over 3 fixed rounds: the first
  accepted candidate wins, else the last round's.

The randomness comes in as raw U[0, 1) draws (``TruncNormNoise``), mapped
onto their ranges as ``jax.random.uniform(minval=, maxval=)`` maps them, so
a test can replay the JAX package's draws exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

TAIL_SPLIT = 3.0
RETRY_ROUNDS = 3
_E_MIN = 1e-7  # lower end of the tail rounds' uniform e


class TruncNormNoise(NamedTuple):
    """Raw U[0, 1) draws for one batch of truncated normals of shape S."""

    u_central: Tensor  # S: the inverse-CDF uniform
    u_e: Tensor  # (RETRY_ROUNDS, *S): the Rayleigh uniforms e
    u_tail: Tensor  # (RETRY_ROUNDS, *S): the a/z thinning uniforms


def draw_noise(generator: torch.Generator, shape, dtype=torch.float32, device=None) -> TruncNormNoise:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return TruncNormNoise(
        torch.rand(tuple(shape), **kw),
        torch.rand((RETRY_ROUNDS, *shape), **kw),
        torch.rand((RETRY_ROUNDS, *shape), **kw),
    )


class TailTerms(NamedTuple):
    """What the tail rounds need of the noise, computed once for a whole batch."""

    u_central: Tensor  # S: the inverse-CDF uniform
    neg2_log_e: Tensor  # (RETRY_ROUNDS, *S): -2 log e, e on [1e-7, 1)
    u_tail: Tensor  # (RETRY_ROUNDS, *S): the a/z thinning uniforms


def prepare(noise: TruncNormNoise) -> TailTerms:
    """The noise-only part of the draws; slicing the result slices the batch."""
    e = torch.clamp(noise.u_e * (1.0 - _E_MIN) + _E_MIN, min=_E_MIN)  # as jax.random.uniform maps it
    return TailTerms(noise.u_central, -2.0 * torch.log(e), noise.u_tail)


def std_truncnorm_above(a: Tensor, terms: TailTerms) -> Tensor:
    """z ~ N(0, 1) conditioned on z > a, elementwise (any real a)."""
    # Central path: inverse CDF on [ndtr(a), 1), a clipped so ndtr stays in
    # float32-resolvable range; lanes with a > split use the tail path.  The
    # uniform maps onto [lo, 1) as jax.random.uniform(minval=lo) maps it
    # (u (1 - lo) + lo, which is never below lo).
    a_c = torch.clamp(a, -12.0, TAIL_SPLIT)
    lo = torch.special.ndtr(a_c)
    u = torch.addcmul(lo, terms.u_central, 1.0 - lo)
    z_small = torch.special.ndtri(torch.clamp(u, 1e-30, 1.0 - 1e-7))
    z_small = torch.maximum(z_small, a_c)  # guard round-off at the bound

    # Tail path, all rounds at once: the first accepted candidate wins, and
    # the last round's candidate stands where none was accepted.
    a_t = torch.clamp(a, min=TAIL_SPLIT)
    cand = torch.sqrt(torch.addcmul(terms.neg2_log_e, a_t, a_t))
    acc = terms.u_tail[:-1] <= a_t / cand[:-1]
    z_tail = cand[-1]
    for r in reversed(range(RETRY_ROUNDS - 1)):
        z_tail = torch.where(acc[r], cand[r], z_tail)
    return torch.where(a > TAIL_SPLIT, z_tail, z_small)


def truncated_normal_onesided(mean: Tensor, std: Tensor, positive: Tensor, noise: TruncNormNoise) -> Tensor:
    """z ~ N(mean, std^2) truncated to z > 0 (``positive``) or z < 0.

    ``positive`` is a bool tensor broadcastable against ``mean``: labels
    t = 1 truncate to the positive half-line, t = 0 to the negative
    (``code/gibbs_sampler.py:116-125``).
    """
    mean, std = torch.broadcast_tensors(mean, std)
    # Positive side: z = m + s * TN_above(-m / s); negative side by symmetry.
    a = torch.where(positive, -mean / std, mean / std)
    z_std = std_truncnorm_above(a, prepare(noise))
    return torch.where(positive, mean + std * z_std, -(-mean + std * z_std))
