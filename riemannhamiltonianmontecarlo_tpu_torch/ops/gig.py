"""Batched GIG(1/2, 1, r^2) sampling for Holmes-Held logistic mixing weights.

Port of ``riemannhamiltonianmontecarlo_tpu/ops/gig.py``, with the same
contract (``code/gibbs_sampler.py:14-70``; Holmes & Held 2006, appendix):
draw a candidate lambda from the inverse-Gaussian-based proposal, then
accept or reject it by squeezing the alternating series -- the "rightmost"
series for lambda > 4/3, the "leftmost" one otherwise.  Series terms are
evaluated in log space.

The whole (chains x data) batch runs in lockstep under per-element
decided / accepted masks, with the JAX package's caps: at most 64 rejection
rounds and 32 series bodies; an element undecided at the series cap counts
as a reject, and an element never accepted keeps lambda = 1.  The JAX
package's ``lax.while_loop``s stop once every element is decided; here each
loop runs blocks of a few rounds (bodies) and asks the device ``.all()``
before each block -- one host sync per block, the only data-dependent
control flow of a Gibbs step.  A round run after every element was decided
changes nothing but the random stream.  Each squeeze series waits only for
the elements whose result it decides (not yet accepted, on its side of
4/3); the JAX package runs both series over every element, with the same
result for those.  Each round draws from the ``generator``
passed in: predrawing 64 rounds at (C, N) would not fit in memory at the
chain counts the sampler runs.

Under a chain split (``parallel.chain_sliced``) the draws are ``GigDraws``
with this rank's ``ChainRows``: every round draws the candidates and
uniforms of all chains and keeps this rank's rows, and the rounds stop when
every chain of every rank is decided -- the local "all decided" flag is
all-reduced (MIN) over the chain group -- so each rank's generator advances
as one process's does.  The squeeze series draw nothing and freeze each
element once decided, so they stop on the local elements alone.  Without a
split nothing changes: no collective and no extra draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist
from torch import Tensor

if TYPE_CHECKING:
    from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import ChainRows

_TWO_STEPS_PER_BODY = 2  # each body consumes one subtract + one add term
ROUNDS_PER_CHECK = 4
BODIES_PER_CHECK = 2


def _pow(x_log: Tensor, exponent: float) -> Tensor:
    return torch.exp(x_log * exponent)


def _run_squeeze(body, u: Tensor, active: Tensor, max_bodies: int) -> tuple[Tensor, Tensor]:
    """Run ``body(z, j) -> (z, acc_now, rej_now)`` until all decided or the cap.

    Elements outside ``active`` start decided: their result is not used, so
    they do not hold the loop open.  The active elements' results are those
    of the JAX package's loop, which runs every element.
    """
    z = torch.ones_like(u)
    decided = ~active
    accept = torch.zeros_like(decided)
    j = 1.0  # odd step index (1, 3, 5, ...), the same for every element
    bodies = 0
    while bodies < max_bodies and not bool(decided.all()):
        for _ in range(min(BODIES_PER_CHECK, max_bodies - bodies)):
            z_new, acc_now, rej_now = body(z, j)
            accept = accept | (~decided & acc_now)
            z = torch.where(decided, z, z_new)  # frozen once decided
            decided = decided | acc_now | rej_now
            j += _TWO_STEPS_PER_BODY
            bodies += 1
    return decided, accept


def _rightmost_accept(u: Tensor, lam: Tensor, active: Tensor, max_bodies: int) -> tuple[Tensor, Tensor]:
    """Squeeze test for lambda > 4/3.  Returns (decided, accept)."""
    x_log = -0.5 * lam  # log X, X = exp(-lambda/2)

    def body(z: Tensor, j: float):
        n1 = j + 1.0  # subtract term index (2, 4, ...)
        z_sub = z - n1**2 * _pow(x_log, n1**2 - 1.0)
        n2 = j + 2.0  # add term index (3, 5, ...)
        z_add = z_sub + n2**2 * _pow(x_log, n2**2 - 1.0)
        return z_add, z_sub > u, z_add < u

    return _run_squeeze(body, u, active, max_bodies)


def _leftmost_accept(u: Tensor, lam: Tensor, active: Tensor, max_bodies: int) -> tuple[Tensor, Tensor]:
    """Squeeze test for lambda <= 4/3 (series in the transformed domain)."""
    pi2 = math.pi**2
    lam_safe = torch.clamp(lam, min=1e-20)
    h = (
        0.5 * math.log(2.0)
        + 2.5 * math.log(math.pi)
        - 2.5 * torch.log(lam_safe)
        - pi2 / (2.0 * lam_safe)
        + 0.5 * lam_safe
    )
    log_u = torch.log(u)
    x_log = -pi2 / (2.0 * lam_safe)  # log X
    k = lam_safe / pi2

    def safe_log(z: Tensor) -> Tensor:
        return torch.where(z > 0.0, torch.log(torch.clamp(z, min=1e-300)), -math.inf)

    def body(z: Tensor, j: float):
        z_sub = z - k * _pow(x_log, j**2 - 1.0)
        n2 = j + 2.0
        z_add = z_sub + n2**2 * _pow(x_log, n2**2 - 1.0)
        return z_add, h + safe_log(z_sub) > log_u, h + safe_log(z_add) < log_u

    return _run_squeeze(body, u, active, max_bodies)


@dataclasses.dataclass(frozen=True)
class GigDraws:
    """What the rejection rounds draw from: ``generator`` and, under a chain
    split, this rank's ``rows`` of the chain axis (the leading axis of r2)."""

    generator: torch.Generator
    rows: ChainRows | None = None

    def split_chains(self, rows: ChainRows) -> "GigDraws":
        return dataclasses.replace(self, rows=rows)


def _all_decided(ok: Tensor, rows: ChainRows | None) -> bool:
    """Every element decided: on this process's rows, or on every rank's."""
    if rows is None:
        return bool(ok.all())
    from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives

    flag = ok.all().to(torch.int32).reshape(1)
    return bool(collectives.all_reduce(flag, rows.group, op=dist.ReduceOp.MIN)[0])


def sample_gig_half(
    draws: torch.Generator | GigDraws,
    r2: Tensor,
    *,
    max_rejection_rounds: int = 64,
    max_series_bodies: int = 32,
) -> Tensor:
    """lambda ~ GIG(1/2, 1, r^2), elementwise over ``r2``.

    ``draws``: a generator, or ``GigDraws`` (a generator and, under a chain
    split, this rank's rows of ``r2``'s leading axis).
    """
    if not isinstance(draws, GigDraws):
        draws = GigDraws(draws)
    rows = draws.rows
    r = torch.sqrt(torch.clamp(r2, min=1e-16))
    kw = dict(generator=draws.generator, dtype=r.dtype, device=r.device)
    shape = r.shape if rows is None else (rows.total, *r.shape[1:])

    def draw(fn) -> Tensor:
        x = fn(shape, **kw)
        return x if rows is None else x[rows.lo : rows.hi]

    lam = torch.ones_like(r)
    ok = torch.zeros(r.shape, dtype=torch.bool, device=r.device)
    tries = 0
    while tries < max_rejection_rounds:
        for _ in range(min(ROUNDS_PER_CHECK, max_rejection_rounds - tries)):
            y0 = draw(torch.randn) ** 2
            # The reference's y = 1 + (y0 - sqrt(y0 (4r + y0))) / (2r) cancels
            # catastrophically for small r in float32; the rationalized form
            # y = 4 r y0 / (y0 + sqrt(y0 (y0 + 4r)))^2 does not.
            root = y0 + torch.sqrt(y0 * (y0 + 4.0 * r))
            y = 4.0 * r * y0 / torch.clamp(root * root, min=1e-30)
            u_side = draw(torch.rand)
            lam_cand = torch.where(u_side <= 1.0 / (1.0 + y), r / y, r * y)
            # Guards: y -> 0 numerically; y0 = 0 exactly (torch.randn can
            # return 0, jax.random.normal cannot) gives lambda = r / 0 = inf,
            # which must not be accepted: a measure-zero candidate, redrawn.
            lam_cand = torch.clamp(lam_cand, min=1e-12)
            u = draw(torch.rand)
            right = lam_cand > 4.0 / 3.0
            # Each series runs for the pending elements on its own side only.
            dec_r, acc_r = _rightmost_accept(u, lam_cand, ~ok & right, max_series_bodies)
            dec_l, acc_l = _leftmost_accept(u, lam_cand, ~ok & ~right, max_series_bodies)
            accept = torch.where(right, dec_r & acc_r, dec_l & acc_l) & torch.isfinite(lam_cand)
            lam = torch.where(~ok & accept, lam_cand, lam)
            ok = ok | accept
            tries += 1
        if _all_decided(ok, rows):
            break
    return lam
