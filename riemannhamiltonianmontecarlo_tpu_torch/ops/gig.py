"""Batched GIG(1/2, 1, r^2) sampling for Holmes-Held logistic mixing weights.

Port of ``riemannhamiltonianmontecarlo_tpu/ops/gig.py``, with the same
contract (``code/gibbs_sampler.py:14-70``; Holmes & Held 2006, appendix):
draw a candidate lambda from the inverse-Gaussian-based proposal, then
accept or reject it by squeezing the alternating series -- the "rightmost"
series for lambda > 4/3, the "leftmost" one otherwise.  Series terms are
evaluated in log space.

The whole (chains x data) batch runs in lockstep under a per-element
``ok`` mask, with the JAX package's caps: 64 rejection rounds and 32 series
bodies; an element undecided at the series cap counts as a reject, and an
element never accepted keeps lambda = 1.  The JAX package's
``lax.while_loop`` stops once every element is accepted; here every call
runs all ``max_rejection_rounds`` rounds, so a Gibbs step is a fixed
sequence of launches with no read of the device, which a CUDA graph can
hold.  A round run after every element was accepted changes nothing but
the random stream: lambda is the early-exit loop's, bit for bit, from the
same generator state, and only the generator's offset after the call
differs (``tests/test_torch_gibbs_graph.py``).

One round is ``gig_round``: on a CUDA tensor the hand-written kernel G2
(``csrc/gibbs.cu``), one thread per element running its own series until
it decides; on a CPU tensor its plain version ``gig_round_plain``, the same
arithmetic with the bodies of each element's series computed for every
element at once and the first decision taken (each element is frozen once
decided, so the bodies after it change nothing).  Each round draws from the
``generator`` passed in: predrawing 64 rounds at (C, N) would not fit in
memory at the chain counts the sampler runs.

Under a chain split (``parallel.chain_sliced``) the draws are ``GigDraws``
with this rank's ``ChainRows``: every round draws the candidates and
uniforms of all chains and keeps this rank's rows, so each rank's generator
advances as one process's does.  Every rank runs the same rounds, so no
collective is needed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import TYPE_CHECKING

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.ops import _build, launches

if TYPE_CHECKING:
    from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import ChainRows

_KERNEL_DEVICE = "cuda"


# exp(x) is exactly 0 in float32 below ~-104 (e^-104 is under half the least
# subnormal); such arguments take the CPU's slow underflow path, ~30x the time
# of an ordinary one, and most of the series' later terms are such.
_EXP_ZERO_BELOW = -110.0


def _exp(x: Tensor) -> Tensor:
    """``torch.exp(x)``, bit for bit, without computing it where it is 0."""
    zero = x < _EXP_ZERO_BELOW
    return torch.where(zero, 0.0, torch.exp(torch.where(zero, 0.0, x)))


# The bodies a series can decide in.  A term exp(x_log e) is exactly 0 once its
# exponent is below -110 (``_exp``): on the right side x_log = -lambda / 2 <=
# -2/3, so from body 6 (exponents 14^2 - 1 and 15^2 - 1) both terms are 0; on
# the left x_log = -pi^2 / (2 lambda) <= -3.7, so from body 3 (7^2 - 1, 9^2 - 1).
# A body whose terms are 0 repeats its predecessor's partial sum and tests, so
# an element undecided after body 6 is undecided at every later body.
_DECIDING_BODIES = 7


def _body_indices(bodies: int, like: Tensor) -> Tensor:
    """The odd step index j = 1, 3, 5, ... of each body, shaped to broadcast over ``like``."""
    j = torch.arange(bodies, dtype=like.dtype, device=like.device) * 2.0 + 1.0
    return j.reshape(bodies, *([1] * like.ndim))


def _safe_log(z: Tensor) -> Tensor:
    return torch.where(z > 0.0, torch.log(torch.clamp(z, min=1e-300)), -math.inf)


def _series_accept(u: Tensor, lam: Tensor, max_bodies: int) -> Tensor:
    """Decided and accepted by the squeeze series of each element's side: the
    "rightmost" series for lambda > 4/3 (X = exp(-lambda / 2)), the "leftmost"
    one otherwise (in the transformed domain, tested in log space).

    Every body is computed for every element, each element's terms those of
    its own side: the partial sums z one body after another in float32 (the
    order of the series' own loop), each body's accept and reject tests, and
    the first body that decides.  Bodies past ``_DECIDING_BODIES`` would
    repeat the last one's tests and are not computed.
    """
    right = lam > 4.0 / 3.0
    j = _body_indices(min(max_bodies, _DECIDING_BODIES), lam)
    n1, n2 = j + 1.0, j + 2.0  # right: subtract term index (2, 4, ...); both: add term index (3, 5, ...)
    pi2 = math.pi**2
    lam_safe = torch.clamp(lam, min=1e-20)
    h = (  # the leftmost series' log-space offset
        0.5 * math.log(2.0)
        + 2.5 * math.log(math.pi)
        - 2.5 * torch.log(lam_safe)
        - pi2 / (2.0 * lam_safe)
        + 0.5 * lam_safe
    )
    x_log = torch.where(right, -0.5 * lam, -pi2 / (2.0 * lam_safe))  # log X
    # subtract: right n1^2 X^(n1^2 - 1), left (lambda / pi^2) X^(j^2 - 1); add: n2^2 X^(n2^2 - 1)
    sub = torch.where(right, n1**2, lam_safe / pi2) * _exp(torch.where(right, x_log * (n1**2 - 1.0), x_log * (j**2 - 1.0)))
    add = n2**2 * _exp(x_log * (n2**2 - 1.0))
    z_sub, z_add = torch.empty_like(sub), torch.empty_like(add)
    z = torch.ones_like(lam)
    for body in range(j.shape[0]):  # z - subtract term, + add term, body after body
        z = torch.add(torch.sub(z, sub[body], out=z_sub[body]), add[body], out=z_add[body])
    log_u = torch.log(u)
    acc = torch.where(right, z_sub > u, h + _safe_log(z_sub) > log_u)
    rej = torch.where(right, z_add < u, h + _safe_log(z_add) < log_u)
    decided = acc | rej
    first = decided.to(torch.uint8).argmax(dim=0, keepdim=True)  # the first body that decides
    return decided.any(dim=0) & acc.gather(0, first)[0]


def gig_round_plain(r: Tensor, y0_normal: Tensor, u_side: Tensor, u: Tensor, lam: Tensor, ok: Tensor,
                    max_series_bodies: int = 32) -> None:
    """One rejection round (kernel G2's plain version): a candidate per
    element from the round's normal draw and two uniforms; where an element
    is not yet ``ok`` and its series accepts a finite candidate, ``lam`` takes
    it and ``ok`` is set, both in place."""
    y0 = y0_normal**2
    # The reference's y = 1 + (y0 - sqrt(y0 (4r + y0))) / (2r) cancels
    # catastrophically for small r in float32; the rationalized form
    # y = 4 r y0 / (y0 + sqrt(y0 (y0 + 4r)))^2 does not.
    root = y0 + torch.sqrt(y0 * (y0 + 4.0 * r))
    y = 4.0 * r * y0 / torch.clamp(root * root, min=1e-30)
    lam_cand = torch.where(u_side <= 1.0 / (1.0 + y), r / y, r * y)
    # Guards: y -> 0 numerically; y0 = 0 exactly (torch.randn can return 0,
    # jax.random.normal cannot) gives lambda = r / 0 = inf, which must not be
    # accepted: a measure-zero candidate, redrawn in a later round.
    lam_cand = torch.clamp(lam_cand, min=1e-12)
    accept = _series_accept(u, lam_cand, max_series_bodies) & torch.isfinite(lam_cand)
    lam.copy_(torch.where(~ok & accept, lam_cand, lam))
    ok.logical_or_(accept)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    ptr = ctypes.c_void_p
    lib.rhmc_gig_round.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ptr]
    lib.rhmc_gig_round.restype = ctypes.c_int
    return lib


def gig_round_cuda(r: Tensor, y0_normal: Tensor, u_side: Tensor, u: Tensor, lam: Tensor, ok: Tensor,
                   max_series_bodies: int = 32) -> None:
    """Kernel G2 on the card: float32 CUDA ``r``, draws and ``lam`` and a
    bool ``ok``, all of one shape and contiguous; ``lam`` and ``ok`` in place."""
    floats = {"r": r, "y0_normal": y0_normal, "u_side": u_side, "u": u, "lam": lam}
    for name, t in (*floats.items(), ("ok", ok)):
        if t.device.type != _KERNEL_DEVICE or t.device != r.device:
            raise ValueError(f"gig_round: the CUDA kernel needs every tensor on r's CUDA device, got {name} on {t.device}")
        if t.shape != r.shape:
            raise ValueError(f"gig_round: {name} has shape {tuple(t.shape)}, r {tuple(r.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gig_round: {name} is not contiguous")
        if t.dtype != (torch.bool if name == "ok" else torch.float32):
            raise TypeError(f"gig_round: {name} is {t.dtype}; the kernel takes float32 and a bool ok")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().rhmc_gig_round(*(t.data_ptr() for t in (r, y0_normal, u_side, u, lam, ok)), r.numel(),
                                    max_series_bodies, stream)
    if err != 0:
        raise RuntimeError(f"gig_round kernel launch failed with CUDA error {err}")
    launches.count("gig_round", r.device)


def gig_round(r: Tensor, y0_normal: Tensor, u_side: Tensor, u: Tensor, lam: Tensor, ok: Tensor,
              max_series_bodies: int = 32) -> None:
    """One rejection round, ``lam`` and ``ok`` in place: the plain version on CPU, G2 on CUDA."""
    if r.device.type == "cpu":
        return gig_round_plain(r, y0_normal, u_side, u, lam, ok, max_series_bodies)
    return gig_round_cuda(r, y0_normal, u_side, u, lam, ok, max_series_bodies)


@dataclasses.dataclass(frozen=True)
class GigDraws:
    """What the rejection rounds draw from: ``generator`` and, under a chain
    split, this rank's ``rows`` of the chain axis (the leading axis of r2)."""

    generator: torch.Generator
    rows: ChainRows | None = None

    def split_chains(self, rows: ChainRows) -> "GigDraws":
        return dataclasses.replace(self, rows=rows)


def sample_gig_half(
    draws: torch.Generator | GigDraws,
    r2: Tensor,
    *,
    max_rejection_rounds: int = 64,
    max_series_bodies: int = 32,
) -> Tensor:
    """lambda ~ GIG(1/2, 1, r^2), elementwise over ``r2``: ``max_rejection_rounds``
    rounds, each drawing a normal and two uniforms of ``r2``'s shape.

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
    for _ in range(max_rejection_rounds):
        y0_normal = draw(torch.randn)
        u_side = draw(torch.rand)
        gig_round(r, y0_normal, u_side, draw(torch.rand), lam, ok, max_series_bodies)
    return lam
