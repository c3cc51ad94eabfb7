"""Batched GIG(1/2, 1, r^2) sampling for Holmes-Held logistic mixing weights.

Port of ``riemannhamiltonianmontecarlo_tpu/ops/gig.py``, with the same
contract (``code/gibbs_sampler.py:14-70``; Holmes & Held 2006, appendix):
draw a candidate lambda from the inverse-Gaussian-based proposal, then
accept or reject it by squeezing the alternating series -- the "rightmost"
series for lambda > 4/3, the "leftmost" one otherwise.  Series terms are
evaluated in log space.

Each element runs its own rejection rounds, with the JAX package's caps:
at most 64 rounds and 32 series bodies; an element undecided at the series
cap counts as a reject, and an element never accepted keeps lambda = 1.
An element stops at its own first acceptance, so nothing waits for the
whole batch and nothing is read by the host: a Gibbs step is a fixed
sequence of launches, which a CUDA graph can hold.

The random numbers come from a counter-based generator, Philox4x32-10
(Salmon et al. 2011), written out here and in the kernel: ``philox4x32``.
A call draws one int64 key from the caller's generator (``torch.randint``,
on the device, so a CUDA graph replays it); the counter of round k of
element e is (e's global index, k).  Its four 32-bit words give the round's
normal (Box-Muller, from the first two) and its two uniforms, each word's
top 23 bits k mapped to (2k + 1) 2^-24, which is never 0 or 1.

``sample_gig_half`` takes the plain version ``sample_gig_half_plain`` for a
CPU tensor and the hand-written kernel (``csrc/gibbs.cu``, one thread per
element looping over its rounds, one launch a call) for a CUDA one.  The
plain version draws the same words and runs ``gig_round_plain``, one round
of every pending element at once, for at most 64 rounds.

Under a chain split (``parallel.chain_sliced``) the draws are ``GigDraws``
with this rank's ``ChainRows``: the counter's element index is global
(``rows.lo`` x N plus the local index), so a rank draws exactly the numbers
one process draws for its rows, and every rank draws the same key.  No
collective is needed.

``gig_round_cuda`` (kernel ``gig_round_kernel``) and ``gig_round_plain`` are
one round from given draws, kept for checking the round's arithmetic on
its own; the Gibbs step does not call them.
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


# -- Philox4x32-10 (Salmon et al. 2011; Random123's philox4x32), on int64 tensors --------

PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # the round's multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # the key's increments between rounds
PHILOX_ROUNDS = 10
_MASK32 = 0xFFFFFFFF
KEY_RANGE = (-(2**63), 2**63 - 1)  # torch.randint's bounds for a call's key: every int64 but the largest


def _mulhilo(a: int, b: Tensor) -> tuple[Tensor, Tensor]:
    """The high and low 32-bit words of a * b, for a 32-bit constant ``a``
    and int64 ``b`` in [0, 2^32): b in 16-bit halves, so that no product
    overflows int64 (a * b itself can exceed 2^63)."""
    low = a * (b & 0xFFFF)  # < 2^48
    t = a * (b >> 16) + (low >> 16)  # a b = t 2^16 + (low mod 2^16), t < 2^49
    return t >> 16, ((t & 0xFFFF) << 16) | (low & 0xFFFF)


def philox4x32(counter: tuple[Tensor, Tensor, Tensor, Tensor], key: tuple[Tensor, Tensor]) -> list[Tensor]:
    """Philox4x32-10 of a batch: the four 32-bit words of each counter under
    ``key``, every word an int64 tensor in [0, 2^32) (broadcast together)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(PHILOX_ROUNDS):
        if i:
            k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def unit_uniform(word: Tensor) -> Tensor:
    """A 32-bit word's top 23 bits k as (2k + 1) 2^-24 in float32: exact, in (0, 1)."""
    return ((word >> 9) * 2 + 1).to(torch.float32) * 2.0**-24


def box_muller(u1: Tensor, u2: Tensor) -> Tensor:
    """A standard normal from two uniforms in (0, 1), float32 op by op as the kernel rounds it."""
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(u2 * (2.0 * math.pi))


def round_draws(key: Tensor, index: Tensor, rounds: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The normal and the two uniforms (u_side, u) of each round in ``rounds``
    (R,) for each global element index in ``index`` (E,), under the call's
    int64 ``key`` (0-dim): three (R, E) float32 tensors."""
    key = key.reshape(())
    words = philox4x32((index & _MASK32, (index >> 32) & _MASK32, rounds[:, None], torch.zeros_like(index)),
                       (key & _MASK32, (key >> 32) & _MASK32))
    u = [unit_uniform(w) for w in words]
    return box_muller(u[0], u[1]), u[2], u[3]


_PLAIN_ROUND_BLOCK = 8  # the plain version's rounds drawn at once for the elements still pending


def gig_half_plain_rounds(r: Tensor, key: Tensor, first_index: int = 0, max_rejection_rounds: int = 64,
                          max_series_bodies: int = 32) -> tuple[Tensor, Tensor]:
    """``sample_gig_half_plain`` and, per element, the rounds it ran: the
    round that accepted it (1-based), or ``max_rejection_rounds``."""
    flat = r.reshape(-1)
    lam = torch.ones_like(flat)
    ran = torch.full(flat.shape, max_rejection_rounds, dtype=torch.int32, device=r.device)
    pending = torch.arange(flat.numel(), device=r.device)
    for start in range(0, max_rejection_rounds, _PLAIN_ROUND_BLOCK):
        rounds = torch.arange(start, min(start + _PLAIN_ROUND_BLOCK, max_rejection_rounds), device=r.device)
        normal, u_side, u = round_draws(key, pending + first_index, rounds)
        r_p = flat[pending]
        lam_p, ok_p = torch.ones_like(r_p), torch.zeros(r_p.shape, dtype=torch.bool, device=r.device)
        ran_p = torch.full(r_p.shape, max_rejection_rounds, dtype=torch.int32, device=r.device)
        for i in range(rounds.numel()):
            before = ok_p.clone()
            gig_round_plain(r_p, normal[i], u_side[i], u[i], lam_p, ok_p, max_series_bodies)
            ran_p = torch.where(ok_p & ~before, start + i + 1, ran_p)
        lam[pending] = lam_p  # 1 where not accepted in this block
        ran[pending] = ran_p
        pending = pending[~ok_p]
    return lam.reshape(r.shape), ran.reshape(r.shape)


def sample_gig_half_plain(r: Tensor, key: Tensor, first_index: int = 0, max_rejection_rounds: int = 64,
                          max_series_bodies: int = 32) -> Tensor:
    """The fused GIG draw's plain version: lambda ~ GIG(1/2, 1, r^2) for each
    element of ``r`` (r = sqrt(r^2)), from the Philox words of ``key`` at the
    elements' global indices ``first_index`` + the flat index."""
    return gig_half_plain_rounds(r, key, first_index, max_rejection_rounds, max_series_bodies)[0]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    ptr = ctypes.c_void_p
    lib.rhmc_gig_round.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ptr]
    lib.rhmc_gig_round.restype = ctypes.c_int
    lib.rhmc_gig_half.argtypes = [ptr, ptr, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr,
                                  ptr]
    lib.rhmc_gig_half.restype = ctypes.c_int
    return lib


def gig_round_cuda(r: Tensor, y0_normal: Tensor, u_side: Tensor, u: Tensor, lam: Tensor, ok: Tensor,
                   max_series_bodies: int = 32) -> None:
    """Kernel ``gig_round_kernel`` on the card: float32 CUDA ``r``, draws and ``lam`` and a
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


def sample_gig_half_cuda(r: Tensor, key: Tensor, first_index: int = 0, max_rejection_rounds: int = 64,
                         max_series_bodies: int = 32) -> Tensor:
    """Kernel G2 on the card: ``sample_gig_half_plain``'s arguments, ``r``
    float32, contiguous and on a CUDA device, ``key`` one int64 on the same
    device.  Returns lambda, a new tensor of ``r``'s shape."""
    if r.device.type != _KERNEL_DEVICE or key.device != r.device:
        raise ValueError(f"gig_half: the CUDA kernel needs r and key on one CUDA device, got {r.device} and "
                         f"{key.device}")
    if r.dtype != torch.float32 or key.dtype != torch.int64 or key.numel() != 1:
        raise TypeError(f"gig_half: the kernel takes float32 r and one int64 key, got {r.dtype} and "
                        f"{key.numel()} x {key.dtype}")
    if not r.is_contiguous():
        raise ValueError("gig_half: r is not contiguous")
    if max_rejection_rounds < 1 or max_series_bodies < 1 or first_index < 0:
        raise ValueError(f"gig_half: rounds {max_rejection_rounds}, bodies {max_series_bodies} and the first index "
                         f"{first_index} must be positive")
    lam = torch.empty_like(r)
    if r.numel() == 0:
        return lam
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().rhmc_gig_half(r.data_ptr(), key.data_ptr(), first_index, r.numel(), max_rejection_rounds,
                                   max_series_bodies, lam.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gig_half kernel launch failed with CUDA error {err}")
    launches.count("gig_half", r.device)
    return lam


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
    """lambda ~ GIG(1/2, 1, r^2), elementwise over ``r2``: one key drawn from
    the generator, then at most ``max_rejection_rounds`` rounds an element.

    ``draws``: a generator, or ``GigDraws`` (a generator and, under a chain
    split, this rank's rows of ``r2``'s leading axis).
    """
    if not isinstance(draws, GigDraws):
        draws = GigDraws(draws)
    r = torch.sqrt(torch.clamp(r2, min=1e-16))
    key = torch.randint(*KEY_RANGE, (1,), generator=draws.generator, dtype=torch.int64, device=r.device)
    first = 0 if draws.rows is None else draws.rows.lo * math.prod(r.shape[1:])
    fn = sample_gig_half_plain if r.device.type == "cpu" else sample_gig_half_cuda
    return fn(r, key, first, max_rejection_rounds, max_series_bodies)
