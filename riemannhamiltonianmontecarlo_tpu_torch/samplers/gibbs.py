"""Holmes-Held auxiliary-variable Gibbs sampler for logistic regression.

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/gibbs.py``, with the
same contract (``code/gibbs_sampler.py:73-139`` / MATLAB
``BLR_holmes_joint_update.m:183-220``):

* latent z_j: one-sided truncated normals with the sign of the label;
* per step: V = (X^T Lambda^{-1} X + I/v)^{-1}, L = chol(V), S = V X^T,
  B = S Lambda^{-1} z;
* a sequential sweep over the N data points updating z_j from its full
  conditional and B by a rank-one correction -- a true serial dependency
  (``sweep``): on a CUDA batch one launch of the hand-written kernel G1
  (``csrc/gibbs.cu``, a chain on a group of lanes of one warp walking the
  N steps with B in their registers, or past 32 x ``SWEEP_ENT_MAX``
  entries on a block of warps, B in their registers to 8 x 32 x
  ``SWEEP_ENT_MAX`` entries and in memory past that: ``sweep_layout``), on
  a CPU batch its plain version ``gibbs_sweep_plain``, a Python loop over j
  with all chains in lockstep;
* beta = B + L T, T ~ N(0, I);
* mixing weights lambda_j ~ GIG(1/2, 1, r_j^2) by rejection (``ops/gig.py``:
  on CUDA one launch of kernel G2, each element running its own rounds
  from a counter-based generator keyed by one draw).

``init`` sets z to the truncated normal's mean (+-sqrt(2/pi)) and lambda
to 1, as the JAX package does.

The randomness: ``transition(state, noise)`` takes every uniform of the
sweep, predrawn as (N, C) tensors in one call, and beta's normal draw; the
GIG draws its key from ``noise.gig`` (``ops.gig.GigDraws``: a generator, and
under a chain split this rank's rows).  ``draw_noise`` reads the state's
shapes (``Kernel.noise_from_state``).  A step reads nothing on the device,
so on a card the runner replays it as a CUDA graph (``Kernel.capturable``):
K1 twice (inside ``ops.inv_psd`` and for chol(V); at D > 48 ``torch.linalg``,
as the JAX package's ``jnp.linalg``), G1 once and G2 once a step.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch import ops
from riemannhamiltonianmontecarlo_tpu_torch.ops import _build, launches, truncnorm
from riemannhamiltonianmontecarlo_tpu_torch.ops import gig as gig_mod
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, model_capturable


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
    gig: torch.Generator | gig_mod.GigDraws  # the GIG draws its key from it


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


def gibbs_sweep_plain(x: Tensor, t: Tensor, lam: Tensor, h: Tensor, z_old: Tensor, s: Tensor, b: Tensor,
                      noise: truncnorm.TruncNormNoise) -> tuple[Tensor, Tensor]:
    """The sequential z / B sweep (``code/gibbs_sampler.py:109-126``), kernel G1's plain version.

    ``x`` (N, D) and the labels ``t`` (N,); ``lam``, ``h``, ``z_old`` (C, N);
    ``s`` = V X^T (C, D, N); ``b`` (C, D); ``noise`` holds (N, C) uniforms,
    j-major.  Returns (B after the sweep (C, D), z (C, N)).  What does not
    depend on the running B is computed for all j at once before the loop,
    which leaves some 30 launches per j: with m_j = B x_j, the conditional
    mean is m_j (1 + w_j) - w_j z_j and the truncated draw is
    mean + sign_j std_j TN_above(-sign_j mean / std_j).
    """
    positive = (t == 1.0)[:, None]  # (N, 1)
    lam_t = lam.T  # (N, C)
    h_t = h.T
    # lambda_j > h_j holds exactly (V^{-1} >= x_j x_j^T / lambda_j); clamp
    # the gap against float32 rounding.
    w_t = h_t / torch.clamp(lam_t - h_t, min=1e-12)
    std_t = torch.sqrt(lam_t * (w_t + 1.0))
    z_old_t = z_old.T
    one_plus_w, neg_w_z_old = 1.0 + w_t, -w_t * z_old_t
    signed_std = torch.where(positive, std_t, -std_t)
    bound_scale = -1.0 / signed_std  # a = -sign m / std
    inv_lam = 1.0 / lam_t
    terms = truncnorm.prepare(noise)
    s_t = s.permute(2, 0, 1)  # (N, C, D)
    z_new = []
    for j in range(x.shape[0]):
        m = torch.addcmul(neg_w_z_old[j], one_plus_w[j], torch.mv(b, x[j]))
        z_std = truncnorm.std_truncnorm_above(m * bound_scale[j], truncnorm.TailTerms(*(u[..., j, :] for u in terms)))
        z_j = torch.addcmul(m, signed_std[j], z_std)
        b = torch.addcmul(b, ((z_j - z_old_t[j]) * inv_lam[j])[:, None], s_t[j])
        z_new.append(z_j)
    return b, torch.stack(z_new, dim=1)


SWEEP_THREADS = 32  # csrc/gibbs.cu::kSweepThreads: a warp; the register layout's blocks are one
SWEEP_FIELDS = 6  # csrc/gibbs.cu::kSweepFields: the step constants a prologue writes per chain and step
SWEEP_LANES = (1, 2, 4, 8, 16, 32)  # the lanes of a warp a chain may take in G1's register layout
SWEEP_WARPS_PER_SM = 8  # two a scheduler: as many lanes (or warps) a chain as keep G1's warps within this
SWEEP_ENT_MAX = 34  # csrc/gibbs.cu::kEntMax: the most entries of B a lane holds in registers
SWEEP_WIDE_WARPS = 8  # csrc/gibbs.cu::kWideWarps: the most warps a chain with B in registers (256 threads)
SWEEP_MEMORY_WARPS = 16  # csrc/gibbs.cu::kMemoryWarps: the most warps a chain with B in memory, and past the
# registers the warps a chain
# csrc/gibbs.cu::SweepLayout: B in registers on `lanes` lanes of a warp a chain; the wide layout, a block of
# warps a chain, with B in its lanes' registers, in the block's shared memory, or in the output buffer (past
# the card's shared memory a block).
SWEEP_REGISTERS, SWEEP_WIDE_REGISTERS, SWEEP_WIDE_SHARED, SWEEP_WIDE_GLOBAL = 0, 1, 2, 3
SWEEP_EXCHANGE_BYTES = 264  # csrc/gibbs.cu::Exchange: the warps' sums of two steps (2 x 16 x 2 floats), an mbarrier
H100_SMS = 132
H100_SHARED_OPTIN = 232_448  # bytes of shared memory a block may opt in to on an H100 (227 KB)
SWEEP_B_MEMORY = ("shared", "global")  # where the wide layout may be asked to keep B


class SweepLayout(NamedTuple):
    lanes: int  # lanes a chain: 1-32 of one warp, or (wide) a block of lanes / 32 warps
    entries: int  # B's entries each lane holds: in registers, or (past them) walks in memory
    wide: bool  # a chain on a block of warps: past 32 lanes of SWEEP_ENT_MAX entries

    @property
    def warps(self) -> int:
        return -(-self.lanes // SWEEP_THREADS)

    @property
    def in_registers(self) -> bool:
        return self.entries <= SWEEP_ENT_MAX and (not self.wide or self.warps <= SWEEP_WIDE_WARPS)


def sweep_lanes(num_chains: int, sm_count: int = H100_SMS) -> int:
    """The lanes of a warp that G1 gives each chain: the most (up to a warp) that keep the launch
    within SWEEP_WARPS_PER_SM warps an SM, two a scheduler; at least one.  On an H100 (132 SMs):
    32 up to 1,056 chains, 8 up to 4,224, 4 up to 8,448 (kernel_ab.py --kernels gibbs, PERF.md)."""
    budget = SWEEP_WARPS_PER_SM * sm_count * SWEEP_THREADS  # lanes x chains
    lanes = SWEEP_THREADS
    while lanes > 1 and lanes * num_chains > budget:
        lanes //= 2
    return lanes


def sweep_warps(num_chains: int, dim: int, sm_count: int = H100_SMS) -> int:
    """The warps of G1's wide layout a chain (a block each) at (C, D): the fewest that keep
    SWEEP_ENT_MAX entries a lane or fewer, raised to as many as keep the launch within SWEEP_WARPS_PER_SM
    warps an SM, at most SWEEP_WIDE_WARPS; past SWEEP_WIDE_WARPS such warps (D > 8,704) B leaves the
    registers and a chain takes SWEEP_MEMORY_WARPS.  On an H100: 8 warps at 64 chains and D 1,089-8,704,
    2 at 1024 chains and D 2,049.  Measured on an H100 at N 300 (kernel_ab.py --kernels gibbs, two calls,
    PERF.md): at 64 chains, D 2,049 on 8 / 4 / 2 warps 466-480 / 436-443 / 466-506 us, D 1,088 on 8 / 4 / 2 /
    1 warps 253-303 / 279-282 / 314-328 / 334-340 us (32 lanes of the register layout 323-325); at 128
    chains, D 2,049, 8 warps 632-634 us against 4 warps' 693."""
    fewest = -(-dim // (SWEEP_THREADS * SWEEP_ENT_MAX))
    if fewest > SWEEP_WIDE_WARPS:
        return SWEEP_MEMORY_WARPS
    return max(fewest, min(SWEEP_WIDE_WARPS, SWEEP_WARPS_PER_SM * sm_count // num_chains))


def sweep_layout(num_chains: int, dim: int, sm_count: int = H100_SMS) -> SweepLayout:
    """G1's layout for (C, D): the larger of ``sweep_lanes(C)`` and the fewest lanes of a warp that keep
    ceil(D / lanes) <= SWEEP_ENT_MAX, B in registers; past 32 such lanes (D > 32 SWEEP_ENT_MAX), the wide
    layout on ``sweep_warps(C, D)`` warps.  D takes no instantiation of its own: the kernel's entries a
    lane do."""
    if num_chains < 1 or dim < 1:
        raise ValueError(f"G1 takes C >= 1 and D >= 1, got C = {num_chains}, D = {dim}")
    fewest = next((lanes for lanes in SWEEP_LANES if -(-dim // lanes) <= SWEEP_ENT_MAX), None)
    if fewest is None:
        lanes = SWEEP_THREADS * sweep_warps(num_chains, dim, sm_count)
        return SweepLayout(lanes, -(-dim // lanes), True)
    lanes = max(sweep_lanes(num_chains, sm_count), fewest)
    return SweepLayout(lanes, -(-dim // lanes), False)


def sweep_shared_bytes(dim: int) -> int:
    """The shared memory a block of the wide layout takes with B in it (csrc/gibbs.cu::wide_shared_bytes)."""
    return 4 * dim + SWEEP_EXCHANGE_BYTES


def sweep_scratch_numel(num_chains: int, num_data: int, lanes: int) -> int:
    """Floats of G1's scratch (csrc/gibbs.cu::rhmc_gibbs_sweep_scratch_floats): on a warp or more a
    chain, every chain's step constants; else none."""
    return SWEEP_FIELDS * num_data * num_chains if lanes >= SWEEP_THREADS else 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    ptr = ctypes.c_void_p
    lib.rhmc_gibbs_sweep.argtypes = [ptr] * 10 + [ctypes.c_int] * 5 + [ptr] * 4
    lib.rhmc_gibbs_sweep.restype = ctypes.c_int
    lib.rhmc_gibbs_sweep_max_entries.argtypes = []
    lib.rhmc_gibbs_sweep_max_entries.restype = ctypes.c_int
    lib.rhmc_gibbs_sweep_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.rhmc_gibbs_sweep_scratch_floats.restype = ctypes.c_longlong
    lib.rhmc_gibbs_sweep_shared_bytes.argtypes = [ctypes.c_int]
    lib.rhmc_gibbs_sweep_shared_bytes.restype = ctypes.c_longlong
    return lib


def choose_layout(num_chains: int, dim: int, *, sm_count: int = H100_SMS, shared_optin: int = H100_SHARED_OPTIN,
                  lanes: int | None = None, warps: int | None = None,
                  b_memory: str | None = None) -> tuple[SweepLayout, int]:
    """G1's layout and its code for the C entry (SWEEP_REGISTERS, SWEEP_WIDE_REGISTERS, SWEEP_WIDE_SHARED
    or SWEEP_WIDE_GLOBAL): ``sweep_layout`` by default, the wide layout's B in shared memory while
    ``sweep_shared_bytes(D)`` fits a block's ``shared_optin``.  Where the caller asks: B in registers on
    ``lanes`` lanes of a warp; the wide layout on ``warps`` warps (B in their registers where it fits);
    the wide layout with B in ``b_memory`` ("shared" or "global"), on ``warps`` or ``sweep_warps`` warps."""
    if lanes is not None:
        if warps is not None or b_memory is not None or lanes not in SWEEP_LANES or -(-dim // lanes) > SWEEP_ENT_MAX:
            raise ValueError(f"gibbs_sweep: B in registers on {lanes} lanes a chain at D = {dim}; the register layout "
                             f"takes {SWEEP_LANES} lanes of at most {SWEEP_ENT_MAX} entries")
        return SweepLayout(lanes, -(-dim // lanes), False), SWEEP_REGISTERS
    if b_memory is not None and b_memory not in SWEEP_B_MEMORY:
        raise ValueError(f"gibbs_sweep: b_memory takes {SWEEP_B_MEMORY}, got {b_memory!r}")
    if warps is None and b_memory is None:
        layout = sweep_layout(num_chains, dim, sm_count)
    else:
        warps = sweep_warps(num_chains, dim, sm_count) if warps is None else warps
        if not 1 <= warps <= SWEEP_MEMORY_WARPS:
            raise ValueError(f"gibbs_sweep: the wide layout takes 1 to {SWEEP_MEMORY_WARPS} warps, got {warps}")
        layout = SweepLayout(SWEEP_THREADS * warps, -(-dim // (SWEEP_THREADS * warps)), True)
    if not layout.wide:
        return layout, SWEEP_REGISTERS
    if b_memory is None and layout.in_registers:
        return layout, SWEEP_WIDE_REGISTERS
    shared = sweep_shared_bytes(dim) <= shared_optin
    if b_memory == "shared" and not shared:
        raise ValueError(f"gibbs_sweep: B in shared memory at D = {dim} takes {sweep_shared_bytes(dim)} bytes a "
                         f"block, more than the card's {shared_optin}")
    return layout, SWEEP_WIDE_SHARED if shared and b_memory != "global" else SWEEP_WIDE_GLOBAL


def launch_layout(num_chains: int, dim: int, device: torch.device, **forced) -> tuple[SweepLayout, int]:
    """``choose_layout`` for the SMs and the shared memory of ``device``."""
    props = torch.cuda.get_device_properties(device)
    return choose_layout(num_chains, dim, sm_count=props.multi_processor_count,
                         shared_optin=getattr(props, "shared_memory_per_block_optin", H100_SHARED_OPTIN), **forced)


def gibbs_sweep_cuda(x: Tensor, t: Tensor, lam: Tensor, h: Tensor, z_old: Tensor, s: Tensor, b: Tensor,
                     noise: truncnorm.TruncNormNoise, *, lanes: int | None = None, warps: int | None = None,
                     b_memory: str | None = None) -> tuple[Tensor, Tensor]:
    """Kernel G1 on the card: the arguments of ``gibbs_sweep_plain``, float32
    on one CUDA device, any D >= 1.  Returns (B (C, D), z (C, N)), new
    tensors.  An operand that is not contiguous (a rank's columns of the
    (N, C) uniforms under a chain split) is copied once.  The layout is
    ``choose_layout``'s for the device; ``lanes``, ``warps`` and ``b_memory``
    force one of the layouts, for checking and timing them against each other."""
    n, d = x.shape
    c = lam.shape[0]
    if d < 1:
        raise ValueError(f"the CUDA kernel takes D >= 1, got D = {d}")
    shapes = {"x": (x, (n, d)), "t": (t, (n,)), "lam": (lam, (c, n)), "h": (h, (c, n)), "z_old": (z_old, (c, n)),
              "s": (s, (c, d, n)), "b": (b, (c, d)), "u_central": (noise.u_central, (n, c)),
              "u_e": (noise.u_e, (truncnorm.RETRY_ROUNDS, n, c)), "u_tail": (noise.u_tail, (truncnorm.RETRY_ROUNDS, n, c))}
    for name, (tensor, shape) in shapes.items():
        if tensor.device.type != "cuda" or tensor.device != x.device:
            raise ValueError(f"gibbs_sweep: the CUDA kernel needs every tensor on x's CUDA device, got {name} on "
                             f"{tensor.device}")
        if tensor.dtype != torch.float32:
            raise TypeError(f"gibbs_sweep: the CUDA kernel takes float32, got {name} as {tensor.dtype}")
        if tuple(tensor.shape) != shape:
            raise ValueError(f"gibbs_sweep: {name} has shape {tuple(tensor.shape)}, expected {shape}")
    layout, code = launch_layout(c, d, x.device, lanes=lanes, warps=warps, b_memory=b_memory)
    ins = [tensor.contiguous() for tensor, _ in shapes.values()]  # themselves unless the caller's are strided
    b_out, z = torch.empty_like(ins[6]), torch.empty_like(ins[2])
    scratch = torch.empty(sweep_scratch_numel(c, n, layout.lanes), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().rhmc_gibbs_sweep(*(tensor.data_ptr() for tensor in ins), c, n, d, layout.lanes, code,
                                      scratch.data_ptr(), b_out.data_ptr(), z.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gibbs_sweep kernel launch failed with CUDA error {err}")
    launches.count("gibbs_sweep", x.device)
    return b_out, z


def sweep(model, state: GibbsState, cond: Conditionals, noise: truncnorm.TruncNormNoise) -> tuple[Tensor, Tensor]:
    """The sequential z / B sweep (``code/gibbs_sampler.py:109-126``): the
    plain version for a CPU batch, G1 for a CUDA one.  Returns (B after the
    sweep (C, D), z (C, N))."""
    args = (model.X, model.t, state.lam, cond.h, state.z, cond.s, cond.b, noise)
    if state.z.device.type == "cpu":
        return gibbs_sweep_plain(*args)
    return gibbs_sweep_cuda(*args)


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

    return Kernel(init, step, transition, draw_noise, noise_from_state=True, capturable=model_capturable(model))
