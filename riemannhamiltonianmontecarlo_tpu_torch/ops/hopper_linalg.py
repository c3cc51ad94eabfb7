"""Hand-written Hopper kernels for chain-batched small-matrix Cholesky.

The port of ``riemannhamiltonianmontecarlo_tpu/ops/pallas_linalg.py``:

* K1 ``cholesky(g)``: lower factor, (C, D, D) -> (C, D, D), upper triangle
  exactly 0.  Replaces ``pallas_linalg.cholesky`` (``pallas_call`` at
  ``pallas_linalg.py:116``).
* K2 ``chol_solve_logdet(g, b)``: fused factor + solve(G, b) + log|G|,
  (C, D, D), (C, D) -> (C, D), (C,).  Replaces
  ``pallas_linalg.chol_solve_logdet`` (``pallas_call`` at ``:150``).

and RMHMC's geometry, which the JAX package leaves to XLA:

* K3 ``chol_inv_logdet(g)``: L (K1's, bit for bit), G^-1 = L^-T L^-1
  (exactly symmetric) and 1/2 log|G| in one launch, (C, D, D) -> (C, D, D),
  (C, D, D), (C,).  Replaces no Pallas kernel: ``ops.cholesky`` followed by
  the unrolled ``inv_psd_from_chol`` and ``logdet_from_chol``
  (``riemannhamiltonianmontecarlo_tpu/ops/linalg.py:154-165``), ~230
  launches a call in eager PyTorch at D = 15.

Each has three functions.  ``<op>_cuda`` is the kernel's wrapper: it checks
the input (CUDA device, float32, shape, D <= 48), allocates the outputs with
``torch.empty``, launches the CUDA kernel of ``csrc/hopper_linalg.cu`` on the
current stream, counts the launch, and raises on anything else -- a CPU
tensor included.  The kernels read and write the public layout, contiguous
(C, D, D) and (C, D): a contiguous operand goes to the kernel as it is, with
no copy and no transposed view on the way in or out; only an operand that is
not contiguous is copied once.  ``<op>_plain`` is the plain-PyTorch twin: the
same unrolled outer-product elimination and substitutions (``_chol_body`` /
``_solve_body``; K3's, the three calls it replaces).  ``<op>`` is what the
rest of the port calls: the twin for a CPU tensor, the kernel for a CUDA
one, never a fallback from one to the other.

On the card a group of lanes owns one chain.  K1 and K2: a block owns a run
of neighbouring chains, staged through a shared-memory tile;
``launch_geometry(d)`` mirrors the source's choice of lanes per chain,
chains per block and tile size for every width.  K3: a warp owns a tile of
neighbouring chains and walks tiles with the grid's stride, the next one's
G on its way while it works one; ``k3_geometry(d)`` mirrors its layout and
``k3_schedule`` replays its walk and copies.

The library is built by ``ops._build`` at the first CUDA call, never at
import, so this module imports on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.ops import _build, launches

MAX_DIM = 48  # ops.linalg.UNROLL_MAX_DIM; the kernels' widest instantiation
THREADS_PER_BLOCK = 128
# Widths the kernels are unrolled for exactly; any other D <= MAX_DIM runs at
# the next of CAPACITIES with identity rows as padding (csrc: with_width).
EXACT_WIDTHS = (3, 5, 6, 7, 8, 14, 15, 25)
CAPACITIES = (4, 8, 16, 32, 48)
STATIC_SHARED_LIMIT = 48 * 1024  # bytes of shared memory a block gets without opting in
_KERNEL_DEVICE = "cuda"  # the only device type the wrappers launch on

_COUNTED = ("cholesky", "chol_solve_logdet", "chol_inv_logdet")  # their names in ops.launches


def launch_counts() -> dict[str, int]:
    """Launches of K1, K2 and K3 since the last reset (``ops.launches``)."""
    return launches.counts(_COUNTED)


def reset_launch_counts() -> None:
    launches.reset(_COUNTED)


class LaunchGeometry(NamedTuple):
    """How the kernels lay a width out on the card (csrc: ``Width``)."""

    lanes_per_chain: int  # a power of two, at most a warp
    rows_per_lane: int  # lane i holds rows i, i + lanes_per_chain
    chains_per_block: int
    row_stride: int  # floats between rows of the shared tile: odd, so no bank conflicts
    shared_bytes: int  # the block's tile


def launch_geometry(d: int) -> LaunchGeometry:
    """The source's launch geometry for width ``d``, mirrored in Python.

    ``rhmc_launch_geometry`` of the built library gives the source's own
    answer; ``chip_smoke.py`` holds the two against each other on the card.
    """
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"the CUDA kernel takes 1 <= D <= {MAX_DIM}, got D = {d}")
    rows = d if d in EXACT_WIDTHS else next(cap for cap in CAPACITIES if d <= cap)
    lanes = next((n for n in (4, 8, 16) if rows <= n), 32)
    chains = THREADS_PER_BLOCK // lanes
    stride = d | 1
    return LaunchGeometry(lanes, -(-rows // lanes), chains, stride, 4 * chains * d * stride)


class K3Geometry(NamedTuple):
    """How K3 lays a width out on the card (csrc: ``K3<W>``)."""

    lanes_per_chain: int  # as K1's
    rows_per_lane: int
    chains_per_warp: int  # a tile: a warp's neighbouring chains
    warps_per_block: int  # as many as keep the block within STATIC_SHARED_LIMIT, at most 4
    row_stride: int  # floats between rows of L^T: a multiple of 4, an odd number of 16-byte slots
    chain_stride: int  # floats between the chains' L^T: a multiple of 4, an odd number of 16-byte slots
    stage_floats: int  # one of a warp's two stages: a tile's run of G, then of L and G^-1
    shared_bytes: int  # the block's


K3_STAGES = 2  # a warp's stages: the tile it works and the next one's G arriving


def k3_geometry(d: int) -> K3Geometry:
    """K3's layout for width ``d`` (csrc: ``K3<W>``), mirrored in Python.

    ``rhmc_k3_geometry`` of the built library gives the source's own answer;
    ``chip_smoke.py`` holds the two against each other on the card.
    """
    geo = launch_geometry(d)
    n = d if d in EXACT_WIDTHS else next(cap for cap in CAPACITIES if d <= cap)
    chains = 32 // geo.lanes_per_chain
    pad = ((n + 3) // 4 | 1) * 4
    chain_stride = n * pad if n * pad // 4 % 2 else n * pad + 4
    stage = (chains * n * n + 6) // 4 * 4
    warp_floats = K3_STAGES * stage + chains * chain_stride
    warps = min(4, STATIC_SHARED_LIMIT // 4 // warp_floats)
    return K3Geometry(geo.lanes_per_chain, geo.rows_per_lane, chains, warps, pad, chain_stride, stage,
                      4 * warps * warp_floats)


class K3Copy(NamedTuple):
    """One warp's copy of a run of ``count`` floats starting ``first`` floats into its operand: ``head``
    floats 4 bytes each up to the first 16-byte boundary, ``chunks`` 16-byte chunks, the rest 4 bytes each."""

    first: int
    count: int
    head: int
    chunks: int
    tail: int


def k3_copy(first: int, count: int, base_shift: int) -> K3Copy:
    """The copy of floats ``first .. first + count`` of an operand whose data starts ``base_shift`` floats past
    a 16-byte boundary (csrc: ``K3Transport``'s load and store; the chunks go by one bulk copy)."""
    shift = (base_shift + first) % 4
    head = min(count, (4 - shift) % 4)
    chunks = (count - head) // 4
    return K3Copy(first, count, head, chunks, count - head - 4 * chunks)


def k3_blocks(c: int, d: int, resident_blocks: int) -> int:
    """K3's grid for C chains on a card that holds ``resident_blocks`` of its blocks at once (csrc: ``k3_blocks``):
    a block for every ``warps_per_block`` tiles, at most ``resident_blocks``."""
    geo = k3_geometry(d)
    tiles = -(-c // geo.chains_per_warp)
    return min(-(-tiles // geo.warps_per_block), resident_blocks)


def k3_schedule(c: int, d: int, blocks: int) -> list[list[int]]:
    """The tiles each warp of a ``blocks``-block grid walks, in order (csrc: the tile loop of
    ``chol_inv_logdet_kernel``): warp w takes tiles w, w + W, w + 2 W, ... for W warps in the grid."""
    geo = k3_geometry(d)
    tiles, warps = -(-c // geo.chains_per_warp), blocks * geo.warps_per_block
    return [list(range(w, tiles, warps)) for w in range(warps)]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rhmc_launch_geometry.argtypes = [i32, ctypes.POINTER(i32)]
    lib.rhmc_launch_geometry.restype = i32
    lib.rhmc_cholesky.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.rhmc_cholesky.restype = i32
    lib.rhmc_chol_solve_logdet.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.rhmc_chol_solve_logdet.restype = i32
    lib.rhmc_chol_inv_logdet.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.rhmc_chol_inv_logdet.restype = i32
    lib.rhmc_k3_geometry.argtypes = [i32, ctypes.POINTER(i32)]
    lib.rhmc_k3_geometry.restype = i32
    lib.rhmc_k3_grid.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.rhmc_k3_grid.restype = i32
    return lib


def built_launch_geometry(d: int) -> LaunchGeometry:
    """The built library's own geometry for width ``d`` (builds the library: needs the toolkit)."""
    out = (ctypes.c_int * 5)()
    err = _lib().rhmc_launch_geometry(d, out)
    if err != 0:
        raise RuntimeError(f"rhmc_launch_geometry({d}) failed with CUDA error {err}")
    return LaunchGeometry(*out)


def built_k3_geometry(d: int) -> K3Geometry:
    """The built library's own K3 layout for width ``d`` (builds the library: needs the toolkit)."""
    out = (ctypes.c_int * len(K3Geometry._fields))()
    err = _lib().rhmc_k3_geometry(d, out)
    if err != 0:
        raise RuntimeError(f"rhmc_k3_geometry({d}) failed with CUDA error {err}")
    return K3Geometry(*out)


def built_k3_grid(c: int, d: int) -> tuple[int, int]:
    """(blocks K3 launches for C chains of width d, blocks of it the current card holds at once), from the built
    library on the current device."""
    out = (ctypes.c_int * 2)()
    err = _lib().rhmc_k3_grid(c, d, out)
    if err != 0:
        raise RuntimeError(f"rhmc_k3_grid({c}, {d}) failed with CUDA error {err}")
    return out[0], out[1]


def _check_batch(g: Tensor, b: Tensor | None = None) -> None:
    if g.device.type != _KERNEL_DEVICE:
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {g.dtype}")
    if g.ndim != 3 or g.shape[1] != g.shape[2]:
        raise ValueError(f"expected a (C, D, D) batch, got shape {tuple(g.shape)}")
    if not 1 <= g.shape[-1] <= MAX_DIM:
        raise ValueError(f"the CUDA kernel takes 1 <= D <= {MAX_DIM}, got D = {g.shape[-1]}")
    if b is not None:
        if b.device != g.device or b.dtype != g.dtype or b.shape != g.shape[:2]:
            raise ValueError(
                f"rhs must be a {tuple(g.shape[:2])} {g.dtype} tensor on {g.device}, "
                f"got {tuple(b.shape)} {b.dtype} on {b.device}"
            )


def _launch(name: str, fn, tensors: tuple[Tensor, ...], c: int, d: int) -> None:
    for t in tensors:
        if not t.is_contiguous():  # the kernels' index arithmetic assumes it
            raise ValueError(f"{name}: kernel operand is not contiguous")
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), c, d, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    launches.count(name, device)


# -- K1: Cholesky ------------------------------------------------------------


def cholesky_plain(g: Tensor) -> Tensor:
    """Unrolled outer-product Cholesky on (..., D, D) (``_chol_body``)."""
    d = g.shape[-1]
    idx = torch.arange(d, device=g.device)
    rem = g
    cols = []
    for j in range(d):
        diag = torch.sqrt(rem[..., j, j])
        col = rem[..., :, j] / diag[..., None]
        col = torch.where(idx >= j, col, 0.0)
        cols.append(col)
        rem = rem - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def cholesky_cuda(g: Tensor) -> Tensor:
    """K1 on the card: (C, D, D) float32 CUDA -> lower factor, contiguous (C, D, D)."""
    _check_batch(g)
    c, d, _ = g.shape
    g = g.contiguous()  # g itself unless the caller's is strided
    l = torch.empty_like(g)
    if c > 0:
        _launch("cholesky", _lib().rhmc_cholesky, (g, l), c, d)
    return l


def cholesky(g: Tensor) -> Tensor:
    """Lower Cholesky factor of a (C, D, D) batch: twin on CPU, K1 on CUDA."""
    if g.device.type == "cpu":
        return cholesky_plain(g)
    return cholesky_cuda(g)


# -- K2: fused factor + solve + log-det ----------------------------------------


def chol_solve_logdet_plain(g: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Factor, forward + back substitution and log-det (``_solve_body``, ``_fused_kernel``)."""
    d = g.shape[-1]
    l = cholesky_plain(g)
    ys = []
    for i in range(d):  # L y = b
        s = b[..., i]
        for k in range(i):
            s = s - l[..., i, k] * ys[k]
        ys.append(s / l[..., i, i])
    xs: list = [None] * d
    for i in reversed(range(d)):  # L^T x = y
        s = ys[i]
        for k in range(i + 1, d):
            s = s - l[..., k, i] * xs[k]
        xs[i] = s / l[..., i, i]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), dim=-1)
    return torch.stack(xs, dim=-1), logdet


def chol_solve_logdet_cuda(g: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """K2 on the card: (C, D, D), (C, D) float32 CUDA -> x = G^-1 b (C, D), log|G| (C,)."""
    _check_batch(g, b)
    c, d, _ = g.shape
    g, b = g.contiguous(), b.contiguous()  # themselves unless the caller's are strided
    x = torch.empty_like(b)
    logdet = torch.empty(c, dtype=g.dtype, device=g.device)
    if c > 0:
        _launch("chol_solve_logdet", _lib().rhmc_chol_solve_logdet, (g, b, x, logdet), c, d)
    return x, logdet


def chol_solve_logdet(g: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Fused Cholesky + solve(G, b) + log|G|: twin on CPU, K2 on CUDA."""
    if g.device.type == "cpu":
        return chol_solve_logdet_plain(g, b)
    return chol_solve_logdet_cuda(g, b)


# -- K3: factor, inverse and half log-det (RMHMC's geometry) --------------------


def chol_inv_logdet_plain(g: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """L, G^-1 and 1/2 log|G| as the port computed them before K3, op for op:
    the unrolled factor, ``linalg.inv_psd_from_chol`` (the unrolled forward
    substitution against the identity and a matmul, D <= 48) and
    ``linalg.logdet_from_chol``."""
    from riemannhamiltonianmontecarlo_tpu_torch.ops import linalg  # it imports this module

    l = cholesky_plain(g)
    return l, linalg.inv_psd_from_chol(l), 0.5 * linalg.logdet_from_chol(l)


def _fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """float32 a * b + c rounded once, as the card's fused multiply-add: the
    product is exact in float64 and the sum is rounded to odd there, so that
    its one rounding to float32 is the correct one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    e = (p - (s - t)) + (c - t)  # s + e is p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    to_odd = (e != 0) & even & torch.isfinite(s)
    s = torch.where(to_odd, torch.nextafter(s, torch.where(e > 0, torch.inf, -torch.inf).to(s)), s)
    return s.float()


def inv_in_kernel_order(l: Tensor) -> Tensor:
    """G^-1 from a lower factor L, (C, D, D) float32, with K3's operations in
    K3's order, for the tests and ``chip_smoke.py`` to hold the kernel to bit
    for bit: column c of L^-1 by s_i -= L[i][k] y_k (one fused multiply-add,
    k ascending, as the twin's substitution orders its terms) and
    y_k = s_k * (1 / L[k][k]) where the twin divides; then
    G^-1[a][b] = sum over k from b of L^-1[k][a] L^-1[k][b], fused
    multiply-adds in ascending k from 0."""
    d = l.shape[-1]
    rinv = 1.0 / torch.diagonal(l, dim1=-2, dim2=-1)
    y = torch.eye(d, dtype=l.dtype, device=l.device).expand(l.shape).clone()  # y[:, c, i]: column c, row i
    for k in range(d):
        y[..., k] = y[..., k] * rinv[..., k, None]
        for i in range(k + 1, d):
            y[..., i] = _fma32(-l[..., i, k, None], y[..., k], y[..., i])
    inv = torch.empty_like(l)
    for b in range(d):
        acc = torch.zeros_like(l[..., 0])
        for k in range(b, d):
            acc = _fma32(y[..., k], y[..., b, k, None], acc)
        inv[..., b] = acc
    return inv


def chol_inv_logdet_cuda(g: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """K3 on the card: (C, D, D) float32 CUDA -> L (C, D, D), G^-1 (C, D, D), 1/2 log|G| (C,)."""
    _check_batch(g)
    c, d, _ = g.shape
    g = g.contiguous()  # g itself unless the caller's is strided
    l, inv = torch.empty_like(g), torch.empty_like(g)
    half_logdet = torch.empty(c, dtype=g.dtype, device=g.device)
    if c > 0:
        _launch("chol_inv_logdet", _lib().rhmc_chol_inv_logdet, (g, l, inv, half_logdet), c, d)
    return l, inv, half_logdet


def chol_inv_logdet(g: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Cholesky factor, inverse and half log-determinant: twin on CPU, K3 on CUDA."""
    if g.device.type == "cpu":
        return chol_inv_logdet_plain(g)
    return chol_inv_logdet_cuda(g)
