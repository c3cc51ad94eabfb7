"""Port parity: the batched tridiagonal ops against the JAX package's.

The same numpy-seeded diagonally dominant PD systems go through both
``ops.tridiag`` modules at T in {1, 2, 3, 5, 7, 64, 1025, 2000, 2049} (at
T = 1 the JAX factor is its scan's first step: the scan itself refuses
T = 1), and StochVol's latent metric (off an expanded view, phi up to
0.999) and HMC's identity mass at T in {2, 1025, 2000}.  Tolerance: atol
1e-5 times the scale of the reference output (max |ref|), float32 on both
sides; the PCR solve runs the JAX package's operations in its order over
ceil(log2 T) rounds, the bidiagonal factor the same length-T recurrence on
the pivots q_t = ld_t^2 (the JAX scan walks ld_t: the roundings differ).

The kernels T1 (the factor) and T2 (the solve) of ``csrc/tridiag.cu`` run
only on a card (``chip_smoke.py`` holds them against ``cholesky_plain`` and
``solve_plain`` there).  Here: the plain twins against the JAX package, their
edge cases, ``solve_plain`` against the JAX package on a system whose a
and c decay through subnormal values and at T = 14,528 (T2's largest
one-launch system), that a CPU tensor never launches, what the wrappers hand
to the launch and what they refuse before it, T2's launch geometry mirrored
from the source and its schedule replayed from that geometry (which rounds
read shared memory, which the thread's own slots), the solves a StochVol
latent update makes, and ``chip_smoke.py``'s bounds.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from riemannhamiltonianmontecarlo_tpu.ops import tridiag as jtri
from riemannhamiltonianmontecarlo_tpu_torch import interop
from riemannhamiltonianmontecarlo_tpu_torch.ops import _build
from riemannhamiltonianmontecarlo_tpu_torch.ops import tridiag as ttri
from riemannhamiltonianmontecarlo_tpu_torch.samplers import stochvol as tsv

torch.set_num_threads(1)
BATCH = 4


def system(t: int):
    rng = np.random.default_rng(t)
    off = (rng.normal(size=(BATCH, t - 1)) * 0.4).astype(np.float32)
    diag = (2.0 + rng.uniform(size=(BATCH, t))).astype(np.float32)
    b = rng.normal(size=(BATCH, t)).astype(np.float32)
    return diag, off, b


def jax_cholesky(jd, jo):
    """The JAX package's factor.  At T = 1 its scan refuses the inputs (the zero it pads ``off`` with is cut
    from the empty ``off``), so there it is the scan body's first step: e_0 = 0 / 1, ld_0 = sqrt(d_0 - e_0^2)."""
    if jd.shape[-1] > 1:
        return jtri.cholesky(jd, jo)
    e0 = jnp.zeros_like(jd) / jnp.ones_like(jd)
    return jtri.TridiagChol(jnp.sqrt(jd - e0 * e0), jo)


def close(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max(initial=0.0)))


@pytest.mark.parametrize("t", [1, 2, 3, 5, 7, 64, 1025, 2000, 2049])
def test_torch_tridiag_ops_match_jax(t):
    diag, off, b = system(t)
    jd, jo, jb = jnp.asarray(diag), jnp.asarray(off), jnp.asarray(b)
    td, to, tb = torch.from_numpy(diag), torch.from_numpy(off), torch.from_numpy(b)

    jchol, tchol = jax_cholesky(jd, jo), ttri.cholesky_plain(td, to)
    assert tchol.ld.shape == (BATCH, t) and tchol.e.shape == (BATCH, t - 1)
    assert all(torch.equal(a, b) for a, b in zip(ttri.cholesky(td, to), tchol))  # a CPU tensor takes the twin
    close(tchol.ld, jchol.ld)
    close(tchol.e, jchol.e)
    close(ttri.logdet_from_chol(tchol), jtri.logdet_from_chol(jchol))
    close(ttri.matvec_chol(tchol, tb), jtri.matvec_chol(jchol, jb))
    close(ttri.matvec(td, to, tb), jtri.matvec(jd, jo, jb))
    x = ttri.solve(td, to, tb)
    assert torch.equal(x, ttri.solve_plain(td, to, tb))  # a CPU tensor takes the twin
    close(x, jtri.solve(jd, jo, jb))
    # and it solves the system
    close(ttri.matvec(td, to, x), b)


def latent_system(case: str, t: int, phi: float = 0.95, sigma: float = 0.2):
    """StochVol's latent metric G = AR(1) precision + I/2 at (phi, sigma) for each chain, off an expanded view
    as ``models/stochvol.py`` makes it, or HMC's identity mass; numpy-seeded b."""
    rng = np.random.default_rng(t + 17)
    b = rng.normal(size=(BATCH, t)).astype(np.float32)
    if case == "identity":
        return np.ones((BATCH, t), np.float32), np.zeros((BATCH, t - 1), np.float32), b, False
    phis = np.float32(phi) - np.float32(0.01) * np.arange(BATCH, dtype=np.float32)
    inv_s2 = np.float32(1.0) / np.float32(sigma) ** 2
    diag = np.full((BATCH, t), inv_s2, np.float32)
    diag[:, 1:-1] = ((1 + phis**2) * inv_s2)[:, None]
    diag = (diag + np.float32(0.5)).astype(np.float32)
    off = np.broadcast_to((-phis * inv_s2).astype(np.float32)[:, None], (BATCH, t - 1))
    return diag, off, b, True


@pytest.mark.parametrize("t", [2, 1025, 2000])
@pytest.mark.parametrize("case", ["metric", "near-unit-phi", "identity"])
def test_torch_tridiag_latent_systems_match_jax(case, t):
    """The plain twins on the systems StochVol hands them (off an expanded view; phi 0.999, sigma 0.05 near the
    AR(1)'s unit root; HMC's identity mass, where the solve returns b and the factor ld 1, e 0 exactly)
    against the JAX package at the tolerance above."""
    kw = dict(phi=0.999, sigma=0.05) if case == "near-unit-phi" else {}
    diag, off, b, expanded = latent_system("identity" if case == "identity" else "metric", t, **kw)
    td, tb = torch.from_numpy(diag), torch.from_numpy(b)
    to = torch.from_numpy(off[:, :1].copy()).expand(BATCH, t - 1) if expanded else torch.from_numpy(off)
    jd, jo, jb = jnp.asarray(diag), jnp.asarray(np.ascontiguousarray(off)), jnp.asarray(b)
    chol, jchol = ttri.cholesky_plain(td, to), jtri.cholesky(jd, jo)
    close(chol.ld, jchol.ld)
    close(chol.e, jchol.e)
    x = ttri.solve_plain(td, to, tb)
    close(x, jtri.solve(jd, jo, jb))
    if case != "near-unit-phi":  # there G's condition (~1e3) puts float32 PCR's residual past 1e-5 of b, the JAX's too
        close(ttri.matvec(td, to, x), b)
    if case == "identity":
        assert torch.equal(x, tb) and bool((chol.ld == 1).all()) and bool((chol.e == 0).all())


def decay_system(t: int):
    """A numpy-seeded system with diag >> |off| (a ratio of 1e-3 to 1e-1 by chain): PCR's a and c shrink by
    powers of that ratio round after round, through the subnormal floats on their way to zero."""
    rng = np.random.default_rng(t + 29)
    scale = 10.0 ** rng.uniform(1.0, 3.0, size=(BATCH, 1))
    diag = (scale * (1.0 + rng.uniform(size=(BATCH, t)))).astype(np.float32)
    return diag, rng.normal(size=(BATCH, t - 1)).astype(np.float32), rng.normal(size=(BATCH, t)).astype(np.float32)


@pytest.mark.parametrize("case,t", [("decay", 2000), ("largest-one-launch", ttri.PCR_SHARED_MAX_T)])
def test_torch_pcr_solve_plain_matches_jax(case, t):
    """``solve_plain`` (T2's twin, bit for bit T2 on the card) against the JAX package's PCR at the tolerance above:
    on a system whose a and c pass through subnormal values (``chip_smoke.pcr_meets_subnormals``, phase 3's check
    of its own decay case), and at T = 14,528, the most positions T2 solves in one launch."""
    diag, off, b = decay_system(t) if case == "decay" else system(t)
    td, to, tb = torch.from_numpy(diag), torch.from_numpy(off), torch.from_numpy(b)
    assert chip_smoke.pcr_meets_subnormals(td, to, tb) or case != "decay"
    x = ttri.solve_plain(td, to, tb)
    close(x, jtri.solve(jnp.asarray(diag), jnp.asarray(off), jnp.asarray(b)))
    close(ttri.matvec(td, to, x), b)


def test_torch_tridiag_factor_reproduces_the_matrix():
    """L L^T == G in float64: ld^2 + e^2 on the diagonal, ld e below it."""
    diag, off, _ = system(50)
    chol = ttri.cholesky(torch.from_numpy(diag).double(), torch.from_numpy(off).double())
    ld, e = chol.ld.numpy(), chol.e.numpy()
    np.testing.assert_allclose(ld**2 + np.pad(e**2, ((0, 0), (1, 0))), diag, rtol=1e-12)
    np.testing.assert_allclose(ld[:, :-1] * e, off, rtol=1e-12)


@pytest.mark.parametrize("case", ["non-pd", "identity"])
def test_torch_bidiag_cholesky_plain_edge_cases(case):
    """A chain with d_t < e_t^2 is NaN from t on, in its own row; HMC's identity mass gives ld 1, e 0 exactly."""
    diag, off, _ = system(40)
    if case == "identity":
        diag, off = np.ones_like(diag), np.zeros_like(off)
    else:
        diag[2, 17] = -1.0
    chol = ttri.cholesky_plain(torch.from_numpy(diag), torch.from_numpy(off))
    ld, e = chol.ld.numpy(), chol.e.numpy()
    if case == "identity":
        assert (ld == 1.0).all() and (e == 0.0).all()
    else:
        assert np.isnan(ld[2, 17:]).all() and np.isnan(e[2, 17:]).all() and np.isfinite(ld[2, :17]).all()
        assert np.isfinite(np.delete(ld, 2, 0)).all() and np.isfinite(np.delete(e, 2, 0)).all()


@pytest.mark.parametrize("method,solves", [("rmhmc", 50 + 2), ("hmc", 50 + 2), ("mmala", 3), ("mala", 0)])
def test_torch_stochvol_latent_update_solves(monkeypatch, method, solves):
    """A latent update solves with its metric through ``tridiag.solve`` (T2 on a card) once a leapfrog step and
    twice for the kinetic energies under rmhmc and hmc (L + 2, L = 50 by default), three times under mmala,
    never under mala; a CPU state takes ``solve_plain``, never the kernel's wrapper."""
    rng = np.random.default_rng(0)
    y = rng.normal(size=30).astype(np.float32)
    model = interop.stochvol_from_numpy(y, device="cpu")
    calls = []
    monkeypatch.setattr(ttri, "solve_plain", lambda d, o, b, inner=ttri.solve_plain: calls.append(1) or inner(d, o, b))
    monkeypatch.setattr(ttri, "solve_cuda", lambda *a: pytest.fail("a CPU tensor reached the kernel's wrapper"))
    x = torch.from_numpy(rng.normal(size=(3, 30)).astype(np.float32))
    theta = torch.tensor([[0.6, -1.9, 2.0]] * 3)
    noise = tsv.StochVolNoise(torch.randn(3, 30), torch.rand(3), torch.rand(3), torch.rand(3), None)
    config = tsv.StochVolConfig(method=method)
    assert config.latent_num_leapfrog == 50
    tsv.latent_update(model, config, x, theta, noise)
    assert len(calls) == solves


@pytest.mark.parametrize("method,factors", [("rmhmc", 1), ("hmc", 1), ("mmala", 1), ("mala", 0)])
def test_torch_stochvol_latent_update_factors_once(monkeypatch, method, factors):
    """Every latent update of rmhmc, hmc and mmala factors its metric once through ``tridiag.cholesky``
    (T1 on a card); a CPU state takes the plain loop, never the kernel's wrapper."""
    rng = np.random.default_rng(0)
    y = rng.normal(size=30).astype(np.float32)
    model = interop.stochvol_from_numpy(y, device="cpu")
    calls = []
    monkeypatch.setattr(ttri, "cholesky_plain", lambda d, o, inner=ttri.cholesky_plain: calls.append(1) or inner(d, o))
    monkeypatch.setattr(ttri, "cholesky_cuda", lambda *a: pytest.fail("a CPU tensor reached the kernel's wrapper"))
    x = torch.from_numpy(rng.normal(size=(3, 30)).astype(np.float32))
    theta = torch.tensor([[0.6, -1.9, 2.0]] * 3)
    noise = tsv.StochVolNoise(torch.randn(3, 30), torch.rand(3), torch.rand(3), torch.rand(3), None)
    tsv.latent_update(model, tsv.StochVolConfig(method=method), x, theta, noise)
    assert len(calls) == factors


def test_torch_bidiag_cholesky_cpu_tensors_never_launch():
    diag, off, _ = system(9)
    ttri.reset_launch_counts()
    ttri.cholesky(torch.from_numpy(diag), torch.from_numpy(off))
    assert ttri.launch_counts() == {"bidiag_cholesky": 0, "pcr_solve": 0}


def test_torch_pcr_solve_cpu_tensors_never_launch(monkeypatch):
    diag, off, b = system(9)
    monkeypatch.setattr(ttri, "solve_cuda", lambda *a: pytest.fail("a CPU tensor reached T2's wrapper"))
    ttri.reset_launch_counts()
    ttri.solve(torch.from_numpy(diag), torch.from_numpy(off), torch.from_numpy(b))
    assert ttri.launch_counts() == {"bidiag_cholesky": 0, "pcr_solve": 0}


@pytest.fixture
def recorded_launches(monkeypatch):
    """T1's wrapper with the card patched away: CPU tensors pass the device check and ``_launch`` records."""
    seen = []
    monkeypatch.setattr(ttri, "_KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(ttri, "_launch", lambda tensors, b, t: seen.append((tensors, b, t)))
    return seen


@pytest.mark.parametrize("bad", ["cpu", "dtype", "shape", "no-positions"])
def test_torch_bidiag_cholesky_cuda_refuses(monkeypatch, bad):
    diag, off = torch.ones((4, 6)), torch.zeros((4, 5))
    if bad == "cpu":  # the real device check
        with pytest.raises(ValueError, match="CUDA tensors"):
            ttri.cholesky_cuda(diag, off)
        return
    seen = []
    monkeypatch.setattr(ttri, "_KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(ttri, "_launch", lambda *args: seen.append(args))
    if bad == "dtype":
        with pytest.raises(TypeError, match="float32"):
            ttri.cholesky_cuda(diag.double(), off.double())
    elif bad == "shape":
        with pytest.raises(ValueError, match="off must have shape"):
            ttri.cholesky_cuda(diag, off[:, :4])
    else:
        with pytest.raises(ValueError, match="T >= 1"):
            ttri.cholesky_cuda(torch.ones((4, 0)), torch.zeros((4, 0)))
    assert seen == []


@pytest.mark.parametrize("shape", [(4, 6), (2, 3, 6), (5, 1)], ids=["chains", "leading-axes", "one-position"])
def test_torch_bidiag_cholesky_cuda_hands_over_flat_contiguous_rows(recorded_launches, shape):
    """(B, T) rows of the leading axes flattened: a contiguous diag with no copy, StochVol's expanded off
    (stride 0 along T) as a view of its own storage, never copied (the kernel reads it through its strides);
    ld and e contiguous, shaped as diag and off."""
    diag = torch.rand(shape) + 2.0
    off = torch.full(shape[:-1] + (1,), -0.3).expand(shape[:-1] + (shape[-1] - 1,))
    ld, e = ttri.cholesky_cuda(diag, off)
    ((d_seen, o_seen, ld_seen, e_seen), b, t), = recorded_launches
    assert (b, t) == (int(np.prod(shape[:-1])), shape[-1])
    assert d_seen.data_ptr() == diag.data_ptr() and d_seen.shape == (b, t)
    assert o_seen.shape == (b, t - 1) and torch.equal(o_seen, off.reshape(b, t - 1))
    assert o_seen.data_ptr() == off.data_ptr() and (t == 1 or o_seen.stride() == (1, 0))
    assert ld.shape == diag.shape and e.shape == off.shape and ld.is_contiguous() and e.is_contiguous()
    assert ld_seen.data_ptr() == ld.data_ptr() and e_seen.data_ptr() == e.data_ptr()


def test_torch_bidiag_cholesky_cuda_launches_nothing_on_an_empty_batch(recorded_launches):
    ld, e = ttri.cholesky_cuda(torch.ones((0, 7)), torch.zeros((0, 6)))
    assert ld.shape == (0, 7) and e.shape == (0, 6) and recorded_launches == []


def test_torch_bidiag_kernel_name_is_apart_from_k1s():
    """chip_smoke matches device events to kernels by a part of their names: T1's and T2's name parts hold no
    other kernel's, and the source's three kernels are T1's and T2's two forms, each matched by its own part."""
    src = (_build.CSRC_DIR / "tridiag.cu").read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?\s+(\w+)\(", src)
    assert kernels == [chip_smoke.BIDIAG_KERNEL_NAME, "pcr_solve_kernel", "pcr_solve_global_kernel"]
    assert all(chip_smoke.PCR_KERNEL_NAME in name for name in kernels[1:])
    assert chip_smoke.PCR_KERNEL_NAME not in chip_smoke.BIDIAG_KERNEL_NAME
    others = {**chip_smoke.KERNEL_NAMES, **chip_smoke.GIBBS_KERNEL_NAMES, "fhn": chip_smoke.FHN_KERNEL_NAME}
    for part in (chip_smoke.BIDIAG_KERNEL_NAME, chip_smoke.PCR_KERNEL_NAME):
        assert not any(other in part for other in others.values())
        assert not any(part in other for other in others.values())


# Bytes T1 must move (diag and off read once, ld and e written once) over 3.35 TB/s, in microseconds.
@pytest.mark.parametrize("b,t,expected_us", [(1024, 2000, 4 * 2 * 1024 * 3999 / 3.35e6), (3, 1, 24 / 3.35e6)])
def test_torch_chip_smoke_bidiag_bound_us(b, t, expected_us):
    us, bound_by = chip_smoke.bidiag_bound_us(b, t)
    assert us == pytest.approx(expected_us, rel=1e-12) and bound_by == "bytes"


@pytest.mark.parametrize("b,t,expected_us", [(1024, 2000, 4 * (3 * 1024 * 2000 + 1024) / 3.35e6),
                                             (3, 1, 4 * (3 * 3 + 3) / 3.35e6)])
def test_torch_chip_smoke_pcr_bound_us(b, t, expected_us):
    """T2's bound: diag and b read once, x written once, StochVol's expanded off one float a row, over 3.35 TB/s
    (24.6 MB, 7.3 us at (1024, 2000)); its 14 operations a position and round (11 rounds there) are fewer."""
    us, bound_by = chip_smoke.pcr_bound_us(b, t)
    assert us == pytest.approx(expected_us, rel=1e-12) and bound_by == "bytes"
    rounds = (t - 1).bit_length()
    assert 1e6 * b * t * (14 * rounds + 1) / chip_smoke.FP32_OPS_PER_S < us


def cuda_source_constant(name: str) -> int:
    src = (_build.CSRC_DIR / "tridiag.cu").read_text()
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
    return int(value)


def test_torch_pcr_geometry_mirrors_the_source():
    """T2's shared-memory cut-over and launch geometry, mirrored from ``csrc/tridiag.cu`` (``chip_smoke.py`` holds the
    mirror against the built library at ``PCR_GEOMETRY_T``): a 16-byte slot a position in a block's 227 KB up to
    ``PCR_SHARED_MAX_T``, 2^ceil(log2 T) / 8 threads (a power of two, 32 to 1024) of the power of two of positions
    that covers T; past it ceil(log2 T) launches through a workspace of 8 T floats a row."""
    assert ttri.PCR_SHARED_BYTES == cuda_source_constant("kPcrSharedBytes") == 227 * 1024
    assert ttri.PCR_SLOT_BYTES == cuda_source_constant("kPcrSlotBytes") == 16
    assert ttri.PCR_SHARED_MAX_T == ttri.PCR_SHARED_BYTES // 16 == 14528
    assert ttri.PCR_POSITIONS_A_THREAD == cuda_source_constant("kPcrPositionsAThread")
    assert ttri.PCR_MAX_THREADS == cuda_source_constant("kPcrMaxThreads")
    assert ttri.PCR_GLOBAL_THREADS == cuda_source_constant("kPcrGlobalThreads")
    max_per = cuda_source_constant("kPcrMaxPer")
    for t in [*range(1, 300), 1025, 2000, 2049, 4096, 8192, 8193, 14527, 14528]:
        g = ttri.pcr_geometry(t)
        assert g.threads & (g.threads - 1) == 0 and 32 <= g.threads <= ttri.PCR_MAX_THREADS
        assert g.per_thread in (1, 2, 4, 8, max_per) and g.threads * g.per_thread >= t
        assert g.per_thread == 1 or g.threads * g.per_thread // 2 < t  # the smallest power of two that covers T
        assert (g.shared_bytes, g.launches, g.workspace) == (16 * t, 1, 0) and g.shared_bytes <= ttri.PCR_SHARED_BYTES
    assert ttri.pcr_geometry(2000) == ttri.PcrGeometry(256, 8, 32000, 1, 0)
    assert ttri.pcr_geometry(1025) == ttri.PcrGeometry(256, 8, 16400, 1, 0)
    assert ttri.pcr_geometry(100) == ttri.PcrGeometry(32, 4, 1600, 1, 0)
    assert ttri.pcr_geometry(14528) == ttri.PcrGeometry(1024, 16, 232448, 1, 0)
    for t, rounds in ((14529, 14), (16384, 14), (16385, 15), (20000, 15), (1 << 20, 20)):
        assert ttri.pcr_geometry(t) == ttri.PcrGeometry(ttri.PCR_GLOBAL_THREADS, 0, 0, rounds, 8 * t)
    assert {ttri.PCR_SHARED_MAX_T, ttri.PCR_SHARED_MAX_T + 1} <= set(chip_smoke.PCR_GEOMETRY_T)
    assert chip_smoke.PCR_LONG[1] > ttri.PCR_SHARED_MAX_T


@pytest.mark.parametrize("t", [1, 2, 3, 31, 33, 100, 1025, 2000, 2049, 8192, 14528])
def test_torch_pcr_kernel_ownership_map(t):
    """T2's schedule replayed from ``pcr_geometry`` with the kernel's own conditions: thread ``tid`` holds position
    i = tid + j blockDim in its slot j, live where j < per / 2 (unchecked) or i < T, every position exactly once.
    The rounds s < blockDim publish the live slots and read i -+ s only where they are published in that round
    (inside the block's T slots), with the checks the kernel drops (i - s for j >= 1, i + s for j < per / 2 - 1)
    always true; the rounds s >= blockDim read i -+ s in the thread's own slot j -+ s / blockDim, unchecked, so a
    slot there is live exactly where its position is below T.  Together: the ceil(log2 T) rounds of
    ``solve_plain``."""
    g = ttri.pcr_geometry(t)
    threads, per = g.threads, g.per_thread
    tid, j = np.meshgrid(np.arange(threads), np.arange(per), indexing="ij")
    i = tid + j * threads
    live = (j < per // 2) | (i < t)
    assert (i[j < per // 2] < t).all() and sorted(i[live]) == list(range(t))
    published = np.zeros(t, bool)
    published[i[live]] = True  # the only slots a round writes: no write past the T slots
    rounds, s = [], 1
    while s < threads and s < t:  # through the slots in shared memory
        lo = live & ((j > 0) | (i >= s))
        hi = live & ((j + 1 < per // 2) | (i + s < t))
        assert (i[lo] - s >= 0).all() and (i[hi] + s < t).all()
        assert published[i[lo] - s].all() and published[i[hi] + s].all()
        rounds.append(s)
        s *= 2
    for m in (1 << k for k in range(per.bit_length() - 1)):  # in registers: m = 1, 2, ..., per / 2
        s = m * threads
        assert s < t
        lo, hi = live & (j >= m), live & (j + m < per)
        assert (i[lo] - s == (tid + (j - m) * threads)[lo]).all() and (i[lo] - s >= 0).all()
        assert (live[:, m:] == (i[:, m:] < t)).all()  # a neighbour at i + s >= T is an identity slot
        assert (live & (i + s < t) == hi & (i + s < t)).all()
        rounds.append(s)
    assert rounds == [1 << k for k in range((t - 1).bit_length())]


@pytest.fixture
def recorded_solves(monkeypatch):
    """T2's wrapper with the card patched away: CPU tensors pass the device check and ``_launch_solve``
    records."""
    seen = []
    monkeypatch.setattr(ttri, "_KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(ttri, "_launch_solve", lambda *args: seen.append(args))
    return seen


@pytest.mark.parametrize("shape", [(4, 6), (2, 3, 6), (5, 1), (2, 20000)],
                         ids=["chains", "leading-axes", "one-position", "past-shared-memory"])
def test_torch_pcr_solve_cuda_hands_over_flat_rows(recorded_solves, shape):
    """(B, T) rows of the leading axes flattened: diag and a contiguous b with no copy, StochVol's expanded off
    as a view of its own storage (stride 0 along T, never copied), x contiguous and shaped as b; a workspace of
    8 T floats a row only past the shared-memory form."""
    diag, rhs = torch.rand(shape) + 2.0, torch.randn(shape)
    off = torch.full(shape[:-1] + (1,), -0.3).expand(shape[:-1] + (shape[-1] - 1,))
    x = ttri.solve_cuda(diag, off, rhs)
    (d_seen, o_seen, b_seen, x_seen, workspace, b, t), = recorded_solves
    assert (b, t) == (int(np.prod(shape[:-1])), shape[-1])
    assert d_seen.data_ptr() == diag.data_ptr() and d_seen.shape == (b, t)
    assert b_seen.data_ptr() == rhs.data_ptr() and b_seen.shape == (b, t)
    assert o_seen.data_ptr() == off.data_ptr() and o_seen.shape == (b, t - 1)
    assert torch.equal(o_seen, off.reshape(b, t - 1))
    assert t == 1 or o_seen.stride() == (1, 0)
    assert x.shape == rhs.shape and x_seen.data_ptr() == x.data_ptr() and x_seen.is_contiguous()
    if t > ttri.PCR_SHARED_MAX_T:
        assert workspace.numel() == b * 8 * t
    else:
        assert workspace is None


def test_torch_pcr_solve_cuda_copies_a_strided_b_and_reads_a_contiguous_off(recorded_solves):
    """A non-contiguous b (and diag) is copied once into contiguous rows; HMC's contiguous zero off goes as it
    is, strides (T - 1, 1)."""
    diag = (torch.rand((3, 14)) + 2.0)[:, ::2]
    rhs = torch.randn((3, 14))[:, ::2]
    off = torch.zeros((3, 6))
    ttri.solve_cuda(diag, off, rhs)
    (d_seen, o_seen, b_seen, _, _, b, t), = recorded_solves
    assert (b, t) == (3, 7)
    assert d_seen.is_contiguous() and torch.equal(d_seen, diag) and d_seen.data_ptr() != diag.data_ptr()
    assert b_seen.is_contiguous() and torch.equal(b_seen, rhs) and b_seen.data_ptr() != rhs.data_ptr()
    assert o_seen.data_ptr() == off.data_ptr() and o_seen.stride() == (6, 1)


@pytest.mark.parametrize("bad", ["cpu", "dtype", "off-shape", "b-shape", "b-device", "no-positions"])
def test_torch_pcr_solve_cuda_refuses(monkeypatch, bad):
    """T2's wrapper refuses, before any launch, what the kernel does not take."""
    diag, off, rhs = torch.ones((4, 6)), torch.zeros((4, 5)), torch.randn((4, 6))
    if bad == "cpu":  # the real device check
        with pytest.raises(ValueError, match="CUDA tensors"):
            ttri.solve_cuda(diag, off, rhs)
        return
    seen = []
    monkeypatch.setattr(ttri, "_KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(ttri, "_launch_solve", lambda *args: seen.append(args))
    if bad == "dtype":
        with pytest.raises(TypeError, match="float32"):
            ttri.solve_cuda(diag, off, rhs.double())
    elif bad == "off-shape":
        with pytest.raises(ValueError, match="off must have shape"):
            ttri.solve_cuda(diag, off[:, :4], rhs)
    elif bad == "b-shape":
        with pytest.raises(ValueError, match="b must have diag's shape"):
            ttri.solve_cuda(diag, off, rhs[:2])
    elif bad == "b-device":
        with pytest.raises(ValueError, match="CUDA tensors"):
            ttri.solve_cuda(diag, off, rhs.to("meta"))
    else:
        with pytest.raises(ValueError, match="T >= 1"):
            ttri.solve_cuda(torch.ones((4, 0)), torch.zeros((4, 0)), torch.ones((4, 0)))
    assert seen == []


def test_torch_pcr_solve_cuda_launches_nothing_on_an_empty_batch(recorded_solves):
    x = ttri.solve_cuda(torch.ones((0, 7)), torch.zeros((0, 6)), torch.ones((0, 7)))
    assert x.shape == (0, 7) and recorded_solves == []
