"""Port parity: the batched tridiagonal ops against the JAX package's.

The same numpy-seeded diagonally dominant PD systems go through both
``ops.tridiag`` modules at T in {1, 2, 7, 64, 2000} (at T = 1 the JAX
factor is its scan's first step: the scan itself refuses T = 1).  Tolerance: atol 1e-5
times the scale of the reference output (max |ref|), float32 on both sides
with the same operations in the same order; the bidiagonal factor is a
length-T recurrence and the PCR solve ceil(log2 T) rounds.

The factor's kernel T1 (``csrc/tridiag.cu``) runs only on a card
(``chip_smoke.py`` holds it against ``cholesky_plain`` there).  Here: the
plain twin against the JAX ``lax.scan``, its edge cases, that a CPU tensor
never launches, what the wrapper hands to the launch, the launch geometry
mirrored from the source, and ``chip_smoke.py``'s bound.
"""

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


@pytest.mark.parametrize("t", [1, 2, 7, 64, 2000])
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
    close(x, jtri.solve(jd, jo, jb))
    # and it solves the system
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
    assert ttri.launch_counts() == {"bidiag_cholesky": 0}


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
    (stride 0 along T) copied once; ld and e shaped as diag and off."""
    diag = torch.rand(shape) + 2.0
    off = torch.full(shape[:-1] + (1,), -0.3).expand(shape[:-1] + (shape[-1] - 1,))
    ld, e = ttri.cholesky_cuda(diag, off)
    ((d_seen, o_seen, ld_seen, e_seen), b, t), = recorded_launches
    assert (b, t) == (int(np.prod(shape[:-1])), shape[-1])
    assert d_seen.data_ptr() == diag.data_ptr() and d_seen.shape == (b, t)
    assert o_seen.is_contiguous() and o_seen.shape == (b, t - 1) and torch.equal(o_seen, off.reshape(b, t - 1))
    assert ld.shape == diag.shape and e.shape == off.shape
    assert ld_seen.data_ptr() == ld.data_ptr() and e_seen.data_ptr() == e.data_ptr()


def test_torch_bidiag_cholesky_cuda_launches_nothing_on_an_empty_batch(recorded_launches):
    ld, e = ttri.cholesky_cuda(torch.ones((0, 7)), torch.zeros((0, 6)))
    assert ld.shape == (0, 7) and e.shape == (0, 6) and recorded_launches == []


def test_torch_bidiag_kernel_name_is_apart_from_k1s():
    """chip_smoke matches device events to kernels by a part of their names: T1's holds no other kernel's."""
    src = (_build.CSRC_DIR / "tridiag.cu").read_text()
    assert src.count("__global__") == 1 and f"{chip_smoke.BIDIAG_KERNEL_NAME}(" in src
    others = {**chip_smoke.KERNEL_NAMES, **chip_smoke.GIBBS_KERNEL_NAMES, "fhn": chip_smoke.FHN_KERNEL_NAME}
    assert not any(part in chip_smoke.BIDIAG_KERNEL_NAME for part in others.values())
    assert not any(chip_smoke.BIDIAG_KERNEL_NAME in part for part in others.values())


# Bytes T1 must move (diag and off read once, ld and e written once) over 3.35 TB/s, in microseconds.
@pytest.mark.parametrize("b,t,expected_us", [(1024, 2000, 4 * 2 * 1024 * 3999 / 3.35e6), (3, 1, 24 / 3.35e6)])
def test_torch_chip_smoke_bidiag_bound_us(b, t, expected_us):
    us, bound_by = chip_smoke.bidiag_bound_us(b, t)
    assert us == pytest.approx(expected_us, rel=1e-12) and bound_by == "bytes"
