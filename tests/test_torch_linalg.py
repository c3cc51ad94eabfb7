"""Port parity: the Hopper kernels' plain twins and the ops.linalg dispatch.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them against
these twins there).  Here the twins are held against the Pallas kernels in
interpret mode and against float64 numpy, and the CPU side of the
dispatch is checked: a CPU tensor takes the twin, never the kernel, and the
kernels' own wrappers refuse it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riemannhamiltonianmontecarlo_tpu import ops as jops
from riemannhamiltonianmontecarlo_tpu.ops import pallas_linalg as plin
from riemannhamiltonianmontecarlo_tpu_torch import ops
from riemannhamiltonianmontecarlo_tpu_torch.ops import _build
from riemannhamiltonianmontecarlo_tpu_torch.ops import hopper_linalg as hl

torch.set_num_threads(1)


def spd(c, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c, d, d))
    g = (a @ np.swapaxes(a, -1, -2) + d * np.eye(d)).astype(np.float32)
    b = rng.normal(size=(c, d)).astype(np.float32)
    return g, b


# Against the Pallas kernels in interpret mode: the same unrolled algorithm,
# float32 on both sides; tolerance 1e-5 relative (only rounding order differs).
@pytest.mark.parametrize("c,d", [(5, 7), (40, 6)])
def test_torch_twins_match_pallas_interpret(c, d):
    g, b = spd(c, d, seed=c + d)
    l_ref = np.asarray(plin.cholesky(jnp.asarray(g), interpret=True))
    np.testing.assert_allclose(hl.cholesky_plain(torch.from_numpy(g)).numpy(), l_ref, rtol=1e-5, atol=1e-5)
    x_ref, ld_ref = plin.chol_solve_logdet(jnp.asarray(g), jnp.asarray(b), interpret=True)
    x, ld = hl.chol_solve_logdet_plain(torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), rtol=1e-5, atol=1e-5)


# Against float64 numpy, with the tolerances of tests/test_pallas_linalg.py.
@pytest.mark.parametrize("c,d", [(5, 7), (200, 15), (130, 25)])
def test_torch_twins_match_numpy(c, d):
    g, b = spd(c, d, seed=c + d)
    g64 = g.astype(np.float64)
    l = hl.cholesky(torch.from_numpy(g)).numpy()  # CPU tensor: the wrapper takes the twin
    np.testing.assert_allclose(l, np.linalg.cholesky(g64), rtol=2e-4, atol=2e-4)
    assert (np.triu(l, 1) == 0.0).all()  # exact zeros, not merely small
    x, ld = hl.chol_solve_logdet(torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(g64, b[..., None])[..., 0], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ld.numpy(), np.linalg.slogdet(g64)[1], rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("method", ["kernel", "unrolled", "library"])
def test_torch_non_pd_chain_is_nan_alone(method):
    g, b = spd(12, 7, seed=4)
    g[5] = -np.eye(7, dtype=np.float32)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    ok = np.arange(12) != 5
    l = ops.cholesky(gt, method=method).numpy()
    assert np.isfinite(l[ok]).all() and not np.isfinite(l[5]).all()
    assert (np.triu(l, 1) == 0.0).all()
    x = ops.solve_psd(gt, bt, method=method).numpy()
    assert np.isfinite(x[ok]).all() and not np.isfinite(x[5]).all()
    if method == "kernel":
        x, ld = hl.chol_solve_logdet(gt, bt)
        assert np.isfinite(ld.numpy()[ok]).all() and not np.isfinite(ld.numpy()[5])


# The dispatch against the JAX package's unrolled ops: float32 both sides,
# rtol 2e-4 / atol 2e-4 (test_pallas_linalg's cholesky tolerance).
@pytest.mark.parametrize("method", [None, "unrolled", "kernel", "library"])
def test_torch_linalg_ops_match_jax(method):
    g, b = spd(40, 6, seed=3)
    gj, bj, gt, bt = jnp.asarray(g), jnp.asarray(b), torch.from_numpy(g), torch.from_numpy(b)

    def close(port, ref):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)

    lj = jops.cholesky(gj, method="unrolled")
    lt = ops.cholesky(gt, method=method)
    close(lt, lj)
    close(ops.solve_lower_triangular(lt, bt, method=method), jops.solve_lower_triangular(lj, bj))
    close(ops.solve_upper_from_lower(lt, bt, method=method), jops.solve_upper_from_lower(lj, bj))
    close(ops.cho_solve(lt, bt, method=method), jops.cho_solve(lj, bj))
    close(ops.solve_psd(gt, bt, method=method), jops.solve_psd(gj, bj, method="unrolled"))
    close(ops.inv_psd_from_chol(lt, method=method), jops.inv_psd_from_chol(lj))
    close(ops.logdet_from_chol(lt), jops.logdet_from_chol(lj))
    # matrix right-hand side of the triangular solves, (C, D, K)
    bm = np.random.default_rng(5).normal(size=(40, 6, 3)).astype(np.float32)
    close(ops.solve_lower_triangular(lt, torch.from_numpy(bm), method=method),
          jops.solve_lower_triangular(lj, jnp.asarray(bm)))


def test_torch_mvn_sample_takes_callers_eps():
    """mvn_sample(L, eps) = L @ eps: the JAX draw replayed through the port."""
    g, _ = spd(30, 7, seed=6)
    key = jax.random.key(0)
    lj = jops.cholesky(jnp.asarray(g), method="unrolled")
    eps = np.asarray(jax.random.normal(key, (30, 7), jnp.float32))
    ref = np.asarray(jops.mvn_sample(key, lj))
    port = ops.mvn_sample(ops.cholesky(torch.from_numpy(g)), torch.tensor(eps))
    np.testing.assert_allclose(port.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_torch_cpu_tensors_never_launch():
    g, b = spd(16, 7, seed=7)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    hl.reset_launch_counts()
    ops.cholesky(gt)
    ops.cholesky(gt, method="kernel")
    ops.solve_psd(gt, bt, method="kernel")
    hl.cholesky(gt)
    hl.chol_solve_logdet(gt, bt)
    assert hl.launch_counts() == {"cholesky": 0, "chol_solve_logdet": 0}


def test_torch_cuda_wrappers_refuse_cpu_tensors():
    g, b = spd(4, 5, seed=8)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hl.cholesky_cuda(gt)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hl.chol_solve_logdet_cuda(gt, bt)
    with pytest.raises(ValueError, match="method"):
        ops.cholesky(gt, method="pallas")
    assert hl.launch_counts() == {"cholesky": 0, "chol_solve_logdet": 0}


def test_torch_build_without_nvcc_raises(monkeypatch):
    """No toolkit means an error, never a silent fallback to the twins."""
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert _build.library_dir().parent == _build.BUILD_ROOT
    assert _build.library_dir() == _build.library_dir()  # keyed by content, stable
