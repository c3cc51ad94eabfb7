"""Port parity: the native ESS engine binding and the figures.

``diagnostics.native`` builds the repository's ``native/fastess.cpp`` with
g++ into the git-ignored ``build/`` and binds it with ctypes; it must give
the JAX package's ``ess_geyer`` / ``ess_multichain`` in ``nfft_mode="exact"``
to rtol 1e-10, as the JAX package's own native test asks
(``tests/test_ess.py:82-99``).  Each of the four plot functions returns a
figure (``tests/test_lgc.py:155-165``).
"""

import numpy as np
import pytest

from riemannhamiltonianmontecarlo_tpu.diagnostics import ess_geyer, ess_multichain
from riemannhamiltonianmontecarlo_tpu_torch.diagnostics import native, plots
from riemannhamiltonianmontecarlo_tpu_torch.models import lgc


def ar1(rng, n: int, p: int, rho: float) -> np.ndarray:
    x = np.zeros((n, p))
    e = rng.normal(size=(n, p))
    for i in range(1, n):
        x[i] = rho * x[i - 1] + e[i]
    return x


def test_torch_native_engine_builds_outside_the_tracked_library():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.parent.name == "fastess" and "build" in path.parts
    assert path.parent.parent.parent.parent == native.SOURCE.parent.parent  # <checkout>/build/fastess/<hash>/


@pytest.mark.parametrize("rho", [0.0, 0.85])
def test_torch_native_ess_matches_jax_exact_mode(rho):
    rng = np.random.default_rng(9)
    x = ar1(rng, 2000, 5, rho)
    np.testing.assert_allclose(native.ess_geyer_native(x), ess_geyer(x, nfft_mode="exact"), rtol=1e-10)
    stacked = np.stack([x, x[::-1], ar1(rng, 2000, 5, rho)])
    np.testing.assert_allclose(native.ess_geyer_native(stacked), ess_multichain(stacked, nfft_mode="exact"), rtol=1e-10)
    np.testing.assert_allclose(native.ess_geyer_native(x, max_lag=50), ess_geyer(x, max_lag=50, nfft_mode="exact"),
                               rtol=1e-10)


def test_torch_native_ess_refuses_bad_input():
    with pytest.raises(ValueError, match="samples must be"):
        native.ess_geyer_native(np.zeros(10))
    with pytest.raises(RuntimeError, match="failed with code"):
        native.ess_geyer_native(np.zeros((1, 3)))  # one sample: the engine refuses


def test_torch_plots_return_figures(tmp_path):
    rng = np.random.default_rng(0)
    fake = rng.normal(size=(3, 80, 4))
    _, x_true = lgc.generate_data(seed=0, n=8)
    figures = (plots.trace_plot(fake, title="t"), plots.histogram_plot(fake), plots.acf_plot(fake, max_lag=40),
               plots.field_plot(x_true, x_true + rng.normal(size=x_true.shape) * 0.1))
    for i, fig in enumerate(figures):
        assert fig.axes
        fig.savefig(tmp_path / f"fig{i}.png")
        assert (tmp_path / f"fig{i}.png").stat().st_size > 0


def test_torch_ess_geyer_device_on_a_host_array_matches_jax_and_the_tensor_path():
    """A (C, N, P) host array streamed in >= 3 slabs of P (``max_bytes``) gives
    the JAX package's host-array ESS within 1e-4 rel and the port's tensor
    path within 1e-5 rel; split R-hat's host route gives its tensor path."""
    import torch

    from riemannhamiltonianmontecarlo_tpu.diagnostics import ess_geyer_device as jax_ess_geyer_device
    from riemannhamiltonianmontecarlo_tpu_torch.diagnostics import ess_geyer_device, split_rhat_device

    rng = np.random.default_rng(3)
    x = np.stack([ar1(rng, 500, 7, rho) for rho in (0.3, 0.6, 0.9, 0.95)]).astype(np.float32)  # (4, 500, 7)
    c, n, p = x.shape
    max_bytes = 8 * c * 2 * 512 * 2  # two coordinates a slab: four slabs for seven coordinates
    host = ess_geyer_device(x, max_bytes=max_bytes, device="cpu")
    assert isinstance(host, torch.Tensor) and host.shape == (p,)
    np.testing.assert_allclose(host.numpy(), np.asarray(jax_ess_geyer_device(x, max_bytes=max_bytes)), rtol=1e-4)
    np.testing.assert_allclose(host.numpy(), ess_geyer_device(torch.from_numpy(x)).numpy(), rtol=1e-5)
    rhat_host = split_rhat_device(x, device="cpu", max_bytes=c * n * 4 * 2)
    np.testing.assert_allclose(rhat_host.numpy(), split_rhat_device(torch.from_numpy(x)).numpy(), rtol=1e-6)
