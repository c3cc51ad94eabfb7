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
