"""Port parity for the slice as a whole: init, runner, diagnostics, posterior.

Whole chains never match bit for bit (JAX threefry and torch's generator
are different streams), so the sampled posterior is compared within
Monte-Carlo error: each coordinate's mean and variance differ by less than
Z = 5 standard errors computed from the Geyer ESS of both runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu as rj
import riemannhamiltonianmontecarlo_tpu_torch as rt
from riemannhamiltonianmontecarlo_tpu_torch.samplers import rmhmc

torch.set_num_threads(1)

Z = 5.0


def models(n, d, seed=0):
    ds = rt.models.synthetic_logreg(seed=seed, n=n, d=d)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    return rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t)), rt.interop.logreg_from_numpy(x, t, device="cpu")


def test_torch_map_estimate_and_init_match_jax():
    jm, tm = models(300, 7, seed=3)
    w_jax = np.asarray(rj.utils.map_estimate(jm))
    w = rt.utils.map_estimate(tm)
    # float32 Newton iterates at the same fixed point; rtol 1e-4
    np.testing.assert_allclose(w.numpy(), w_jax, rtol=1e-4, atol=1e-4 * np.abs(w_jax).max())
    gen = torch.Generator().manual_seed(0)
    init = rt.utils.default_init(tm, gen, 4096)
    assert init.shape == (4096, 7)
    # MAP + 0.1 N(0, I): the center within 5 standard errors, the spread 0.1 +- 5%
    assert np.abs(init.mean(0).numpy() - w_jax).max() < Z * 0.1 / np.sqrt(4096)
    assert np.abs(init.std(0).numpy() / 0.1 - 1.0).max() < 0.05
    center = rt.utils.jittered_init(gen, w, 3, scale=0.0)
    assert torch.equal(center, w.expand(3, 7))


@pytest.fixture(scope="module")
def small_run():
    _, tm = models(100, 5)
    kern = rmhmc.build(tm)
    init = rt.utils.default_init(tm, torch.Generator().manual_seed(1), 8)
    return kern, init


def test_torch_run_shapes_and_thinning(small_run):
    kern, init = small_run
    full = rt.parallel.run(kern, torch.Generator().manual_seed(2), init, num_samples=10, burn_in=4)
    thin = rt.parallel.run(kern, torch.Generator().manual_seed(2), init, num_samples=10, burn_in=4, thin=2)
    assert full.samples.shape == (8, 10, 5) and thin.samples.shape == (8, 5, 5)
    # same generator seed, same run: thinning keeps samples 2, 4, ... exactly
    assert torch.equal(thin.samples, full.samples[:, 1::2])
    assert torch.equal(full.samples[:, -1], full.final_state.position)
    assert full.accept_rate.shape == () and 0.0 < float(full.accept_rate) <= 1.0
    assert full.divergences.dtype == torch.int64 and full.warmup_accept_rate.shape == ()


def test_torch_run_without_collect_and_continuation(small_run):
    kern, init = small_run
    res = rt.parallel.run(kern, torch.Generator().manual_seed(3), init, num_samples=6, collect=False)
    assert res.samples is None and res.final_state.position.shape == (8, 5)
    more = rt.parallel.run(
        kern, torch.Generator().manual_seed(4), None, num_samples=3, init_state=res.final_state,
        collect_fn=lambda s: (s.position, s.logp),
    )
    pos, logp = more.samples
    assert pos.shape == (8, 3, 5) and logp.shape == (8, 3)
    assert torch.equal(logp[:, -1], more.final_state.logp)


def test_torch_diagnostics_are_exact_copies():
    """The port's host ESS and split R-hat are the JAX package's, to the bit."""
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.normal(size=(6, 301, 4)), axis=1) * 0.1 + rng.normal(size=(6, 301, 4))
    for mode in ("reference", "exact"):
        np.testing.assert_array_equal(
            rt.diagnostics.ess_multichain(x, nfft_mode=mode), rj.diagnostics.ess_multichain(x, nfft_mode=mode)
        )
        np.testing.assert_array_equal(rt.diagnostics.ess_geyer(x[0], nfft_mode=mode), rj.diagnostics.ess_geyer(x[0], nfft_mode=mode))
    np.testing.assert_array_equal(rt.diagnostics.split_rhat(x), rj.diagnostics.split_rhat(x))
    assert rt.diagnostics.nextpow2(301) == rj.diagnostics.nextpow2(301) == 512


def test_torch_posterior_matches_jax_run():
    """RMHMC at the reference constants, 64 chains, 50 burn-in + 200 samples."""
    jm, tm = models(250, 7)
    c, burn, n = 64, 50, 200
    jres = rj.parallel.run(
        rj.samplers.rmhmc.build(jm), jax.random.key(1), rj.utils.default_init(jm, jax.random.key(0), c),
        num_samples=n, burn_in=burn,
    )
    gen = torch.Generator().manual_seed(0)
    tres = rt.parallel.run(rmhmc.build(tm), gen, rt.utils.default_init(tm, gen, c), num_samples=n, burn_in=burn)
    runs = []
    for samples, acc, div in ((np.asarray(jres.samples), jres.accept_rate, jres.divergences),
                              (tres.samples.numpy(), tres.accept_rate, tres.divergences)):
        flat = samples.reshape(-1, samples.shape[-1])
        ess = rt.diagnostics.ess_multichain(samples, nfft_mode="exact")
        runs.append((flat.mean(0), flat.var(0), ess, float(acc), int(div)))
        assert rt.diagnostics.split_rhat(samples).max() < 1.1
    (mj, vj, ej, aj, dj), (mt, vt, et, at, dt) = runs
    z_mean = np.abs(mt - mj) / np.sqrt(vj / ej + vt / et)
    assert z_mean.max() < Z
    # Var of a sample variance ~ 2 var^2 / ESS for a near-Gaussian posterior
    z_var = np.abs(vt - vj) / np.sqrt(2 * vj**2 / ej + 2 * vt**2 / et)
    assert z_var.max() < Z
    # acceptance: per-step means over 64 chains, Monte-Carlo error ~ 0.005
    assert abs(at - aj) < 0.03 and 0.8 < at < 0.99
    # divergences: rare in both (a handful of 12,800 transitions at most)
    assert dj <= 0.005 * c * n and dt <= 0.005 * c * n
