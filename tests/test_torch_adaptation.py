"""Port parity: dual-averaging step-size adaptation.

* ``da_update`` on the same acceptance sequence gives the JAX package's
  trajectory (float32 both sides; rtol 1e-5).
* Adaptive HMC on a small BLR lands within the JAX test's tolerance of its
  target (``tests/test_adaptation.py:19-36``: |accept - 0.8| < 0.12, the
  step shrunk from an absurd 5.0), and its posterior mean within 0.25 of
  the JAX package's adaptive run.
* Every adaptable sampler steps with a 0-dim tensor step size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu as rj
import riemannhamiltonianmontecarlo_tpu_torch as rt
from riemannhamiltonianmontecarlo_tpu.parallel import adaptation as jad
from riemannhamiltonianmontecarlo_tpu_torch import interop
from riemannhamiltonianmontecarlo_tpu_torch.parallel import adaptation
from riemannhamiltonianmontecarlo_tpu_torch.samplers import hmc, mala, mmala, rmhmc

torch.set_num_threads(1)


def test_torch_da_update_trajectory_matches_jax():
    accepts = np.random.default_rng(0).uniform(0.2, 1.0, size=60).astype(np.float32)
    js, ts = jad.da_init(0.3), adaptation.da_init(0.3, device="cpu")
    for a in accepts:
        js = jad.da_update(js, jnp.asarray(a), 0.651, gamma=0.05, t0=10.0, kappa=0.75)
        ts = adaptation.da_update(ts, torch.tensor(a), 0.651, gamma=0.05, t0=10.0, kappa=0.75)
        for name in ("log_eps", "log_eps_avg", "h_bar", "mu"):
            np.testing.assert_allclose(float(getattr(ts, name)), float(getattr(js, name)), rtol=1e-5, atol=1e-6)
        assert int(ts.t) == int(js.t)
    assert ts.t.dtype == torch.int32 and ts.log_eps.dtype == torch.float32
    carried = interop.state_from_numpy(adaptation.DualAveragingState, js, device="cpu")
    assert adaptation.frozen_step_size(adaptation.AdaptiveState(None, carried)) == pytest.approx(
        jad.frozen_step_size(jad.AdaptiveState(None, js)), rel=1e-6)


def blr(n=120, d=4):
    ds = rt.models.synthetic_logreg(seed=3, n=n, d=d, w_scale=1.0)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    return rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t)), interop.logreg_from_numpy(x, t, device="cpu")


def test_torch_adaptive_hmc_hits_target_on_blr():
    jm, tm = blr()
    gen = torch.Generator().manual_seed(0)
    res, eps = adaptation.run_adaptive(
        hmc.build, tm, hmc.HMCConfig(step_size=5.0, num_leapfrog=8), gen, rt.utils.default_init(tm, gen, 128),
        num_samples=300, warmup=200, adapt=adaptation.AdaptationConfig(target_accept=0.8),
    )
    assert eps < 5.0
    assert abs(float(res.accept_rate) - 0.8) < 0.12, (eps, float(res.accept_rate))
    jres, jeps = rj.parallel.run_adaptive(
        rj.samplers.hmc.build, jm, rj.samplers.hmc.HMCConfig(step_size=5.0, num_leapfrog=8), jax.random.key(0),
        rj.utils.default_init(jm, jax.random.key(1), 128), num_samples=300, warmup=200,
        adapt=jad.AdaptationConfig(target_accept=0.8),
    )
    np.testing.assert_allclose(res.samples.reshape(-1, tm.dim).mean(0).numpy(),
                               np.asarray(jres.samples).reshape(-1, tm.dim).mean(0), atol=0.25)
    assert abs(eps - jeps) < 0.5 * jeps  # both settle on a step of the same size


@pytest.mark.parametrize("build,config", [
    (hmc.build, hmc.HMCConfig(step_size=0.1, num_leapfrog=5)),
    (mala.build, mala.MALAConfig(step_size=0.1)),
    (mmala.build, mmala.MMALAConfig(step_size=0.5)),
    (mmala.build, mmala.MMALAConfig(step_size=0.5, simplified=True)),
    (rmhmc.build, rmhmc.RMHMCConfig(step_size=0.1, num_leapfrog=3, num_fixed_point=2)),
], ids=["hmc", "mala", "mmala", "mmala_simplified", "rmhmc"])
def test_torch_adaptive_kernels_step_with_a_tensor_step_size(build, config):
    _, tm = blr()
    kernel = adaptation.adaptive(build, tm, config)
    gen = torch.Generator().manual_seed(1)
    state = kernel.init(rt.utils.default_init(tm, gen, 16))
    for _ in range(3):
        state, info = kernel.step(gen, state)
    assert isinstance(state.da.log_eps, torch.Tensor) and state.da.log_eps.shape == ()
    assert int(state.da.t) == 3 and torch.isfinite(state.position).all()
    assert info.accept_prob.shape == (16,)
    # the same transition at a float step and at the equal 0-dim tensor step
    eps = float(torch.exp(state.da.log_eps))
    noise_gen = torch.Generator().manual_seed(2)
    a = build(tm, dataclasses.replace(config, step_size=eps)).step(noise_gen, state.inner)
    noise_gen.manual_seed(2)
    b = build(tm, dataclasses.replace(config, step_size=torch.tensor(eps))).step(noise_gen, state.inner)
    torch.testing.assert_close(a[0].position, b[0].position, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a[1].accept_prob, b[1].accept_prob, rtol=1e-4, atol=1e-5)
