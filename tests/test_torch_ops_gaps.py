"""Port parity for the pieces the other BLR samplers need, and the state converters.

* ``ops.inv_psd``, ``LogisticRegression.logp_and_grad`` and
  ``iwls_proposal`` against the JAX package at D in {7, 15, 25} (ripley's,
  australian's and german's widths): float32 both sides, rtol 1e-4 with
  atol 1e-4 * max|ref| (2e-3 for the inverses, whose condition numbers
  reach 1e3 at D = 25).
* ``ess_geyer_device`` and ``split_rhat_device`` against the JAX package's
  device versions (float32 both sides, rtol 1e-4) and the host float64
  estimators (rtol 1e-3); ``geweke_z`` (NumPy) to the bit.
* ``interop.state_from_numpy`` round trips every sampler state of the JAX
  package to the port and back unchanged, dtypes included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu as rj
import riemannhamiltonianmontecarlo_tpu_torch as rt
from riemannhamiltonianmontecarlo_tpu_torch import interop
from riemannhamiltonianmontecarlo_tpu_torch.parallel import adaptation
from riemannhamiltonianmontecarlo_tpu_torch.samplers import gibbs, hmc, iwls, mala, metropolis, mmala

torch.set_num_threads(1)


def close(port, ref, rtol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module", params=[7, 15, 25], ids=["d7", "d15", "d25"])
def pair(request):
    d = request.param
    ds = rt.models.synthetic_logreg(seed=d, n=690 if d > 7 else 250, d=d)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    w = (0.3 * np.random.default_rng(d).normal(size=(12, d))).astype(np.float32)
    return rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t)), interop.logreg_from_numpy(x, t, device="cpu"), w


def test_torch_logp_and_grad_matches_jax(pair):
    jm, tm, w = pair
    lp, g = tm.logp_and_grad(torch.from_numpy(w))
    jlp, jg = jm.logp_and_grad(jnp.asarray(w))
    close(lp, jlp)
    close(g, jg)
    assert tm.num_data == jm.num_data


def test_torch_iwls_proposal_matches_jax(pair):
    jm, tm, w = pair
    mean, cov = tm.iwls_proposal(torch.from_numpy(w))
    jmean, jcov = jm.iwls_proposal(jnp.asarray(w))
    close(mean, jmean, rtol=2e-3)
    close(cov, jcov, rtol=2e-3)


def test_torch_inv_psd_matches_jax(pair):
    jm, tm, w = pair
    g = tm.metric(torch.from_numpy(w))
    for method in (None, "unrolled", "kernel", "library"):
        close(rt.ops.inv_psd(g, method=method), rj.ops.inv_psd(jnp.asarray(g.numpy())), rtol=2e-3)


@pytest.fixture(scope="module")
def chains():
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.normal(size=(6, 301, 4)), axis=1) * 0.1 + rng.normal(size=(6, 301, 4))
    return x.astype(np.float32)


def test_torch_ess_geyer_device_matches_jax(chains):
    port = rt.diagnostics.ess_geyer_device(torch.from_numpy(chains))
    close(port, jax.jit(rj.diagnostics.ess_geyer_device)(jnp.asarray(chains)))
    close(port, rt.diagnostics.ess_multichain(chains, nfft_mode="exact"), rtol=1e-3)
    # one coordinate per chunk: the same numbers
    chunked = rt.diagnostics.ess_geyer_device(torch.from_numpy(chains), max_bytes=6 * 8 * 1024)
    torch.testing.assert_close(chunked, port, rtol=1e-6, atol=0.0)
    single = rt.diagnostics.ess_geyer_device(torch.from_numpy(chains[0]))
    close(single, jax.jit(rj.diagnostics.ess_geyer_device)(jnp.asarray(chains[0])))


def test_torch_split_rhat_device_and_geweke_match_jax(chains):
    port = rt.diagnostics.split_rhat_device(torch.from_numpy(chains))
    close(port, rj.diagnostics.split_rhat_device(jnp.asarray(chains)))
    close(port, rt.diagnostics.split_rhat(chains), rtol=1e-3)
    np.testing.assert_array_equal(rt.diagnostics.geweke_z(chains), rj.diagnostics.geweke_z(chains))
    np.testing.assert_array_equal(rt.diagnostics.geweke_z(chains[0, :, 0]), rj.diagnostics.geweke_z(chains[0, :, 0]))


def jax_states():
    """The initial state of each JAX sampler on a small BLR."""
    ds = rt.models.synthetic_logreg(seed=2, n=30, d=3)
    jm = rj.models.LogisticRegression(jnp.asarray(ds.X, jnp.float32), jnp.asarray(ds.t, jnp.float32))
    pos = jnp.asarray(np.random.default_rng(1).normal(size=(4, 3)) * 0.1, jnp.float32)
    s = rj.samplers
    kernels = {
        hmc.HMCState: s.hmc.build(jm, s.hmc.HMCConfig(num_leapfrog=3)),
        mala.MALAState: s.mala.build(jm),
        metropolis.AMHState: s.metropolis.build(jm),
        mmala.MMALAState: s.mmala.build(jm),
        iwls.IWLSState: s.iwls.build(jm),
        gibbs.GibbsState: s.gibbs.build(jm),
    }
    out = {t: k.init(pos) for t, k in kernels.items()}
    out[adaptation.AdaptiveState] = rj.parallel.adaptive(s.hmc.build, jm, s.hmc.HMCConfig(num_leapfrog=3)).init(pos)
    return out


STATE_TYPES = [hmc.HMCState, mala.MALAState, metropolis.AMHState, mmala.MMALAState, iwls.IWLSState,
               gibbs.GibbsState, adaptation.DualAveragingState, adaptation.AdaptiveState]


@pytest.fixture(scope="module")
def states():
    return jax_states()


def assert_same(port, ref):
    ref = np.asarray(ref)
    got = port.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("state_type", STATE_TYPES, ids=lambda t: t.__name__)
def test_torch_state_round_trip(states, state_type):
    if state_type is adaptation.DualAveragingState:
        jstate = states[adaptation.AdaptiveState].da
        port = interop.state_from_numpy(state_type, jstate, device="cpu")
    elif state_type is adaptation.AdaptiveState:
        jstate = states[state_type]
        port = interop.adaptive_state_from_numpy(hmc.HMCState, jstate, device="cpu")
        assert isinstance(port.inner, hmc.HMCState) and isinstance(port.da, adaptation.DualAveragingState)
        for name in hmc.HMCState._fields:
            assert_same(getattr(port.inner, name), getattr(jstate.inner, name))
        for name in adaptation.DualAveragingState._fields:
            assert_same(getattr(port.da, name), getattr(jstate.da, name))
        assert torch.equal(port.position, port.inner.position)
        return
    else:
        jstate = states[state_type]
        port = interop.state_from_numpy(state_type, {k: np.asarray(v) for k, v in jstate._asdict().items()}, device="cpu")
    assert isinstance(port, state_type) and port._fields == jstate._fields
    for name in state_type._fields:
        assert_same(getattr(port, name), getattr(jstate, name))
