"""Port parity: one transition of each BLR sampler against the JAX package's step.

Each JAX step draws its noise from key splits; the test replays those draws,
hands them to the port's pure ``transition`` and compares the results.
Accept decisions can flip only where ``ratio`` sits on ``log u``: chains
with |log a - log u| <= 1e-2 (a the JAX accept probability; for the
coordinate sweep, any coordinate's margin from a float64 replay) are left
out of the decision and state checks.  Tolerances: positions and means
atol 1e-3, logp atol 1e-2 (|logp| ~ 1e2), accept probability atol 1e-3,
matrices rtol 1e-3 -- float32 on both sides, sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu as rj
from riemannhamiltonianmontecarlo_tpu_torch import interop
from riemannhamiltonianmontecarlo_tpu_torch.models import synthetic_logreg
from riemannhamiltonianmontecarlo_tpu_torch.samplers import hmc, iwls, mala, metropolis, mmala

torch.set_num_threads(1)

N, D, C = 100, 7, 32
MARGIN = 1e-2
ATOL = {"position": 1e-3, "mean": 1e-3, "grad": 1e-2, "logp": 1e-2, "accept_prob": 1e-3}


@pytest.fixture(scope="module")
def target():
    ds = synthetic_logreg(seed=5, n=N, d=D)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    jm = rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t))
    tm = interop.logreg_from_numpy(x, t, device="cpu")
    center = np.asarray(rj.utils.map_estimate(jm))
    pos = (center + 0.1 * np.random.default_rng(0).normal(size=(C, D))).astype(np.float32)
    return jm, tm, pos


def tensors(**draws):
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def replay_normal_accept(key):
    """(normal (C, D), u_acc (C,)): MALA's, mMALA's and IWLS's two draws."""
    k_prop, k_acc = jax.random.split(key)
    return tensors(eps=jax.random.normal(k_prop, (C, D), jnp.float32), u_acc=jax.random.uniform(k_acc, (C,)))


def replay_hmc(key):
    k_mom, k_len, k_acc = jax.random.split(key, 3)
    return hmc.HMCNoise(**tensors(
        p0=jax.random.normal(k_mom, (C, D), jnp.float32),
        u_len=jax.random.uniform(k_len, (C,)),
        u_acc=jax.random.uniform(k_acc, (C,)),
    ))


def compare(jstate, jinfo, tstate, tinfo, u_acc, matrices=()):
    ap = np.asarray(jinfo.accept_prob)
    with np.errstate(divide="ignore"):
        away = np.abs(np.log(ap) - np.log(u_acc.numpy())) > MARGIN
    assert away.sum() >= 0.75 * C
    np.testing.assert_allclose(tinfo.accept_prob.numpy(), ap, atol=ATOL["accept_prob"])
    np.testing.assert_array_equal(tinfo.accepted.numpy()[away], np.asarray(jinfo.accepted)[away])
    np.testing.assert_array_equal(tinfo.divergent.numpy(), np.asarray(jinfo.divergent))
    for name in tstate._fields:
        port, ref = getattr(tstate, name).numpy()[away], np.asarray(getattr(jstate, name))[away]
        if name in matrices:
            np.testing.assert_allclose(port, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max(), err_msg=name)
        else:
            np.testing.assert_allclose(port, ref, atol=ATOL[name], err_msg=name)
    assert tinfo.accepted.any() and not tinfo.accepted.all()  # both branches compared


@pytest.mark.parametrize("randomize_length", [True, False], ids=["random-length", "fixed-length"])
def test_torch_hmc_transition_matches_jax_step(target, randomize_length):
    jm, tm, pos = target
    cfg = dict(step_size=0.15, num_leapfrog=20, randomize_length=randomize_length)
    jk = rj.samplers.hmc.build(jm, rj.samplers.hmc.HMCConfig(**cfg))
    tk = hmc.build(tm, hmc.HMCConfig(**cfg))
    key = jax.random.key(21)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(pos)))
    noise = replay_hmc(key)
    ts, ti = tk.transition(tk.init(torch.from_numpy(pos)), noise)
    compare(js, ji, ts, ti, noise.u_acc)


@pytest.mark.parametrize("transient", [False, True], ids=["stationary", "transient"])
def test_torch_mala_transition_matches_jax_step(target, transient):
    jm, tm, pos = target
    cfg = dict(step_size=0.3, transient=transient, transient_factor=2.0)
    jk = rj.samplers.mala.build(jm, rj.samplers.mala.MALAConfig(**cfg))
    tk = mala.build(tm, mala.MALAConfig(**cfg))
    assert mala.MALAConfig(**cfg).scaling(D) == rj.samplers.mala.MALAConfig(**cfg).scaling(D)
    key = jax.random.key(22)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(pos)))
    noise = mala.MALANoise(**replay_normal_accept(key))
    ts, ti = tk.transition(tk.init(torch.from_numpy(pos)), noise)
    compare(js, ji, ts, ti, noise.u_acc)


@pytest.mark.parametrize("simplified", [False, True], ids=["mmala", "mmala_simplified"])
def test_torch_mmala_transition_matches_jax_step(target, simplified):
    jm, tm, pos = target
    cfg = dict(step_size=0.8, simplified=simplified)
    jk = rj.samplers.mmala.build(jm, rj.samplers.mmala.MMALAConfig(**cfg))
    tk = mmala.build(tm, mmala.MMALAConfig(**cfg))
    key = jax.random.key(23)
    jstate = jk.init(jnp.asarray(pos))
    js, ji = jax.jit(jk.step)(key, jstate)
    noise = mmala.MMALANoise(**replay_normal_accept(key))
    tstate = tk.init(torch.from_numpy(pos))
    for name in ("mean", "metric", "cov_factor"):  # the geometry of init
        ref = np.asarray(getattr(jstate, name))
        np.testing.assert_allclose(getattr(tstate, name).numpy(), ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max())
    ts, ti = tk.transition(tstate, noise)
    compare(js, ji, ts, ti, noise.u_acc, matrices=("metric", "cov_factor"))


def test_torch_iwls_transition_matches_jax_step(target):
    jm, tm, pos = target
    jk, tk = rj.samplers.iwls.build(jm), iwls.build(tm)
    key = jax.random.key(24)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(pos)))
    noise = iwls.IWLSNoise(**replay_normal_accept(key))
    ts, ti = tk.transition(tk.init(torch.from_numpy(pos)), noise)
    compare(js, ji, ts, ti, noise.u_acc, matrices=("chol_cov",))


def logp64(x, t, w, alpha=100.0):
    f = w @ x.T
    return f @ t - np.logaddexp(0.0, f).sum(-1) - 0.5 * (w * w).sum(-1) / alpha


def test_torch_metropolis_sweep_matches_jax_step(target):
    """One AMH sweep at iteration 99, so the adaptation pulse at 100 fires."""
    jm, tm, pos = target
    jk, tk = rj.samplers.metropolis.build(jm), metropolis.build(tm)
    rng = np.random.default_rng(7)
    jstate = jk.init(jnp.asarray(pos))._replace(
        proposal_sd=jnp.asarray(rng.uniform(0.05, 0.6, size=(C, D)), jnp.float32),
        window_accepts=jnp.asarray(rng.integers(0, 99, size=(C, D)), jnp.float32),
        window_sweeps=jnp.asarray(99, jnp.int32),
        iteration=jnp.asarray(99, jnp.int32),
    )
    key = jax.random.key(25)
    js, ji = jax.jit(jk.step)(key, jstate)

    # the sweep's per-coordinate draws: split(key, D), then (normal, uniform) each
    keys = jax.random.split(key, D)
    normal, u_acc = [], []
    for k in keys:
        k_prop, k_acc = jax.random.split(k)
        normal.append(jax.random.normal(k_prop, (C,), jnp.float32))
        u_acc.append(jax.random.uniform(k_acc, (C,), jnp.float32))
    noise = metropolis.AMHNoise(**tensors(normal=jnp.stack(normal), u_acc=jnp.stack(u_acc)))

    # float64 replay of the sweep: each coordinate's accept margin
    x, t = tm.X.double().numpy(), tm.t.double().numpy()
    w = pos.astype(np.float64)
    lp = logp64(x, t, w)
    margin = np.full(C, np.inf)
    for k in range(D):
        w_new = w.copy()
        w_new[:, k] += noise.normal[k].double().numpy() * np.asarray(jstate.proposal_sd, np.float64)[:, k]
        lp_new = logp64(x, t, w_new)
        with np.errstate(divide="ignore"):
            ratio_gap = (lp_new - lp) - np.log(noise.u_acc[k].double().numpy())
        margin = np.minimum(margin, np.abs(ratio_gap))
        acc = ratio_gap > 0
        w, lp = np.where(acc[:, None], w_new, w), np.where(acc, lp_new, lp)
    away = margin > MARGIN
    assert away.sum() >= 0.75 * C

    ts, ti = tk.transition(interop.state_from_numpy(metropolis.AMHState, jstate, device="cpu"), noise)
    np.testing.assert_allclose(ts.position.numpy()[away], np.asarray(js.position)[away], atol=1e-6)
    np.testing.assert_allclose(ts.logp.numpy()[away], np.asarray(js.logp)[away], atol=1e-2)
    np.testing.assert_allclose(ti.accept_prob.numpy(), np.asarray(ji.accept_prob), atol=1e-3)
    # XLA divides by D as a multiply by 1/D: the fractions agree to one ulp
    np.testing.assert_allclose(ti.accepted.numpy()[away], np.asarray(ji.accepted)[away], atol=1e-6)
    assert ti.accepted.dtype == torch.float32  # the sweep's fraction of moves taken
    # the pulse: SDs grown / shrunk per the window rate, counters reset
    np.testing.assert_allclose(ts.proposal_sd.numpy()[away], np.asarray(js.proposal_sd)[away], rtol=1e-6)
    assert not np.allclose(np.asarray(js.proposal_sd), np.asarray(jstate.proposal_sd))
    assert (ts.window_accepts == 0).all() and int(ts.window_sweeps) == int(js.window_sweeps) == 0
    assert int(ts.iteration) == int(js.iteration) == 100
    assert ts.iteration.dtype == torch.int32
