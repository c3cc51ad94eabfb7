"""Port parity: the FitzHugh-Nagumo model and its samplers against the JAX package.

Small settings, as ``tests/test_fhn.py``: 50 observations, 3 RK4 substeps.
Both models come from the same numpy data (the port's through
``interop.fhn_from_numpy``).  The port's quantities come from the plain twin
of the sensitivity kernel (``ops.fhn_sens.fhn_sensitivities_plain``: the
augmented RK4 system), the JAX package's from ``jax.grad`` / ``jacfwd``
through its ``lax.scan`` integrator.  Tolerance: 1e-4 of each output's
largest finite |entry| -- float32 on both sides, the derivatives taken by
another route; the JAX model's own float32 / float64 spread is <= 1.9e-5 of
that scale.  The transitions replay the JAX step's draws and follow
``tests/test_torch_samplers_blr.py``'s ``compare``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu as rj
from riemannhamiltonianmontecarlo_tpu.models import fhn as jfhn
from riemannhamiltonianmontecarlo_tpu_torch import experiments, interop
from riemannhamiltonianmontecarlo_tpu_torch.models import fhn
from riemannhamiltonianmontecarlo_tpu_torch.ops import fhn_sens
from riemannhamiltonianmontecarlo_tpu_torch.samplers import hmc, mala, metropolis, mmala, rmhmc

torch.set_num_threads(1)

NUM_OBS, SUBSTEPS, C = 50, 3, 16
TOL = 1e-4  # of each output's largest finite |entry|
MARGIN = 1e-2
THETA_TRUE = np.array([0.2, 0.2, 3.0], np.float32)
# the truth, a point off it, one outside the support, one whose trajectory overflows
THETAS = np.array([[0.2, 0.2, 3.0], [0.3, 0.25, 2.5], [-0.1, 0.2, 3.0], [0.2, 0.2, 100.0]], np.float32)
THETA_IDS = ["truth", "off-truth", "negative-a", "overflow"]


@pytest.fixture(scope="module")
def models():
    data, _ = jfhn.generate_data(seed=2, num_obs=NUM_OBS)
    jm = jfhn.FHNModel(jnp.asarray(data, jnp.float32), substeps=SUBSTEPS)
    tm = interop.fhn_from_numpy(data, device="cpu", substeps=SUBSTEPS)
    return jm, tm


def assert_close_to_scale(port, ref, name):
    port, ref = np.asarray(port), np.asarray(ref)
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port), finite, err_msg=f"{name}: non-finite entries")
    if finite.any():
        scale = np.abs(ref[finite]).max()
        np.testing.assert_allclose(port[finite], ref[finite], rtol=0, atol=TOL * max(scale, 1e-30), err_msg=name)


# (theta row, num_obs, substeps): every theta at the small setting, and the truth on a grid of 6,145
# observations and one substep, past the 6,144 that the first form of the kernel staged.
INTEGRATOR_CASES = [pytest.param(k, NUM_OBS, SUBSTEPS, id=name) for k, name in enumerate(THETA_IDS)] + [
    pytest.param(0, 6145, 1, id="truth-6145x1")]


@pytest.mark.parametrize("k, num_obs, substeps", INTEGRATOR_CASES)
def test_torch_fhn_integrator_matches_jax(k, num_obs, substeps):
    theta = THETAS[k]
    ref = np.asarray(jfhn.integrate_rk4(jnp.asarray(theta), num_obs=num_obs, substeps=substeps))
    port = fhn.integrate_rk4(torch.from_numpy(theta), num_obs=num_obs, substeps=substeps).numpy()
    assert port.shape == ref.shape == (num_obs, 2)
    assert_close_to_scale(port, ref, "trajectory")
    # batched over leading axes: each row as alone
    batch = fhn.integrate_rk4(torch.from_numpy(THETAS).reshape(2, 2, 3), num_obs=num_obs, substeps=substeps)
    np.testing.assert_array_equal(batch.reshape(4, num_obs, 2)[k].numpy(), port)


def test_torch_fhn_generate_data_matches_jax():
    for seed, kw in ((1, {}), (2, {"num_obs": NUM_OBS})):
        (dj, cj), (dt, ct) = jfhn.generate_data(seed=seed, **kw), fhn.generate_data(seed=seed, **kw)
        assert dt.shape == dj.shape and dt.dtype == dj.dtype and ct.dtype == cj.dtype == np.float32
        np.testing.assert_allclose(ct, cj, atol=1e-5)
        np.testing.assert_allclose(dt, dj, atol=1e-5)


@pytest.fixture(scope="module")
def outputs(models):
    """Every model output at all of THETAS in one batched call per package,
    with the contractions on seeded vectors and a symmetric matrix."""
    jm, tm = models
    rng = np.random.default_rng(3)
    u, v = rng.normal(size=(2, len(THETAS), 3)).astype(np.float32)
    a = rng.normal(size=(len(THETAS), 3, 3)).astype(np.float32)
    m = a + np.swapaxes(a, -1, -2)
    jth = jnp.asarray(THETAS)
    jcache = jm.dg_cache(jth)
    ref = {"logp": jm.logp(jth), "grad": jm.grad(jth), "metric": jm.metric(jth), "dg_cache": jcache,
           "dg_bilinear": jm.dg_bilinear(jth, jnp.asarray(u), jnp.asarray(v), cache=jcache),
           "dg_trace": jm.dg_trace(jth, jnp.asarray(m), cache=jcache),
           "dg_dotted": jm.dg_dotted(jth, jnp.asarray(m), cache=jcache)}
    tth = torch.from_numpy(THETAS)
    tu, tv, tmat = map(torch.from_numpy, (u, v, m))
    port = {"logp": tm.logp(tth), "grad": tm.grad(tth), "metric": tm.metric(tth), "dg_cache": tm.dg_cache(tth),
            "dg_bilinear": tm.dg_bilinear(tth, tu, tv), "dg_trace": tm.dg_trace(tth, tmat),
            "dg_dotted": tm.dg_dotted(tth, tmat)}
    return {name: np.asarray(x) for name, x in ref.items()}, {name: x.numpy() for name, x in port.items()}


@pytest.mark.parametrize("k", range(len(THETAS)), ids=THETA_IDS)
def test_torch_fhn_model_matches_jax(outputs, k):
    ref, port = outputs
    for name in ref:
        assert port[name][k].shape == ref[name][k].shape, name
        assert_close_to_scale(port[name][k], ref[name][k], name)
    if THETAS[k][0] < 0 or THETAS[k][2] > 10:  # logp -inf and the whole gradient exactly 0, as JAX
        assert ref["logp"][k] == port["logp"][k] == -np.inf
        assert (ref["grad"][k] == 0).all() and (port["grad"][k] == 0).all()
    if THETAS[k][0] < 0:  # outside the support the geometry is still finite
        assert np.isfinite(port["metric"][k]).all() and np.isfinite(port["dg_cache"][k]).all()


def test_torch_fhn_manifold_state_is_the_four_calls(models):
    _, tm = models
    theta = torch.from_numpy(THETAS[:2]).reshape(2, 1, 3)  # leading axes kept
    ms = tm.manifold_state(theta)
    assert ms.logp.shape == (2, 1) and ms.cache.shape == (2, 1, 3, 3, 3)
    for got, want in zip(ms, (tm.logp(theta), tm.grad(theta), tm.metric(theta), tm.dg_cache(theta))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    lp, g = tm.logp_and_grad(theta)
    torch.testing.assert_close(lp, ms.logp, rtol=0, atol=0)
    torch.testing.assert_close(g, ms.grad, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="logistic-regression"):
        tm.iwls_proposal(theta)


def test_torch_fhn_wrapper_dispatch_and_checks(models):
    """A CPU tensor runs the twin and counts nothing; the kernel's wrapper
    refuses a CPU tensor, and every entry an unknown order."""
    _, tm = models
    fhn_sens.reset_launch_counts()
    theta = torch.from_numpy(THETAS[:2])
    consts = dict(substeps=SUBSTEPS, noise_sd=0.5, gamma_scale=3.0)
    out = fhn_sens.fhn_sensitivities(theta, tm.data, 1, **consts)
    assert out.dmetric is None and out.grad.shape == (2, 3) and out.metric.shape == (2, 3, 3)
    assert fhn_sens.launch_counts() == {0: 0, 1: 0, 2: 0}
    with pytest.raises(ValueError, match="CUDA"):
        fhn_sens.fhn_sensitivities_cuda(theta, tm.data, 1, **consts)
    with pytest.raises(ValueError, match="order"):
        fhn_sens.fhn_sensitivities(theta, tm.data, 3, **consts)
    # the operation count behind the kernel's bound, per chain: steps x per step + times x per time
    assert fhn_sens.operations(2, 1, 200, 5) == 995 * 860 + 200 * 186


# -- one transition of each sampler on replayed JAX draws ---------------------------


@pytest.fixture(scope="module")
def start():
    rng = np.random.default_rng(0)
    return (THETA_TRUE * (1.0 + 0.05 * rng.normal(size=(C, 3)))).astype(np.float32)


def tensors(**draws):
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def compare(jstate, jinfo, tstate, tinfo, u_acc):
    ap = np.asarray(jinfo.accept_prob)
    with np.errstate(divide="ignore"):
        away = np.abs(np.log(ap) - np.log(u_acc.numpy())) > MARGIN
    assert away.sum() >= 0.75 * C
    np.testing.assert_allclose(tinfo.accept_prob.numpy(), ap, atol=1e-3)
    np.testing.assert_array_equal(tinfo.accepted.numpy()[away], np.asarray(jinfo.accepted)[away])
    np.testing.assert_array_equal(tinfo.divergent.numpy()[away], np.asarray(jinfo.divergent)[away])
    np.testing.assert_allclose(tstate.position.numpy()[away], np.asarray(jstate.position)[away], atol=1e-3)
    np.testing.assert_allclose(tstate.logp.numpy()[away], np.asarray(jstate.logp)[away], rtol=1e-4, atol=1e-2)
    for name in set(tstate._fields) - {"position", "logp", "geo"}:
        port, ref = getattr(tstate, name).numpy()[away], np.asarray(getattr(jstate, name))[away]
        np.testing.assert_allclose(port, ref, rtol=1e-3, atol=1e-3 * np.abs(ref).max(), err_msg=name)
    assert tinfo.accepted.any()


def test_torch_fhn_rmhmc_transition_matches_jax_step(models, start):
    jm, tm = models
    cfg = dict(step_size=0.5, num_leapfrog=6, num_fixed_point=5, jitter=1e-6)  # the fhn preset
    jk = rj.samplers.rmhmc.build(jm, rj.samplers.rmhmc.RMHMCConfig(**cfg))
    tk = rmhmc.build(tm, rmhmc.RMHMCConfig(**cfg))
    key = jax.random.key(31)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(start)))
    k_mom, k_chi, k_len, k_dir, k_acc = jax.random.split(key, 5)
    noise = rmhmc.RMHMCNoise(**tensors(
        eps=jax.random.normal(k_mom, (C, 3), jnp.float32), chi_normal=jax.random.normal(k_chi, (C,), jnp.float32),
        u_len=jax.random.uniform(k_len, (C,)), u_dir=jax.random.uniform(k_dir, (C,)),
        u_acc=jax.random.uniform(k_acc, (C,), jnp.float32)))
    ts, ti = tk.transition(tk.init(torch.from_numpy(start)), noise)
    compare(js, ji, ts, ti, noise.u_acc)


@pytest.mark.parametrize("simplified", [False, True], ids=["mmala", "mmala_simplified"])
def test_torch_fhn_mmala_transition_matches_jax_step(models, start, simplified):
    jm, tm = models
    cfg = dict(step_size=1.0, simplified=simplified, jitter=1e-6)
    jk = rj.samplers.mmala.build(jm, rj.samplers.mmala.MMALAConfig(**cfg))
    tk = mmala.build(tm, mmala.MMALAConfig(**cfg))
    key = jax.random.key(32)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(start)))
    k_prop, k_acc = jax.random.split(key)
    noise = mmala.MMALANoise(**tensors(eps=jax.random.normal(k_prop, (C, 3), jnp.float32),
                                       u_acc=jax.random.uniform(k_acc, (C,))))
    ts, ti = tk.transition(tk.init(torch.from_numpy(start)), noise)
    compare(js, ji, ts, ti, noise.u_acc)


def test_torch_fhn_hmc_transition_matches_jax_step(models, start):
    jm, tm = models
    cfg = dict(step_size=1.0 / 150.0, num_leapfrog=10)  # the preset's step, a shortened L
    jk = rj.samplers.hmc.build(jm, rj.samplers.hmc.HMCConfig(**cfg))
    tk = hmc.build(tm, hmc.HMCConfig(**cfg))
    key = jax.random.key(33)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(start)))
    k_mom, k_len, k_acc = jax.random.split(key, 3)
    noise = hmc.HMCNoise(**tensors(p0=jax.random.normal(k_mom, (C, 3), jnp.float32),
                                   u_len=jax.random.uniform(k_len, (C,)), u_acc=jax.random.uniform(k_acc, (C,))))
    ts, ti = tk.transition(tk.init(torch.from_numpy(start)), noise)
    compare(js, ji, ts, ti, noise.u_acc)


def test_torch_fhn_mala_transition_matches_jax_step(models, start):
    jm, tm = models
    jk = rj.samplers.mala.build(jm, rj.samplers.mala.MALAConfig(step_size=2e-4))
    tk = mala.build(tm, mala.MALAConfig(step_size=2e-4))
    key = jax.random.key(34)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(start)))
    k_prop, k_acc = jax.random.split(key)
    noise = mala.MALANoise(**tensors(eps=jax.random.normal(k_prop, (C, 3), jnp.float32),
                                     u_acc=jax.random.uniform(k_acc, (C,))))
    ts, ti = tk.transition(tk.init(torch.from_numpy(start)), noise)
    compare(js, ji, ts, ti, noise.u_acc)


def test_torch_fhn_metropolis_sweep_matches_jax_step(models, start):
    jm, tm = models
    jk = rj.samplers.metropolis.build(jm, rj.samplers.metropolis.AMHConfig(init_proposal_sd=0.05))
    tk = metropolis.build(tm, metropolis.AMHConfig(init_proposal_sd=0.05))
    key = jax.random.key(35)
    jstate = jk.init(jnp.asarray(start))
    js, ji = jax.jit(jk.step)(key, jstate)
    normal, u_acc = [], []
    for k in jax.random.split(key, 3):  # the sweep's per-coordinate draws
        k_prop, k_acc = jax.random.split(k)
        normal.append(jax.random.normal(k_prop, (C,), jnp.float32))
        u_acc.append(jax.random.uniform(k_acc, (C,), jnp.float32))
    noise = metropolis.AMHNoise(**tensors(normal=jnp.stack(normal), u_acc=jnp.stack(u_acc)))
    ts, ti = tk.transition(interop.state_from_numpy(metropolis.AMHState, jstate, device="cpu"), noise)
    # each coordinate's accept margin, from the JAX model's logp along the sweep
    w, lp, margin = start.copy(), np.asarray(jstate.logp), np.full(C, np.inf)
    for k in range(3):
        w_new = w.copy()
        w_new[:, k] += np.asarray(normal[k]) * 0.05
        lp_new = np.asarray(jm.logp(jnp.asarray(w_new)))
        with np.errstate(divide="ignore", invalid="ignore"):
            gap = (lp_new - lp) - np.log(np.asarray(u_acc[k]))
        margin = np.minimum(margin, np.where(np.isfinite(gap), np.abs(gap), np.inf))
        acc = gap > 0
        w, lp = np.where(acc[:, None], w_new, w), np.where(acc, lp_new, lp)
    away = margin > MARGIN
    assert away.sum() >= 0.75 * C
    np.testing.assert_allclose(ts.position.numpy()[away], np.asarray(js.position)[away], atol=1e-6)
    np.testing.assert_allclose(ts.logp.numpy()[away], np.asarray(js.logp)[away], rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(ti.accept_prob.numpy(), np.asarray(ji.accept_prob), atol=1e-3)
    np.testing.assert_allclose(ti.accepted.numpy()[away], np.asarray(ji.accepted)[away], atol=1e-6)


# -- a short posterior run and the workload entry point ------------------------------


def test_torch_fhn_mmala_posterior_near_truth(models):
    """mMALA, the paper's FHN winner (ODE_mMALA.m:69: eps = 1), lands on the
    truth as tests/test_fhn.py:84-99 (shorter: 8 chains, 30 + 50 sweeps)."""
    _, tm = models
    from riemannhamiltonianmontecarlo_tpu_torch import parallel

    kernel = mmala.build(tm, mmala.MMALAConfig(step_size=1.0, jitter=1e-6))
    init = torch.from_numpy(THETA_TRUE * np.exp(0.1 * np.random.default_rng(4).normal(size=(8, 3))).astype(np.float32))
    res = parallel.run(kernel, torch.Generator().manual_seed(5), init, num_samples=50, burn_in=30)
    assert float(res.accept_rate) > 0.3
    mean = res.samples.reshape(-1, 3).mean(0).numpy()
    err = np.abs(mean - THETA_TRUE)
    assert np.all(err < np.array([0.15, 0.3, 0.3])), (mean, err)


@pytest.mark.parametrize("sampler", experiments.WORKLOAD_SAMPLERS["fhn"])
def test_torch_fhn_build_workload_small(sampler):
    kernel, init_fn, collect_fn, groups_fn, warmup = experiments.build_workload(
        "fhn", sampler, device="cpu", fhn_obs=20, fhn_substeps=2)
    assert collect_fn is None and warmup is None
    init = init_fn(4)
    assert init.shape == (4, 3) and torch.equal(init, init_fn(4))  # seeded: the same start every call
    state, info = kernel.step(torch.Generator().manual_seed(0), kernel.init(init))
    assert torch.isfinite(state.position).all() and info.accept_prob.shape == (4,)
    assert set(groups_fn(state.position[:, None])) == {"params"}
