"""Port parity: the stochastic volatility model and its two-block sampler.

The same numpy-seeded inputs go through the JAX package's ``StochVolModel``
and the port's, method by method (T = 200), and one sweep of each of the
four methods (T = 50, C = 16) runs in both, the port's pure ``transition``
fed the JAX step's draws replayed from its key splits
(``samplers/stochvol.py:203``, then each block's own splits).

Decision margin and tolerances as in ``test_torch_samplers_blr.py``: a
sweep makes two accept decisions, and a chain whose latent or hyper
decision has |log a - log u| <= 1e-2 (a the port's block accept
probability) is left out of the decision and state checks.  Positions atol
1e-3, latent x atol 2e-3, accept probability atol 1e-3, log densities and
gradients rtol 1e-4 relative to their scale -- float32 on both sides, sums
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riemannhamiltonianmontecarlo_tpu.models import stochvol as jsv_model
from riemannhamiltonianmontecarlo_tpu.samplers import stochvol as jsv
from riemannhamiltonianmontecarlo_tpu_torch import interop
from riemannhamiltonianmontecarlo_tpu_torch.samplers import hmc, mala, mmala, rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.samplers import stochvol as tsv

torch.set_num_threads(1)
MARGIN = 1e-2


def scaled_close(port, ref, rel=1e-4, err_msg=""):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()), err_msg=err_msg)


def inputs(t: int, c: int, seed: int):
    """Data y, latents near the truth and hypers near (0.65, 0.15, 0.98), in float32."""
    y, x_true = jsv_model.generate_data(seed=seed, num_obs=t)
    rng = np.random.default_rng(seed)
    x = (x_true + 0.1 * rng.normal(size=(c, t))).astype(np.float32)
    beta = 0.65 + 0.05 * rng.normal(size=c)
    sigma = 0.15 * np.exp(0.1 * rng.normal(size=c))
    phi = np.clip(0.98 + 0.005 * rng.normal(size=c), 0.9, 0.995)
    theta = np.stack([beta, np.log(sigma), np.arctanh(phi)], -1).astype(np.float32)
    return y.astype(np.float32), x, theta


@pytest.fixture(scope="module")
def models_t200():
    y, x, theta = inputs(200, 6, seed=3)
    return jsv_model.StochVolModel(jnp.asarray(y)), interop.stochvol_from_numpy(y, device="cpu"), x, theta


def test_torch_stochvol_latent_methods_match_jax(models_t200):
    jm, tm, x, theta = models_t200
    jx, jth, tx, tth = jnp.asarray(x), jnp.asarray(theta), torch.from_numpy(x), torch.from_numpy(theta)
    for a, b in zip(tm.constrain(tth), jm.constrain(jth)):
        scaled_close(a, b)
    scaled_close(tm.unconstrain(*tm.constrain(tth)), tth.numpy())
    scaled_close(tm.latent_logp(tx, tth), jm.latent_logp(jx, jth), err_msg="latent_logp")
    scaled_close(tm.latent_grad(tx, tth), jm.latent_grad(jx, jth), err_msg="latent_grad")
    for name in ("ar1_precision", "latent_metric"):
        for a, b in zip(getattr(tm, name)(tth), getattr(jm, name)(jth)):
            assert a.shape == b.shape
            scaled_close(a, b, err_msg=name)


def test_torch_stochvol_hyper_methods_match_jax(models_t200):
    jm, tm, x, theta = models_t200
    jx, jth, tx, tth = jnp.asarray(x), jnp.asarray(theta), torch.from_numpy(x), torch.from_numpy(theta)
    scaled_close(tm.hyper_logp(tth, tx), jm.hyper_logp(jth, jx), err_msg="hyper_logp")
    scaled_close(tm.hyper_metric(tth), jm.hyper_metric(jth), err_msg="hyper_metric")

    jh, th = jm.hyper_manifold(jx), tm.hyper_manifold(tx)
    assert th.dim == jh.dim == 3
    jms, tms = jh.manifold_state(jth), th.manifold_state(tth)
    for name, port, ref in zip(("logp", "grad", "metric", "cache"), tms, jms):
        assert port.shape == ref.shape and port.dtype == torch.float32, name
        scaled_close(port, ref, err_msg=name)
    lp, g = th.logp_and_grad(tth)
    scaled_close(lp, jms.logp)
    scaled_close(g, jms.grad)

    rng = np.random.default_rng(1)
    u, v = (rng.normal(size=(6, 3)).astype(np.float32) for _ in range(2))
    a = rng.normal(size=(6, 3, 3))
    m = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)
    cache = jh.dg_cache(jth)
    scaled_close(th.dg_bilinear(tth, torch.from_numpy(u), torch.from_numpy(v)),
                 jh.dg_bilinear(jth, jnp.asarray(u), jnp.asarray(v), cache=cache), err_msg="dg_bilinear")
    scaled_close(th.dg_trace(tth, torch.from_numpy(m)), jh.dg_trace(jth, jnp.asarray(m), cache=cache), err_msg="dg_trace")
    scaled_close(th.dg_dotted(tth, torch.from_numpy(m)), jh.dg_dotted(jth, jnp.asarray(m), cache=cache), err_msg="dg_dotted")
    # one x (T,) shared by every chain, and one position
    shared, jshared = tm.hyper_manifold(tx[0]), jm.hyper_manifold(jx[0])
    scaled_close(shared.grad(tth), jshared.grad(jth))
    scaled_close(shared.logp(tth), jshared.logp(jth))
    scaled_close(shared.grad(tth[0]), jshared.grad(jth[0]))


# -- one sweep on replayed draws -------------------------------------------------

T, C = 50, 16
# The workload presets at T = 50 (experiments.build_workload).
CONFIGS = {
    "rmhmc": dict(),
    # the latent step is 4x the preset's, so that some chains reject at T = 50
    "hmc": dict(method="hmc", latent_num_leapfrog=100, latent_step_size=0.12,
                hyper_num_leapfrog=100, hyper_step_size=0.015),
    "mala": dict(method="mala", latent_step_size=0.03 / T ** (1 / 3), hyper_step_size=0.005 / T ** (1 / 3)),
    "mmala": dict(method="mmala", latent_step_size=0.07, hyper_step_size=1.0),
}


def tensors(**draws):
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def replay(key, method: str) -> tsv.StochVolNoise:
    """The JAX sweep's draws: split(key) -> (latent, hyper), then each block's splits."""
    k_latent, k_hyper = jax.random.split(key)
    if method in ("rmhmc", "hmc"):
        k_mom, k_len, k_dir, k_acc = jax.random.split(k_latent, 4)
        latent = tensors(normal=jax.random.normal(k_mom, (C, T), jnp.float32),
                         u_len=jax.random.uniform(k_len, (C,)), u_dir=jax.random.uniform(k_dir, (C,)),
                         u_acc=jax.random.uniform(k_acc, (C,), jnp.float32))
    else:
        k_prop, k_acc = jax.random.split(k_latent)
        latent = tensors(normal=jax.random.normal(k_prop, (C, T), jnp.float32), u_len=jnp.zeros(C),
                         u_dir=jnp.zeros(C), u_acc=jax.random.uniform(k_acc, (C,), jnp.float32))
    if method == "rmhmc":
        k_mom, k_chi, k_len, k_dir, k_acc = jax.random.split(k_hyper, 5)
        hyper = rmhmc.RMHMCNoise(**tensors(
            eps=jax.random.normal(k_mom, (C, 3), jnp.float32), chi_normal=jax.random.normal(k_chi, (C,), jnp.float32),
            u_len=jax.random.uniform(k_len, (C,)), u_dir=jax.random.uniform(k_dir, (C,)),
            u_acc=jax.random.uniform(k_acc, (C,), jnp.float32)))
    elif method == "hmc":
        k_mom, k_len, k_acc = jax.random.split(k_hyper, 3)
        hyper = hmc.HMCNoise(**tensors(p0=jax.random.normal(k_mom, (C, 3), jnp.float32),
                                       u_len=jax.random.uniform(k_len, (C,)), u_acc=jax.random.uniform(k_acc, (C,))))
    else:
        k_prop, k_acc = jax.random.split(k_hyper)
        cls = mala.MALANoise if method == "mala" else mmala.MMALANoise
        hyper = cls(**tensors(eps=jax.random.normal(k_prop, (C, 3), jnp.float32), u_acc=jax.random.uniform(k_acc, (C,))))
    return tsv.StochVolNoise(**latent, hyper=hyper)


def margin(accept_prob: torch.Tensor, u: torch.Tensor) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.abs(np.log(accept_prob.numpy()) - np.log(u.numpy()))


@pytest.mark.parametrize("method", list(CONFIGS))
def test_torch_stochvol_sweep_matches_jax_step(method):
    y, x, theta = inputs(T, C, seed=4)
    jm, tm = jsv_model.StochVolModel(jnp.asarray(y)), interop.stochvol_from_numpy(y, device="cpu")
    cfg = CONFIGS[method]
    jk = jsv.build(jm, jsv.StochVolConfig(**cfg))
    tcfg = tsv.StochVolConfig(**cfg)
    tk = tsv.build(tm, tcfg)

    position = np.stack(jm.constrain(jnp.asarray(theta)), -1)
    jstate = jsv.StochVolState(jnp.asarray(position), jnp.asarray(theta), jnp.asarray(x))
    key = jax.random.key(31)
    js, ji = jax.jit(jk.step)(key, jstate)
    noise = replay(key, method)
    tstate = interop.state_from_numpy(tsv.StochVolState, jstate, device="cpu")
    ts, ti = tk.transition(tstate, noise)

    # the two blocks on the port's side, for the margins and the Info algebra
    lat = tsv.latent_update(tm, tcfg, tstate.x, tstate.theta, noise)
    hm = tm.hyper_manifold(lat.x)
    hk = tsv.hyper_kernel(tcfg, hm)
    _, hi = hk.transition(tsv._hyper_init(tcfg, hk, hm, tstate.theta), noise.hyper)
    torch.testing.assert_close(ti.accept_prob, 0.5 * (lat.accept_prob + hi.accept_prob), rtol=0, atol=0)
    torch.testing.assert_close(ti.accepted, 0.5 * (lat.accepted.float() + hi.accepted.float()), rtol=0, atol=0)
    assert torch.equal(ti.divergent, lat.divergent | hi.divergent)

    away = (margin(lat.accept_prob, noise.u_acc) > MARGIN) & (margin(hi.accept_prob, noise.hyper.u_acc) > MARGIN)
    assert away.sum() >= 0.75 * C, away.sum()
    np.testing.assert_allclose(ti.accept_prob.numpy()[away], np.asarray(ji.accept_prob)[away], atol=1e-3)
    np.testing.assert_array_equal(ti.accepted.numpy()[away], np.asarray(ji.accepted)[away])
    np.testing.assert_array_equal(ti.divergent.numpy(), np.asarray(ji.divergent))
    np.testing.assert_allclose(ts.position.numpy()[away], np.asarray(js.position)[away], atol=1e-3)
    np.testing.assert_allclose(ts.theta.numpy()[away], np.asarray(js.theta)[away], atol=1e-3)
    np.testing.assert_allclose(ts.x.numpy()[away], np.asarray(js.x)[away], atol=2e-3)
    # both branches compared: some block decisions accepted, some rejected
    decisions = torch.cat([lat.accepted, hi.accepted])
    assert decisions.any() and not decisions.all()


def test_torch_stochvol_sweep_info_is_the_mean_over_blocks():
    """Sweep-level Info (tests/test_stochvol.py:101-117): with the latent step
    tiny (accepts ~always) and the hyper step enormous (rejects ~always),
    ``accepted`` sits near 0.5, the mean over the two blocks."""
    y, _ = jsv_model.generate_data(seed=3, num_obs=300)
    model = interop.stochvol_from_numpy(y, device="cpu")
    kernel = tsv.build(model, tsv.StochVolConfig(method="mala", latent_step_size=1e-5, hyper_step_size=50.0))
    gen = torch.Generator().manual_seed(0)
    state = kernel.init(torch.full((32, 3), 0.5))
    assert state.x.shape == (32, 300) and state.x.is_contiguous()  # a real tensor, not a view of y
    accepted = []
    with torch.inference_mode():
        for _ in range(20):
            state, info = kernel.step(gen, state)
            assert info.accepted.shape == (32,) and info.accepted.dtype == torch.float32
            assert set(info.accepted.unique().tolist()) <= {0.0, 0.5, 1.0}
            accepted.append(info.accepted.mean().item())
    assert 0.4 < float(np.mean(accepted)) < 0.62


def test_torch_stochvol_rejects_an_unknown_method():
    model = interop.stochvol_from_numpy(np.ones(10), device="cpu")
    with pytest.raises(ValueError, match="unknown stochvol method"):
        tsv.build(model, tsv.StochVolConfig(method="nuts"))


def test_torch_function_model_matches_jax():
    """models.base.FunctionModel: logp and its torch.func gradient, batched and single."""
    from riemannhamiltonianmontecarlo_tpu.models.base import FunctionModel as JFunctionModel
    from riemannhamiltonianmontecarlo_tpu_torch.models import FunctionModel

    def banana(w, lib):
        return -0.5 * (w[0] ** 2 / 4.0 + (w[1] - w[0] ** 2) ** 2) - lib.sum(w[2:] ** 2)

    jm, tm = JFunctionModel(4, lambda w: banana(w, jnp)), FunctionModel(4, lambda w: banana(w, torch))
    w = np.random.default_rng(5).normal(size=(2, 3, 4)).astype(np.float32)
    scaled_close(tm.logp(torch.from_numpy(w)), jm.logp(jnp.asarray(w)))
    scaled_close(tm.grad(torch.from_numpy(w)), jm.grad(jnp.asarray(w)))
    scaled_close(tm.grad(torch.from_numpy(w[0, 0])), jm.grad(jnp.asarray(w[0, 0])))


def test_torch_autodiff_under_inference_mode_matches_jax(models_t200):
    """The chain runner steps under ``torch.inference_mode()``, where torch
    2.11's ``torch.func.grad`` / ``jacrev`` return zeros without an error:
    the port runs every transform with inference mode off
    (``models.base.with_autograd``), here on inference tensors."""
    from riemannhamiltonianmontecarlo_tpu_torch.models import FunctionModel

    jm, tm, x, theta = models_t200
    seen = []

    def quadratic(w):
        seen.append(torch.is_inference_mode_enabled())
        return -0.5 * torch.sum(w**2)

    with torch.inference_mode():
        tx, tth = torch.from_numpy(x).clone(), torch.from_numpy(theta).clone()
        assert tx.is_inference() and tth.is_inference()
        th = tm.hyper_manifold(tx)
        grad, cache = th.grad(tth), th.dg_cache(tth)
        w = tth.clone()
        quad_grad = FunctionModel(3, quadratic).grad(w)
    assert seen and not any(seen)
    torch.testing.assert_close(quad_grad, -w, rtol=0, atol=0)
    jh = jm.hyper_manifold(jnp.asarray(x))
    scaled_close(grad, jh.grad(jnp.asarray(theta)), err_msg="grad")
    scaled_close(cache, jh.dg_cache(jnp.asarray(theta)), err_msg="dg_cache")
