"""Port parity: the log-Gaussian Cox model and its constant-metric samplers.

The same numpy-seeded inputs go through the JAX package's ``LGCModel`` and
the port's at n = 8 (D = 64), built on the same float32 operators; then one
transition each of constant-metric RMHMC (``phmc``), constant-metric mMALA
(``pmala``) and the position-dependent ``mmala`` on the LGC posterior runs
in both, the port's pure ``transition`` fed the JAX step's draws replayed
from its key splits.

Decision margin and tolerances as in ``test_torch_samplers_blr.py``: chains
with |log a - log u| <= 1e-2 (a the JAX accept probability) are left out of
the decision and state checks.  Positions atol 1e-3, accept probability
atol 1e-3; log densities, gradients and matrices atol 1e-4 relative to
their scale (|logp| ~ 1e2, D = 64 terms) -- float32 on both sides, sums in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riemannhamiltonianmontecarlo_tpu.models import lgc as jlgc
from riemannhamiltonianmontecarlo_tpu.samplers import mmala as jmmala
from riemannhamiltonianmontecarlo_tpu.samplers import phmc as jphmc
from riemannhamiltonianmontecarlo_tpu.samplers import pmala as jpmala
from riemannhamiltonianmontecarlo_tpu_torch import interop
from riemannhamiltonianmontecarlo_tpu_torch.samplers import mmala, phmc, pmala

torch.set_num_threads(1)
N, C = 8, 24
D = N * N
MARGIN = 1e-2


def scaled_close(port, ref, rel=1e-4, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()), err_msg=err_msg)


@pytest.fixture(scope="module")
def target():
    y, x_true = jlgc.generate_data(seed=2, n=N)
    jm = jlgc.LGCModel(jnp.asarray(y, jnp.float32), n=N)
    tm = interop.lgc_from_numpy(y, N, np.asarray(jm.sigma_inv), np.asarray(jm.metric_chol), np.asarray(jm.metric_inv), device="cpu")
    pos = (x_true + 0.05 * np.random.default_rng(0).normal(size=(C, D))).astype(np.float32)
    return jm, tm, pos


def test_torch_lgc_operators_carried_across_give_identical_outputs(target):
    """A JAX model's operators carried across, against the port's own float64
    host setup: the same numpy algebra cast to float32, so bit for bit."""
    jm, tm, pos = target
    own = interop.lgc_from_numpy(np.asarray(jm.y), N, device="cpu")
    for name in ("y", "sigma_inv", "metric_chol", "metric_inv"):
        assert torch.equal(getattr(own, name), getattr(tm, name)), name
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    x = torch.from_numpy(pos)
    for a, b in zip(own.logp_and_grad(x), tm.logp_and_grad(x)):
        assert torch.equal(a, b)
    assert torch.equal(own.metric(x), tm.metric(x))
    assert own.mu == tm.mu == jm.mu and own.m == tm.m == jm.m and tm.dim == jm.dim == D


def test_torch_lgc_model_methods_match_jax(target):
    jm, tm, pos = target
    jx, tx = jnp.asarray(pos), torch.from_numpy(pos)
    scaled_close(tm.logp(tx), jm.logp(jx), err_msg="logp")
    scaled_close(tm.grad(tx), jm.grad(jx), err_msg="grad")
    for name in ("logp_and_grad", "logp_and_grad_fast"):
        for port, ref in zip(getattr(tm, name)(tx), getattr(jm, name)(jx)):
            scaled_close(port, ref, err_msg=name)
    np.testing.assert_array_equal(tm.prior_mean().numpy(), np.asarray(jm.prior_mean()))

    jms, tms = jm.manifold_state(jx[:4]), tm.manifold_state(tx[:4])
    for name, port, ref in zip(("logp", "grad", "metric", "cache"), tms, jms):
        assert port.shape == ref.shape, name
        scaled_close(port, ref, err_msg=name)
    rng = np.random.default_rng(1)
    u, v = (rng.normal(size=(4, D)).astype(np.float32) for _ in range(2))
    a = rng.normal(size=(4, D, D)) / D
    m = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)
    jx4, tx4 = jx[:4], tx[:4]
    scaled_close(tm.dg_bilinear(tx4, torch.from_numpy(u), torch.from_numpy(v)),
                 jm.dg_bilinear(jx4, jnp.asarray(u), jnp.asarray(v)), err_msg="dg_bilinear")
    scaled_close(tm.dg_trace(tx4, torch.from_numpy(m)), jm.dg_trace(jx4, jnp.asarray(m)), err_msg="dg_trace")
    scaled_close(tm.dg_dotted(tx4, torch.from_numpy(m)), jm.dg_dotted(jx4, jnp.asarray(m)), err_msg="dg_dotted")


def test_torch_lgc_whitened_matches_jax(target):
    jm, tm, pos = target
    jw, tw = jm.whitened(), tm.whitened()
    assert tw.dim == jw.dim == D
    gamma = np.random.default_rng(3).normal(size=(C, D)).astype(np.float32)
    jg, tg = jnp.asarray(gamma), torch.from_numpy(gamma)
    scaled_close(tw.to_x(tg), jw.to_x(jg), err_msg="to_x")
    scaled_close(tw.logp(tg), jw.logp(jg), err_msg="logp")
    scaled_close(tw.grad(tg), jw.grad(jg), err_msg="grad")
    for port, ref in zip(tw.logp_and_grad(tg), jw.logp_and_grad(jg)):
        scaled_close(port, ref)


# -- one transition on replayed draws --------------------------------------------


def tensors(**draws):
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def compare(jstate, jinfo, tstate, tinfo, u_acc):
    ap = np.asarray(jinfo.accept_prob)
    with np.errstate(divide="ignore"):
        away = np.abs(np.log(ap) - np.log(u_acc.numpy())) > MARGIN
    assert away.sum() >= 0.75 * C
    np.testing.assert_allclose(tinfo.accept_prob.numpy(), ap, atol=1e-3)
    np.testing.assert_array_equal(tinfo.accepted.numpy()[away], np.asarray(jinfo.accepted)[away])
    np.testing.assert_array_equal(tinfo.divergent.numpy(), np.asarray(jinfo.divergent))
    for name in tstate._fields:
        port, ref = getattr(tstate, name).numpy()[away], np.asarray(getattr(jstate, name))[away]
        if name == "position":
            np.testing.assert_allclose(port, ref, atol=1e-3, err_msg=name)
        else:
            np.testing.assert_allclose(port, ref, rtol=0, atol=1e-4 * np.abs(ref).max(), err_msg=name)
    assert tinfo.accepted.any() and not tinfo.accepted.all()  # both branches compared


@pytest.mark.parametrize("randomize", [True, False], ids=["random-length", "fixed-length"])
def test_torch_phmc_transition_matches_jax_step(target, randomize):
    jm, tm, pos = target
    cfg = dict(step_size=0.5, num_leapfrog=10, randomize_length=randomize, random_direction=randomize)
    jk = jphmc.build(jm, jm.metric_chol, jm.metric_inv, jphmc.PHMCConfig(**cfg))
    tk = phmc.build(tm, tm.metric_chol, tm.metric_inv, phmc.PHMCConfig(**cfg))
    key = jax.random.key(41)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(pos)))
    k_mom, k_len, k_dir, k_acc = jax.random.split(key, 4)
    noise = phmc.PHMCNoise(**tensors(
        z=jax.random.normal(k_mom, (C, D), jnp.float32), u_len=jax.random.uniform(k_len, (C,)),
        u_dir=jax.random.uniform(k_dir, (C,)), u_acc=jax.random.uniform(k_acc, (C,), jnp.float32)))
    ts, ti = tk.transition(tk.init(torch.from_numpy(pos)), noise)
    compare(js, ji, ts, ti, noise.u_acc)


def test_torch_phmc_tf32_trajectory_restores_full_fp32(target):
    """trajectory_precision="default" allows TF32 inside the leapfrog only;
    the flag is back off after the step (on the CPU the result is the same)."""
    jm, tm, pos = target
    tk = phmc.build(tm, tm.metric_chol, tm.metric_inv, phmc.PHMCConfig(trajectory_precision="default"))
    exact = phmc.build(tm, tm.metric_chol, tm.metric_inv, phmc.PHMCConfig())
    state = tk.init(torch.from_numpy(pos))
    noise = phmc.draw_noise(torch.Generator().manual_seed(0), state.position)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    (s1, i1), (s2, i2) = tk.transition(state, noise), exact.transition(state, noise)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    torch.testing.assert_close(s1.position, s2.position)
    with pytest.raises(ValueError, match="trajectory_precision"):
        phmc.build(tm, tm.metric_chol, tm.metric_inv, phmc.PHMCConfig(trajectory_precision="bf16"))


def test_torch_pmala_transition_matches_jax_step(target):
    jm, tm, pos = target
    cfg = pmala.PMALAConfig(step_size=0.5)
    jk = jpmala.build(jm, jm.metric_chol, jm.metric_inv, jpmala.PMALAConfig(step_size=0.5))
    tk = pmala.build(tm, tm.metric_chol, tm.metric_inv, cfg)
    key = jax.random.key(42)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(pos)))
    k_noise, k_acc = jax.random.split(key)
    noise = pmala.PMALANoise(**tensors(z=jax.random.normal(k_noise, (C, D), jnp.float32),
                                       u_acc=jax.random.uniform(k_acc, (C,), jnp.float32)))
    ts, ti = tk.transition(tk.init(torch.from_numpy(pos)), noise)
    compare(js, ji, ts, ti, noise.u_acc)


def test_torch_mmala_on_lgc_transition_matches_jax_step(target):
    """The position-dependent mMALA on the LGC posterior (D = 64: the library
    Cholesky path on a card, the unrolled one on the CPU)."""
    jm, tm, pos = target
    cfg = dict(step_size=0.3, jitter=1e-5)
    jk = jmmala.build(jm, jmmala.MMALAConfig(**cfg))
    tk = mmala.build(tm, mmala.MMALAConfig(**cfg))
    key = jax.random.key(43)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(pos)))
    k_prop, k_acc = jax.random.split(key)
    noise = mmala.MMALANoise(**tensors(eps=jax.random.normal(k_prop, (C, D), jnp.float32),
                                       u_acc=jax.random.uniform(k_acc, (C,), jnp.float32)))
    ts, ti = tk.transition(tk.init(torch.from_numpy(pos)), noise)
    compare(js, ji, ts, ti, noise.u_acc)


@pytest.mark.parametrize("name", ["phmc", "pmala"])
def test_torch_state_from_numpy_takes_the_lgc_states(target, name):
    jm, tm, pos = target
    jmod, tmod = {"phmc": (jphmc, phmc), "pmala": (jpmala, pmala)}[name]
    jstate = jmod.build(jm, jm.metric_chol, jm.metric_inv).init(jnp.asarray(pos[:4]))
    state_type = phmc.PHMCState if name == "phmc" else pmala.PMALAState
    tstate = interop.state_from_numpy(state_type, jstate, device="cpu")
    assert type(tstate) is state_type and tstate._fields == jstate._fields
    for field in tstate._fields:
        assert getattr(tstate, field).dtype == torch.float32
        np.testing.assert_array_equal(getattr(tstate, field).numpy(), np.asarray(getattr(jstate, field)))
