"""Port parity: one RMHMC transition against the JAX package's step.

The JAX step draws its noise from five key splits (``rmhmc.py:138``); the
test replays those draws, hands them to the port's pure ``transition`` as
numpy, and compares the results.  Accept decisions can flip only where
``ratio`` sits on ``log u``; chains with |log a - log u| <= 1e-2 (a the JAX
accept probability) are left out of the decision and position checks.
Tolerances: positions atol 1e-3, logp atol 1e-2 (|logp| ~ 1e2), accept
probability atol 1e-3 -- six float32 leapfrog steps of 4-round fixed
points, with sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu as rj
from riemannhamiltonianmontecarlo_tpu_torch import interop, ops
from riemannhamiltonianmontecarlo_tpu_torch.models import synthetic_logreg
from riemannhamiltonianmontecarlo_tpu_torch.samplers import rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import metropolis_accept, tree_where

torch.set_num_threads(1)

N, D, C = 100, 7, 32
MARGIN = 1e-2


@pytest.fixture(scope="module")
def target():
    ds = synthetic_logreg(seed=5, n=N, d=D)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    jm = rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t))
    tm = interop.logreg_from_numpy(x, t, device="cpu")
    center = np.asarray(rj.utils.map_estimate(jm))
    pos = (center + 0.1 * np.random.default_rng(0).normal(size=(C, D))).astype(np.float32)
    return jm, tm, pos


def jax_noise(key):
    """The JAX step's draws, replayed from its key splits."""
    k_mom, k_chi, k_len, k_dir, k_acc = jax.random.split(key, 5)
    u_dir = jax.random.uniform(k_dir, (C,))
    # the step draws the direction as bernoulli(k_dir, 0.5): the same bits
    assert (np.asarray(jax.random.bernoulli(k_dir, 0.5, (C,))) == (np.asarray(u_dir) < 0.5)).all()
    draws = {
        "eps": jax.random.normal(k_mom, (C, D), jnp.float32),
        "chi_normal": jax.random.normal(k_chi, (C,), jnp.float32),
        "u_len": jax.random.uniform(k_len, (C,)),
        "u_dir": u_dir,
        "u_acc": jax.random.uniform(k_acc, (C,), jnp.float32),
    }
    return rmhmc.RMHMCNoise(**{k: torch.tensor(np.asarray(v)) for k, v in draws.items()})


CONFIGS = {
    "reference": {},
    "student_t": {"student_t": True},
    "fixed_direction": {"random_direction": False},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_torch_transition_matches_jax_step(target, name):
    jm, tm, pos = target
    jk = rj.samplers.rmhmc.build(jm, rj.samplers.rmhmc.RMHMCConfig(**CONFIGS[name]))
    tk = rmhmc.build(tm, rmhmc.RMHMCConfig(**CONFIGS[name]))
    key = jax.random.key(17)
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(pos)))
    noise = jax_noise(key)
    ts, ti = tk.transition(tk.init(torch.from_numpy(pos)), noise)

    ap = np.asarray(ji.accept_prob)
    with np.errstate(divide="ignore"):
        away = np.abs(np.log(ap) - np.log(noise.u_acc.numpy())) > MARGIN
    assert away.sum() >= 0.75 * C
    np.testing.assert_allclose(ti.accept_prob.numpy(), ap, atol=1e-3)
    np.testing.assert_array_equal(ti.accepted.numpy()[away], np.asarray(ji.accepted)[away])
    np.testing.assert_array_equal(ti.divergent.numpy()[away], np.asarray(ji.divergent)[away])
    np.testing.assert_allclose(ts.position.numpy()[away], np.asarray(js.position)[away], atol=1e-3)
    np.testing.assert_allclose(ts.logp.numpy()[away], np.asarray(js.logp)[away], atol=1e-2)
    assert ti.accepted.any()  # the compared positions include moves


def test_torch_init_geometry_from_interop(target):
    """The JAX init's _Geometry through interop equals the port's own init."""
    jm, tm, pos = target
    jk, tk = rj.samplers.rmhmc.build(jm), rmhmc.build(tm)
    jstate = jk.init(jnp.asarray(pos))
    carried = interop.rmhmc_state_from_numpy(
        np.asarray(jstate.position), np.asarray(jstate.logp),
        geo={k: np.asarray(v) for k, v in jstate.geo._asdict().items()}, device="cpu",
    )
    own = tk.init(torch.from_numpy(pos))
    for name in own.geo._fields:
        ref = getattr(carried.geo, name).numpy()
        np.testing.assert_allclose(getattr(own.geo, name).numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    # and a transition from the carried state agrees with one from the port's state
    noise = jax_noise(jax.random.key(3))
    a, ia = tk.transition(carried, noise)
    b, ib = tk.transition(own, noise)
    np.testing.assert_allclose(ia.accept_prob.numpy(), ib.accept_prob.numpy(), atol=1e-3)
    lazy = interop.rmhmc_state_from_numpy(pos, np.asarray(jstate.logp), device="cpu")
    assert lazy.geo is None
    c, _ = tk.transition(lazy, noise)  # geometry rebuilt lazily
    np.testing.assert_allclose(c.position.numpy(), b.position.numpy(), atol=1e-5)


def test_torch_geometry_is_one_chol_inv_logdet_call(target, monkeypatch):
    """The geometry is one ``ops.chol_inv_logdet`` call (K3 on a card), at init and after each of the L
    leapfrog steps, with ``config.linalg`` as its method; none of the three calls it stands for."""
    _, tm, pos = target
    calls, real = [], ops.chol_inv_logdet
    monkeypatch.setattr(ops, "chol_inv_logdet", lambda g, method=None: calls.append((tuple(g.shape), method))
                        or real(g, method=method))
    for name in ("cholesky", "inv_psd_from_chol", "logdet_from_chol"):
        monkeypatch.setattr(ops, name, lambda *args, name=name, **kw: pytest.fail(f"geometry called ops.{name}"))
    tk = rmhmc.build(tm, rmhmc.RMHMCConfig(linalg="unrolled"))
    state = tk.init(torch.from_numpy(pos))
    tk.transition(state, jax_noise(jax.random.key(4)))
    assert calls == [((C, D, D), "unrolled")] * (1 + rmhmc.RMHMCConfig().num_leapfrog)


def test_torch_zero_length_trajectory_keeps_position(target):
    """u_len = 0 gives ceil(0) = 0 leapfrog steps: ratio 0, accepted, unmoved."""
    _, tm, pos = target
    tk = rmhmc.build(tm)
    noise = jax_noise(jax.random.key(9))._replace(u_len=torch.zeros(C))
    state = tk.init(torch.from_numpy(pos))
    new, info = tk.transition(state, noise)
    assert info.accepted.all() and not info.divergent.any()
    assert torch.equal(new.position, state.position)
    assert torch.equal(info.accept_prob, torch.ones(C))


def test_torch_metropolis_accept_edges():
    u = torch.tensor([0.0, 0.5, 0.5, 0.5, 0.9])
    ratio = torch.tensor([-50.0, 0.1, float("nan"), -0.1, -0.01])
    div = torch.tensor([False, False, False, True, False])
    accept, prob = metropolis_accept(u, ratio, div)
    # log(0) = -inf accepts any finite ratio; NaN and divergent reject
    assert accept.tolist() == [True, True, False, False, True]
    torch.testing.assert_close(prob, torch.tensor([np.exp(-50.0), 1.0, 0.0, 0.0, np.exp(-0.01)]).float())


def test_torch_tree_where_walks_namedtuples():
    a = rmhmc.RMHMCState(torch.zeros(3, 2), torch.zeros(3), None)
    b = rmhmc.RMHMCState(torch.ones(3, 2), torch.ones(3), None)
    out = tree_where(torch.tensor([True, False, True]), a, b)
    assert isinstance(out, rmhmc.RMHMCState) and out.geo is None
    assert out.position[:, 0].tolist() == [0.0, 1.0, 0.0] and out.logp.tolist() == [0.0, 1.0, 0.0]
