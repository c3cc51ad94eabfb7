"""Port parity: the Holmes-Held Gibbs sampler, its truncated normals and GIG draws.

* ``truncated_normal_onesided`` given the JAX draws replayed from the key
  splits (central and tail paths, both signs): rtol 1e-4 / atol 1e-4, the
  float32 ``ndtr`` / ``ndtri`` of two libraries.
* ``sample_gig_half`` is a data-dependent rejection loop with its own
  stream (Philox words, not JAX's), so it is compared in distribution: a two-sample KS test
  (p > 1e-3) and the first two moments within 5 standard errors, at
  r^2 in {1e-4, 1, 25}.
* One Gibbs step's deterministic part given the replayed sweep and beta
  draws: V, chol(V), S, B, h (rtol 1e-4) and the swept z and beta
  (atol 1e-3: 60 or 208 dependent float32 updates of B), at D = 5 and at
  UCI Sonar's shape (208 rows, 60 features and the intercept: D = 61, past
  the 48 of the hand-written Cholesky).
* A short run against the JAX package's Gibbs run: posterior means within
  z < 5 from the exact-mode ESS of both runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

import riemannhamiltonianmontecarlo_tpu as rj
import riemannhamiltonianmontecarlo_tpu_torch as rt
from riemannhamiltonianmontecarlo_tpu.ops.gig import sample_gig_half as jax_gig
from riemannhamiltonianmontecarlo_tpu.ops.truncnorm import truncated_normal_onesided as jax_truncnorm
from riemannhamiltonianmontecarlo_tpu_torch import interop
from riemannhamiltonianmontecarlo_tpu_torch.ops import gig, truncnorm
from riemannhamiltonianmontecarlo_tpu_torch.ops.gig import sample_gig_half
from riemannhamiltonianmontecarlo_tpu_torch.samplers import gibbs

torch.set_num_threads(1)

_PREC = jax.lax.Precision.HIGHEST


def replay_truncnorm(key, shape):
    """The raw uniforms ``truncated_normal_onesided(key, ...)`` draws (truncnorm.py:38-55)."""
    k_small, k_tail = jax.random.split(key)
    u_e, u_tail = [], []
    for k in jax.random.split(k_tail, truncnorm.RETRY_ROUNDS):
        u1, u2 = jax.random.split(k)
        u_e.append(jax.random.uniform(u1, shape, jnp.float32))
        u_tail.append(jax.random.uniform(u2, shape, jnp.float32))
    return jax.random.uniform(k_small, shape, jnp.float32), jnp.stack(u_e), jnp.stack(u_tail)


def to_noise(u_central, u_e, u_tail):
    return truncnorm.TruncNormNoise(*(torch.tensor(np.asarray(u)) for u in (u_central, u_e, u_tail)))


def test_torch_truncnorm_matches_jax_given_its_draws():
    rng = np.random.default_rng(0)
    n = 3000
    mean = rng.uniform(-8.0, 8.0, n).astype(np.float32)
    std = rng.choice([0.5, 1.0, 2.0], n).astype(np.float32)
    positive = rng.uniform(size=n) < 0.5
    a = np.where(positive, -mean / std, mean / std)
    assert (a > truncnorm.TAIL_SPLIT).sum() > 500 and (a <= truncnorm.TAIL_SPLIT).sum() > 500
    key = jax.random.key(4)
    ref = np.asarray(jax_truncnorm(key, jnp.asarray(mean), jnp.asarray(std), jnp.asarray(positive)))
    port = truncnorm.truncated_normal_onesided(
        torch.from_numpy(mean), torch.from_numpy(std), torch.from_numpy(positive), to_noise(*replay_truncnorm(key, (n,)))
    ).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4)
    assert (port[positive] > 0).all() and (port[~positive] < 0).all()


@pytest.mark.parametrize("r2", [1e-4, 1.0, 25.0])
def test_torch_gig_matches_jax_in_distribution(r2):
    n = 4000
    ref = np.asarray(jax_gig(jax.random.key(int(r2 * 100) + 1), jnp.full((n,), r2, jnp.float32)), np.float64)
    port = sample_gig_half(torch.Generator().manual_seed(1), torch.full((n,), r2)).double().numpy()
    assert np.isfinite(port).all() and (port > 0).all()
    assert ks_2samp(port, ref).pvalue > 1e-3
    for k in (1, 2):
        a, b = port**k, ref**k
        se = np.sqrt(a.var() / n + b.var() / n)
        assert abs(a.mean() - b.mean()) < 5 * se, (k, a.mean(), b.mean(), se)


def test_torch_gig_zero_normal_draw_is_redrawn(monkeypatch):
    """A normal draw of exactly 0 (jax.random.normal cannot return one)
    makes the candidate r / 0 = inf, which must be redrawn, not accepted:
    the Box-Muller transform patched to give 0 to a quarter of each round's
    elements, one process's rounds never give an infinite lambda."""
    transform = gig.box_muller
    zeroed = []

    def zero_some(u1, u2):
        out = transform(u1, u2)
        out[..., ::4] = 0.0
        zeroed.append(out.shape[-1])
        return out

    monkeypatch.setattr(gig, "box_muller", zero_some)
    lam = sample_gig_half(torch.Generator().manual_seed(3), torch.full((256,), 1.0))
    assert zeroed and zeroed[0] == 256  # the patch was applied to the first round's draws
    assert torch.isfinite(lam).all() and (lam > 0).all()


# (seed, N, D) of the synthetic data: a small target, and UCI Sonar's shape
GIBBS_TARGETS = {"n60-d5": (9, 60, 5), "sonar-n208-d61": (0, 208, 61)}


@pytest.fixture(scope="module", params=list(GIBBS_TARGETS.values()), ids=list(GIBBS_TARGETS))
def gibbs_target(request):
    seed, n, d = request.param
    ds = rt.models.synthetic_logreg(seed=seed, n=n, d=d)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    return rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t)), interop.logreg_from_numpy(x, t, device="cpu")


def test_torch_gibbs_step_deterministic_part_matches_jax(gibbs_target):
    jm, tm = gibbs_target
    c, (n, d) = 16, jm.X.shape
    jk = rj.samplers.gibbs.build(jm)
    state = jax.jit(jk.step)(jax.random.key(1), jk.init(jnp.zeros((c, d))))[0]  # lambda != 1
    key = jax.random.key(2)
    js, _ = jax.jit(jk.step)(key, state)

    # the JAX step's quantities given lambda (gibbs.py:87-94)
    x, inv_lam = jm.X, 1.0 / state.lam
    v = jnp.einsum("cn,na,nb->cab", inv_lam, x, x, precision=_PREC) + jnp.eye(d) / 100.0
    v = rj.ops.inv_psd(v)
    s = jnp.einsum("cde,ne->cdn", v, x, precision=_PREC)
    ref = {
        "v": v,
        "chol_v": rj.ops.cholesky(v),
        "s": s,
        "b": jnp.einsum("cdn,cn->cd", s, inv_lam * state.z, precision=_PREC),
        "h": jnp.einsum("nd,cdn->cn", x, s, precision=_PREC),
    }
    tstate = interop.state_from_numpy(gibbs.GibbsState, state, device="cpu")
    cond = gibbs.conditionals(tm, tstate)
    for name, want in ref.items():
        want = np.asarray(want)
        np.testing.assert_allclose(getattr(cond, name).numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=name)

    # the sweep and beta draws, replayed from split(key, 3) (gibbs.py:85, :108, :128)
    k_sweep, k_beta, _ = jax.random.split(key, 3)
    u_central, u_e, u_tail = jax.vmap(lambda k: replay_truncnorm(k, (c,)))(jax.random.split(k_sweep, n))
    noise = to_noise(u_central, jnp.moveaxis(u_e, 1, 0), jnp.moveaxis(u_tail, 1, 0))
    b, z = gibbs.sweep(tm, tstate, cond, noise)
    np.testing.assert_allclose(z.numpy(), np.asarray(js.z), atol=1e-3)
    beta = b + rt.ops.mvn_sample(cond.chol_v, torch.tensor(np.asarray(jax.random.normal(k_beta, (c, d), jnp.float32))))
    np.testing.assert_allclose(beta.numpy(), np.asarray(js.position), atol=1e-3)


def test_torch_gibbs_posterior_matches_jax_run():
    ds = rt.models.synthetic_logreg(seed=21, n=50, d=3, w_scale=1.0)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    jm, tm = rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t)), interop.logreg_from_numpy(x, t, device="cpu")
    c, burn, n = 32, 50, 150
    # one scan each (burn-in kept, then dropped): the JAX run compiles once
    jres = rj.parallel.run(rj.samplers.gibbs.build(jm), jax.random.key(4), jnp.zeros((c, 3)), num_samples=burn + n)
    tres = rt.parallel.run(gibbs.build(tm), torch.Generator().manual_seed(4), torch.zeros(c, 3), num_samples=burn + n)
    assert int(tres.divergences) == 0 and float(tres.accept_rate) == 1.0
    runs = []
    for samples in (np.asarray(jres.samples)[:, burn:], tres.samples.numpy()[:, burn:]):
        assert np.isfinite(samples).all()
        flat = samples.reshape(-1, 3)
        runs.append((flat.mean(0), flat.var(0), rt.diagnostics.ess_multichain(samples, nfft_mode="exact")))
    (mj, vj, ej), (mt, vt, et) = runs
    assert (np.abs(mt - mj) / np.sqrt(vj / ej + vt / et)).max() < 5.0
    np.testing.assert_allclose(np.sqrt(vt), np.sqrt(vj), rtol=0.2)
