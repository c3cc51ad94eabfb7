"""Port parity: the joint log-Gaussian Cox model, its two-block sampler and its tool.

The same numpy-seeded inputs go through the JAX package's ``LGCJointModel``
and the port's (grids n = 6 and 8, D = 36 and 64), method by method, and one
sweep of each of the two methods (n = 6, C = 16) runs in both, the port's
pure ``transition`` fed the JAX step's draws replayed from its key splits
(``samplers/lgc_joint.py:182``, then each block's own splits).

Tolerances: model quantities rtol 2e-3 / atol 2e-3 (float32 on both sides,
dense factorizations of K with another summation order; the JAX package's
own closed-form-against-oracle test allows 5e-3 .. 2e-2,
``tests/test_lgc.py:288-298``).  Sweep: as ``test_torch_stochvol.py``, a
chain whose hyper or latent decision has |log a - log u| <= 1e-2 is left
out of the decision and state checks; accept probability atol 1e-3,
theta~ atol 1e-3, latent x atol 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riemannhamiltonianmontecarlo_tpu.models import lgc as jlgc
from riemannhamiltonianmontecarlo_tpu.samplers import lgc_joint as jjoint
from riemannhamiltonianmontecarlo_tpu_torch import experiments, interop
from riemannhamiltonianmontecarlo_tpu_torch.samplers import lgc_joint as tjoint
from riemannhamiltonianmontecarlo_tpu_torch.samplers import mmala, rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.tools import run_lgc_joint as tool

torch.set_num_threads(1)
MARGIN = 1e-2
RTOL = ATOL = 2e-3
THETA0 = np.log([1.91, 1.0 / 33.0])


def close(port, ref, err_msg=""):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == np.shape(ref), (err_msg, port.shape, np.shape(ref))
    np.testing.assert_allclose(port, np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=err_msg)


def inputs(n: int, c: int, seed: int, spread: float = 0.2):
    """Counts y, latents near the generating field and theta~ near the generating values, in float32."""
    y, x_true = jlgc.generate_data(seed=seed, n=n)
    rng = np.random.default_rng(seed)
    x = (x_true + 0.3 * rng.normal(size=(c, n * n))).astype(np.float32)
    theta = (THETA0 + spread * rng.normal(size=(c, 2))).astype(np.float32)
    return y.astype(np.float32), x, theta


def models(y, n):
    return jlgc.LGCJointModel(jnp.asarray(y), n=n), interop.lgc_joint_from_numpy(y, n, device="cpu")


@pytest.mark.parametrize("shared_x", [False, True], ids=["x-per-chain", "one-x"])
@pytest.mark.parametrize("n", [6, 8])
def test_torch_lgc_joint_hyper_manifold_matches_jax(n, shared_x):
    y, x, theta = inputs(n, 5, seed=8)
    jm, tm = models(y, n)
    assert tm.dim == jm.dim == n * n and tm.mu == pytest.approx(jm.mu) and tm.y.dtype == torch.float32
    xs = x[0] if shared_x else x
    jh, th = jm.hyper_manifold(jnp.asarray(xs)), tm.hyper_manifold(torch.from_numpy(xs))
    jth, tth = jnp.asarray(theta), torch.from_numpy(theta)
    assert th.dim == jh.dim == 2

    jms, tms = jh.manifold_state(jth), th.manifold_state(tth)
    for name, port, ref in zip(("logp", "grad", "metric", "cache"), tms, jms):
        assert port.dtype == torch.float32, name
        close(port, ref, name)
    # the three call shapes, each on its own
    close(th.logp(tth), jms.logp, "logp alone")
    close(th.grad(tth), jms.grad, "grad alone")
    close(th.metric(tth), jms.metric, "metric alone")
    close(th.dg_cache(tth), jms.cache, "dg_cache alone")
    lp, g = th.logp_and_grad(tth)
    close(lp, jms.logp)
    close(g, jms.grad)

    rng = np.random.default_rng(1)
    u, v = (rng.normal(size=(5, 2)).astype(np.float32) for _ in range(2))
    a = rng.normal(size=(5, 2, 2))
    m = (a @ np.swapaxes(a, -1, -2) / 10.0).astype(np.float32)
    tu, tv, tmm = (torch.from_numpy(t) for t in (u, v, m))
    for cache_t, cache_j in ((None, None), (tms.cache, jms.cache)):
        close(th.dg_bilinear(tth, tu, tv, cache=cache_t), jh.dg_bilinear(jth, jnp.asarray(u), jnp.asarray(v), cache=cache_j),
              "dg_bilinear")
        close(th.dg_trace(tth, tmm, cache=cache_t), jh.dg_trace(jth, jnp.asarray(m), cache=cache_j), "dg_trace")
        close(th.dg_dotted(tth, tmm, cache=cache_t), jh.dg_dotted(jth, jnp.asarray(m), cache=cache_j), "dg_dotted")
    # one position (2,), and leading axes (1, C)
    close(th.metric(tth[0]), jh.metric(jth[0]), "single metric")
    if shared_x:
        close(th.grad(tth[0]), jh.grad(jth[0]), "single grad")
        close(th.logp(tth[None]), np.asarray(jh.logp(jth))[None], "leading axes")


@pytest.mark.parametrize("n", [6, 8])
def test_torch_lgc_joint_latent_block_matches_jax(n):
    y, x, theta = inputs(n, 4, seed=9)
    jm, tm = models(y, n)
    jth, tth = jnp.asarray(theta), torch.from_numpy(theta)
    close(tm.sigma_of(tth), jax.vmap(jm.sigma_of)(jth), "sigma_of")
    close(tm.sigma_of(tth[0]), jm.sigma_of(jth[0]), "sigma_of single")
    j_mass, t_mass = jax.vmap(jm.latent_mass)(jth), tm.latent_mass(tth)
    for name, port, ref in zip(("sigma_inv", "chol_g", "g_inv"), t_mass, j_mass):
        close(port, ref, name)
    for name, port, ref in zip(("sigma_inv", "chol_g", "g_inv"), tm.latent_mass(tth[1]), jm.latent_mass(jth[1])):
        close(port, ref, name + " single")
    j_lp, j_g = jm.latent_logp_and_grad(jnp.asarray(x), j_mass[0])
    t_lp, t_g = tm.latent_logp_and_grad(torch.from_numpy(x), torch.tensor(np.asarray(j_mass[0])))
    close(t_lp, j_lp, "latent logp")
    close(t_g, j_g, "latent grad")


@pytest.mark.parametrize("inference", [False, True], ids=["grad-mode", "inference-mode"])
def test_torch_lgc_joint_closed_form_matches_the_autodiff_oracle(inference):
    """The fused closed form against the port's own ``torch.func`` oracle, as
    ``tests/test_lgc.py::test_lgc_joint_closed_form_matches_autodiff_oracle``
    holds the JAX pair (tolerances from there), also under the runner's
    inference mode, where the oracle needs ``with_autograd`` and the closed
    form nothing; and the oracle against the JAX package's."""
    n = 6
    y, _ = jlgc.generate_data(seed=9, n=n)
    x = jlgc.generate_data(seed=10, n=n)[1].astype(np.float32)
    jm, tm = models(y.astype(np.float32), n)
    ths = np.asarray([THETA0, [0.2, -3.0], [1.0, -4.0]], np.float32)
    with torch.inference_mode(inference):
        tx, tth = torch.from_numpy(x).clone(), torch.from_numpy(ths).clone()
        fast, slow = tm.hyper_manifold(tx), tm.hyper_manifold(tx, use_autodiff=True)
        f, s = fast.manifold_state(tth), slow.manifold_state(tth)
        m = torch.linalg.inv_ex(f.metric)[0]
        traces = fast.dg_trace(tth, m), slow.dg_trace(tth, m)
    assert s.grad.abs().max() > 1.0 and s.cache.abs().max() > 1.0  # not the zeros of an unguarded transform
    np.testing.assert_allclose(f.logp.numpy(), s.logp.numpy(), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(f.grad.numpy(), s.grad.numpy(), rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(f.metric.numpy(), s.metric.numpy(), rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(f.cache.numpy(), s.cache.numpy(), rtol=2e-2, atol=0.3)
    np.testing.assert_allclose(traces[0].numpy(), traces[1].numpy(), rtol=2e-2, atol=0.3)
    j_slow = jm.hyper_manifold(jnp.asarray(x), use_autodiff=True).manifold_state(jnp.asarray(ths))
    for name, port, ref in zip(("logp", "grad", "metric", "cache"), s, j_slow):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=5e-3, atol=5e-2, err_msg=name)


# -- one sweep on replayed draws -------------------------------------------------

N, C = 6, 16
D = N * N
# Steps several times the presets', so that some chains reject (and a few
# diverge) in each block at this small size.
CONFIGS = {
    "rmhmc": dict(hyper_step_size=1.5, latent_step_size=0.45),
    "mmala": dict(method="mmala", hyper_step_size=1.2, latent_step_size=0.6),
}


def tensors(**draws):
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def replay(key, method: str) -> tjoint.LGCJointNoise:
    """The JAX sweep's draws: split(key) -> (hyper, latent), then each block's splits."""
    k_hyper, k_latent = jax.random.split(key)
    if method == "rmhmc":
        k_mom, k_chi, k_len, k_dir, k_acc = jax.random.split(k_hyper, 5)
        hyper = rmhmc.RMHMCNoise(**tensors(
            eps=jax.random.normal(k_mom, (C, 2), jnp.float32), chi_normal=jax.random.normal(k_chi, (C,), jnp.float32),
            u_len=jax.random.uniform(k_len, (C,)), u_dir=jax.random.uniform(k_dir, (C,)),
            u_acc=jax.random.uniform(k_acc, (C,), jnp.float32)))
        k_mom, k_len, k_dir, k_acc = jax.random.split(k_latent, 4)
        latent = tensors(z=jax.random.normal(k_mom, (C, D), jnp.float32), u_len=jax.random.uniform(k_len, (C,)),
                         u_dir=jax.random.uniform(k_dir, (C,)),  # bernoulli(k, 0.5) is uniform(k) < 0.5
                         u_acc=jax.random.uniform(k_acc, (C,), jnp.float32))
    else:
        k_prop, k_acc = jax.random.split(k_hyper)
        hyper = mmala.MMALANoise(**tensors(eps=jax.random.normal(k_prop, (C, 2), jnp.float32),
                                           u_acc=jax.random.uniform(k_acc, (C,))))
        k_prop, k_acc = jax.random.split(k_latent)
        latent = tensors(z=jax.random.normal(k_prop, (C, D), jnp.float32), u_len=jnp.zeros(C), u_dir=jnp.zeros(C),
                         u_acc=jax.random.uniform(k_acc, (C,), jnp.float32))
    return tjoint.LGCJointNoise(hyper=hyper, **latent)


def margin(accept_prob: torch.Tensor, u: torch.Tensor) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.abs(np.log(accept_prob.numpy()) - np.log(u.numpy()))


@pytest.mark.parametrize("method", list(CONFIGS))
def test_torch_lgc_joint_sweep_matches_jax_step(method):
    y, x, theta = inputs(N, C, seed=8, spread=0.3)
    jm, tm = models(y, N)
    cfg = CONFIGS[method]
    jk = jjoint.build(jm, jjoint.LGCJointConfig(**cfg))
    tcfg = tjoint.LGCJointConfig(**cfg)
    tk = tjoint.build(tm, tcfg)

    jstate = jjoint.LGCJointState(jnp.exp(jnp.asarray(theta)), jnp.asarray(theta), jnp.asarray(x))
    key = jax.random.key(5)
    js, ji = jax.jit(jk.step)(key, jstate)  # one step, no run
    noise = replay(key, method)
    tstate = interop.state_from_numpy(tjoint.LGCJointState, jstate, device="cpu")
    with torch.inference_mode():  # as the runner steps it
        ts, ti = tk.transition(tstate, noise)

        # the two blocks on the port's side, for the margins and the Info algebra
        hk = tjoint.hyper_kernel(tcfg, tm.hyper_manifold(tstate.x))
        h_new, hi = hk.transition(hk.init(tstate.theta), noise.hyper)
        update = tjoint.latent_mmala_update if method == "mmala" else tjoint.latent_update
        lat = update(tm, tcfg, tstate.x, h_new.position, noise)
    torch.testing.assert_close(ti.accept_prob, 0.5 * (lat.accept_prob + hi.accept_prob), rtol=0, atol=0)
    torch.testing.assert_close(ti.accepted, 0.5 * (lat.accepted.float() + hi.accepted.float()), rtol=0, atol=0)
    assert torch.equal(ti.divergent, lat.divergent | hi.divergent)
    torch.testing.assert_close(ts.position, torch.exp(ts.theta), rtol=0, atol=0)

    away = (margin(lat.accept_prob, noise.u_acc) > MARGIN) & (margin(hi.accept_prob, noise.hyper.u_acc) > MARGIN)
    assert away.sum() >= 0.75 * C, away.sum()
    np.testing.assert_allclose(ti.accept_prob.numpy()[away], np.asarray(ji.accept_prob)[away], atol=1e-3)
    np.testing.assert_array_equal(ti.accepted.numpy()[away], np.asarray(ji.accepted)[away])
    np.testing.assert_array_equal(ti.divergent.numpy()[away], np.asarray(ji.divergent)[away])
    np.testing.assert_allclose(ts.position.numpy()[away], np.asarray(js.position)[away], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ts.theta.numpy()[away], np.asarray(js.theta)[away], atol=1e-3)
    np.testing.assert_allclose(ts.x.numpy()[away], np.asarray(js.x)[away], atol=2e-3)
    # both branches compared: some block decisions accepted, some rejected
    decisions = torch.cat([lat.accepted, hi.accepted])
    assert decisions.any() and not decisions.all()


@pytest.mark.parametrize("method", ["rmhmc", "mmala"])
def test_torch_lgc_joint_rejects_a_theta_whose_k_is_not_pd(method):
    """beta = e^12: every entry of K rounds to 1 in float32 and the
    factorization fails.  That chain's sweep is divergent and rejected in
    both blocks, its state stays as it was, nothing raises, and the chain
    beside it moves as it does alone."""
    y, x, theta = inputs(N, 2, seed=8)
    tm = interop.lgc_joint_from_numpy(y, N, device="cpu")
    theta[0] = [0.5, 12.0]
    tth = torch.from_numpy(theta)
    assert not torch.isfinite(tm.hyper_manifold(torch.from_numpy(x)).logp(tth))[0]
    preset = dict(method="mmala", latent_step_size=0.07) if method == "mmala" else {}
    kernel = tjoint.build(tm, tjoint.LGCJointConfig(**preset))
    state = tjoint.LGCJointState(torch.exp(tth), tth, torch.from_numpy(x))
    noise = tjoint.draw_noise(torch.Generator().manual_seed(3), state, method)
    with torch.inference_mode():
        new, info = kernel.transition(state, noise)
        alone, info_alone = kernel.transition(
            tjoint.LGCJointState(*(leaf[1:] for leaf in state)),
            tjoint.LGCJointNoise(type(noise.hyper)(*(t[1:] for t in noise.hyper)), *(t[1:] for t in noise[1:])))
    assert info.divergent.tolist() == [True, False]
    assert info.accepted[0] == 0.0 and info.accept_prob[0] == 0.0
    for leaf, old in zip(new, state):
        assert torch.equal(leaf[0], old[0])
        assert torch.isfinite(leaf[1]).all()
    torch.testing.assert_close(new.theta[1], alone.theta[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(new.x[1], alone.x[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(info.accept_prob[1], info_alone.accept_prob[0], rtol=0, atol=1e-4)
    assert info.accept_prob[1] > 0.0


def test_torch_lgc_joint_build_and_init():
    y, _, _ = inputs(N, 1, seed=8)
    tm = interop.lgc_joint_from_numpy(y, N, device="cpu")
    with pytest.raises(ValueError, match="unknown lgc_joint method"):
        tjoint.build(tm, tjoint.LGCJointConfig(method="hmc"))
    state = tjoint.build(tm).init(torch.tensor([[1.91, 1 / 33.0]] * 3))
    assert state.x.shape == (3, D) and state.x.is_contiguous() and bool((state.x == tm.mu).all())
    torch.testing.assert_close(state.theta, torch.log(state.position))
    field = torch.arange(D, dtype=torch.float64)
    state = tjoint.build(tm, tjoint.LGCJointConfig(latent_init=field)).init(torch.tensor([[1.91, 1 / 33.0]] * 2))
    assert state.x.dtype == torch.float32 and torch.equal(state.x[1], field.float())


# -- the entry points ----------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["rmhmc_joint", "mmala_joint"])
def test_torch_run_workload_lgc_joint(sampler):
    res = experiments.run_workload("lgc", sampler, device="cpu", num_chains=3, num_samples=6, burn_in=3, seed=0,
                                   keep_samples=True, lgc_n=6)
    assert set(res.ess) == set(res.samples) == {"hyper", "latent"}
    assert res.samples["hyper"].shape == (3, 6, 2) and res.samples["latent"].shape == (3, 6, 36)
    assert np.isfinite(res.samples["hyper"]).all() and (res.samples["hyper"] > 0).all()
    assert np.isfinite(res.samples["latent"]).all()
    assert 0.0 < res.accept_rate <= 1.0 and res.divergences == 0
    assert "hyper:" in res.summary() and "latent:" in res.summary()


def test_torch_lgc_joint_presets_and_what_is_left_unported():
    """The presets of the JAX package's ``build_workload`` (``experiments.py:448-460``):
    mMALA's latent step is 0.07, everything else the config's defaults.  No
    workload is left unported: the refusal went with FitzHugh-Nagumo's port."""
    assert not hasattr(experiments, "not_ported")
    assert set(experiments.WORKLOAD_SAMPLERS) == {"blr", "stochvol", "lgc", "fhn"}
    with pytest.raises(KeyError, match="options: stochvol, lgc"):
        experiments.build_workload("volatility", "rmhmc", device="cpu")
    kernel, init_fn, collect_fn, groups_fn, warm = experiments.build_workload("lgc", "mmala_joint", device="cpu", lgc_n=6)
    assert warm is None
    init = init_fn(5)
    torch.testing.assert_close(init, torch.tensor([[1.91, 1 / 33.0]] * 5))
    state = kernel.init(init)
    hyper, latent = collect_fn(state)
    assert groups_fn((hyper, latent)) == {"hyper": hyper, "latent": latent}
    # the jax presets, by their effect: one sweep of the port's preset kernel is the sweep of the explicit config
    y, _ = jlgc.generate_data(seed=0, n=6)
    tm = interop.lgc_joint_from_numpy(y, 6, device="cpu")
    explicit = tjoint.build(tm, tjoint.LGCJointConfig(method="mmala", latent_step_size=0.07))
    a, _ = kernel.step(torch.Generator().manual_seed(1), state)
    b, _ = explicit.step(torch.Generator().manual_seed(1), state)
    assert torch.equal(a.x, b.x) and torch.equal(a.theta, b.theta)


def test_torch_cli_runs_a_joint_sampler_on_the_cpu(capsys):
    experiments.main(["--workload", "lgc", "--sampler", "rmhmc_joint", "--device", "cpu", "--chains", "2",
                      "--samples", "4", "--burn-in", "2", "--lgc-n", "6"])
    out = capsys.readouterr().out
    assert "lgc/rmhmc_joint: 2 chains x 4 samples" in out and "hyper:" in out
    with pytest.raises(SystemExit) as exc:  # no card here: an error, no CPU fallback
        experiments.main(["--workload", "lgc", "--sampler", "rmhmc_joint"])
    assert exc.value.code == 2


# -- the tool ------------------------------------------------------------------------


def tool_kernel(method="rmhmc", chains=3):
    y, _ = jlgc.generate_data(seed=7, n=N)
    tm = interop.lgc_joint_from_numpy(y, N, device="cpu")
    cfg = tjoint.LGCJointConfig(method="mmala", latent_step_size=0.07) if method == "mmala" else tjoint.LGCJointConfig()
    # one chain starts where K is not PD in float32: it diverges every sweep, so the count is not 0
    init = torch.tensor([[1.91, 1 / 33.0]] * (chains - 1) + [[1.0, float(np.exp(12.0))]])
    return tjoint.build(tm, cfg), init


def test_torch_run_segmented_killed_and_resumed_equals_the_uninterrupted_run(tmp_path):
    kernel, init = tool_kernel()
    kw = dict(burn_in=5, num_samples=11, seg=4, seed=3, tag="t")
    full = tool.run_segmented(kernel, init, ckpt_dir=tmp_path / "a", **kw)
    theta, x, accept, n_div, seconds = full
    assert theta.shape == (3, 11, 2) and x.shape == (3, 11, D) and seconds > 0
    # segments [0,4) [4,8) [8,12) [12,16): the second straddles the burn-in's end, 12 sweeps are counted
    assert n_div == 12 and 0.0 < accept < 1.0
    assert tool.run_segmented(kernel, init, ckpt_dir=tmp_path / "b", _stop_after_segments=2, **kw) is None
    with np.load(tmp_path / "b" / "t.state.npz") as saved:  # one file: the state, then the four per-segment records
        assert int(saved["__step__"]) == 2 and saved["leaf_6"].tolist() == [0.0, 4.0, 0.0, 0.0]
    assert sorted(f.name for f in (tmp_path / "b").iterdir()) == ["t.seg1.npz", "t.state.npz"]
    resumed = tool.run_segmented(kernel, init, ckpt_dir=tmp_path / "b", **kw)
    np.testing.assert_array_equal(resumed[0], theta)
    np.testing.assert_array_equal(resumed[1], x)
    assert resumed[2] == accept and resumed[3] == n_div
    # a finished run called again reassembles from disk without stepping
    again = tool.run_segmented(kernel, init, ckpt_dir=tmp_path / "b", **kw)
    np.testing.assert_array_equal(again[1], x)


def test_torch_run_lgc_joint_tool_prints_its_section_and_leaves_results_md_alone(tmp_path, capsys):
    from pathlib import Path

    results = Path(__file__).resolve().parents[1] / "RESULTS.md"
    before = results.read_bytes()
    argv = ["--method", "both", "--chains", "2", "--samples", "6", "--burn-in", "2", "--n", "6", "--seg", "4",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")]
    tool.main(argv)
    out = capsys.readouterr().out
    assert "## LGC joint (sigma^2, beta, x) inference -- 6x6 grid (D=36 latents + 2 hyperparameters), torch" in out
    assert "on the CPU" in out and "TPU" not in out and tool.HEADER in out
    rows = [line for line in out.splitlines() if line.startswith("| rmhmc_joint") or line.startswith("| mmala_joint")]
    assert len(rows) == 2 * 4  # each row printed as it is made and once in the section
    cells = [c.strip() for c in rows[0].split("|")[1:-1]]
    assert len(cells) == len(tool.HEADER.splitlines()[0].split("|")) - 2 == 12
    assert cells[:3] == ["rmhmc_joint", "2", "6"] and cells[5] == "hyper" and cells[10] == "64.8"
    tool.main(argv + ["--out", str(tmp_path / "section.md")])  # resumes at the end: no sweep, the same rows
    assert (tmp_path / "section.md").read_text().count("_joint | 2 | 6 |") == 4
    assert results.read_bytes() == before


def test_torch_run_lgc_joint_tool_calibrates_and_refuses_a_missing_card(capsys):
    tool.main(["--method", "mmala", "--chains", "2", "--n", "6", "--device", "cpu", "--calibrate"])
    out = capsys.readouterr().out
    assert "[calibrate mmala]" in out and "s/sweep (2 chains" in out and "finite=True" in out and "##" not in out
    with pytest.raises(SystemExit) as exc:
        tool.main(["--method", "rmhmc", "--n", "6"])  # --device defaults to cuda
    assert exc.value.code == 2
