"""Port: the parallel layer on ``torch.distributed`` (Gloo, CPU ranks).

Each multi-rank case starts two plain ``python`` ranks through
``parallel.launch.spawn`` (its own timeout, 120 s); the ranks run one of the
``rank_*`` functions below, which import only the port (this module imports
jax only inside the parent's functions), and write their results as .npz.
The parent holds them against the JAX package and the single-process port:

* BLR data axis, k = 2, ``synthetic_logreg(0, 101, 6)`` (N odd: one padded
  row): ``manifold_state`` against the JAX package's with its own sharding
  tolerances (``tests/test_sharding.py:116-122``: logp 2e-5, grad and G
  2e-4), every other model method against the whole port model, one RMHMC
  transition on replayed JAX draws within ``test_torch_rmhmc.py``'s
  tolerances, and a data-split run whose two ranks hold the same bits;
* LGC latent axis, k = 2, n = 8 (D = 64): six phmc steps sharded against
  unsharded within 1e-3 (``tests/test_sharding.py:85-89``), one phmc, one
  pmala and one position-dependent mMALA transition (its metric built from
  the gathered Sigma^{-1}) on replayed JAX draws, the JAX steps on the
  unsharded model (``test_torch_lgc.py``'s checks);
* chain axis, k = 2: HMC, RMHMC, AMH (coordinate-major noise), Gibbs (its
  GIG's Philox counters indexed by the global element), StochVol RMHMC and
  joint LGC mMALA (noise drawn from the state), 20 steps: each rank's samples
  bit for bit one process running its half of the chains, no sampler agreeing
  a flag over the ranks (no MIN all-reduce), the ranks' samples together
  against the single-process run within
  1e-5 with the same accept decisions, global acceptance and R-hat equal on
  both ranks, the ``.p0`` / ``.p1`` checkpoint shards (of an RMHMC and a
  two-block StochVol state) round-tripping, a stopped run resumed bit for
  bit, and ``run_experiment(mesh=)`` (plain and adaptive) against the
  single-process experiment;
* ``dryrun_multichip(4)`` (the 2-axis LGC path) and ``entry(device="cpu")``.

In one process: every sampler's chain-sliced step against rows of the whole
step, a noise leaf without a chain axis refused with the sampler's name, the
monitor's windows against the runner's acceptance, and the profiler trace.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from riemannhamiltonianmontecarlo_tpu_torch import entry, experiments, interop, parallel
from riemannhamiltonianmontecarlo_tpu_torch.diagnostics import split_rhat_device
from riemannhamiltonianmontecarlo_tpu_torch.models import lgc, synthetic_logreg
from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives
from riemannhamiltonianmontecarlo_tpu_torch.parallel.launch import spawn
from riemannhamiltonianmontecarlo_tpu_torch.parallel.mesh import Mesh
from riemannhamiltonianmontecarlo_tpu_torch.samplers import Kernel, gibbs, hmc, metropolis, mmala, phmc, pmala, rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.utils import checkpoint, default_init

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
LAUNCH_TIMEOUT = 120.0
MARGIN = 1e-2  # |log a - log u| below this: an accept decision too close to call (test_torch_rmhmc.py)

BLR_N, BLR_D, BLR_C = 101, 6, 32
LGC_N, LGC_C = 8, 24
LGC_D = LGC_N * LGC_N
CHAIN_C, CHAIN_STEPS = 16, 20


def launch(worker: str, out: Path, env=None) -> None:
    spawn(f"{Path(__file__).stem}:{worker}", 2, device="cpu", args=[str(out)], timeout=LAUNCH_TIMEOUT,
          pythonpath=[str(TESTS)], env=env)


def load(out: Path, name: str) -> list[dict]:
    return [dict(np.load(out / f"{name}.r{r}.npz")) for r in range(2)]


def save(out: str, name: str, **arrays) -> None:
    np.savez(Path(out) / f"{name}.r{dist.get_rank()}.npz",
             **{k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in arrays.items()})


def blr_data():
    ds = synthetic_logreg(seed=0, n=BLR_N, d=BLR_D)
    return ds.X.astype(np.float32), ds.t.astype(np.float32)


def blr_operands():
    rng = np.random.default_rng(7)
    w = (0.2 * rng.normal(size=(BLR_C, BLR_D))).astype(np.float32)
    u = rng.normal(size=(BLR_C, BLR_D)).astype(np.float32)
    v = rng.normal(size=(BLR_C, BLR_D)).astype(np.float32)
    a = rng.normal(size=(BLR_C, BLR_D, BLR_D))
    m = (a @ a.transpose(0, 2, 1) / BLR_D + np.eye(BLR_D)).astype(np.float32)
    return {k: torch.from_numpy(x) for k, x in dict(w=w, u=u, v=v, m=m).items()}


def model_outputs(model) -> dict:
    """Every LogisticRegression method that sums over the data, at ``blr_operands``."""
    o = blr_operands()
    w = o["w"]
    ms = model.manifold_state(w)
    lg_logp, lg_grad = model.logp_and_grad(w)
    mean, cov = model.iwls_proposal(w)
    return dict(logp=ms.logp, grad=ms.grad, metric=ms.metric, logp_only=model.logp(w), grad_only=model.grad(w),
                lg_logp=lg_logp, lg_grad=lg_grad, metric_only=model.metric(w),
                dg_bilinear=model.dg_bilinear(w, o["u"], o["v"]), dg_trace=model.dg_trace(w, o["m"]),
                dg_dotted=model.dg_dotted(w, o["m"]), iwls_mean=mean, iwls_cov=cov)


# -- the ranks -----------------------------------------------------------------


def rank_blr_data(out: str) -> None:
    inp = np.load(Path(out) / "blr_inputs.npz")
    model = interop.logreg_from_numpy(*blr_data(), device="cpu")
    mesh = parallel.make_mesh(2, ("data",))
    sharded = model.with_sharding(mesh)
    kernel = rmhmc.build(sharded, rmhmc.RMHMCConfig())
    noise = rmhmc.RMHMCNoise(**{k: torch.from_numpy(inp[k]) for k in rmhmc.RMHMCNoise._fields})
    mesh2 = parallel.make_mesh(2, (parallel.CHAIN_AXIS, "data"), (1, 2))
    run_kernel = rmhmc.build(model.with_sharding(mesh2), rmhmc.RMHMCConfig(num_leapfrog=2))
    with torch.inference_mode():
        outputs = model_outputs(sharded)
        state, info = kernel.transition(kernel.init(torch.from_numpy(inp["pos"])), noise)
        res = parallel.run(run_kernel, torch.Generator().manual_seed(3), torch.from_numpy(inp["pos"]),
                           num_samples=5, mesh=mesh2)
    save(out, "blr", rows=sharded.X.shape[0], mask_sum=sharded.mask.sum(), **outputs,
         t_position=state.position, t_logp=state.logp, t_accept_prob=info.accept_prob, t_accepted=info.accepted,
         t_divergent=info.divergent, run_samples=res.samples, run_accept=res.accept_rate)


def rank_lgc_latent(out: str) -> None:
    inp = np.load(Path(out) / "lgc_inputs.npz")
    model = interop.lgc_from_numpy(inp["y"], LGC_N, inp["sigma_inv"], inp["metric_chol"], inp["metric_inv"], device="cpu")
    mesh = parallel.make_mesh(2, (parallel.CHAIN_AXIS, "latent"), (1, 2))
    sharded = model.with_sharding(mesh)
    run_kernel = phmc.build(sharded, sharded.metric_chol, sharded.metric_inv, phmc.PHMCConfig(**LGC_RUN))
    phmc_kernel = phmc.build(sharded, sharded.metric_chol, sharded.metric_inv, phmc.PHMCConfig(**LGC_PHMC))
    pmala_kernel = pmala.build(sharded, sharded.metric_chol, sharded.metric_inv, pmala.PMALAConfig(step_size=0.5))
    mmala_kernel = mmala.build(sharded, mmala.MMALAConfig(**LGC_MMALA))
    pos = torch.from_numpy(inp["pos"])
    with torch.inference_mode():
        res = parallel.run(run_kernel, torch.Generator().manual_seed(0), lgc_init(model), num_samples=6, mesh=mesh)
        ps, pi = phmc_kernel.transition(phmc_kernel.init(pos), phmc.PHMCNoise(
            *(torch.from_numpy(inp[f"phmc_{k}"]) for k in phmc.PHMCNoise._fields)))
        ms, mi = pmala_kernel.transition(pmala_kernel.init(pos), pmala.PMALANoise(
            *(torch.from_numpy(inp[f"pmala_{k}"]) for k in pmala.PMALANoise._fields)))
        gs, gi = mmala_kernel.transition(mmala_kernel.init(pos), mmala.MMALANoise(
            *(torch.from_numpy(inp[f"mmala_{k}"]) for k in mmala.MMALANoise._fields)))
    save(out, "lgc", rows=[tuple(getattr(sharded, n).rows.shape) for n in lgc.LGCModel.OPERATORS],
         run_samples=res.samples, run_accept=res.accept_rate,
         **{f"phmc_{k}": v for k, v in {**ps._asdict(), **pi._asdict()}.items()},
         **{f"pmala_{k}": v for k, v in {**ms._asdict(), **mi._asdict()}.items()},
         **{f"mmala_{k}": v for k, v in {**gs._asdict(), **gi._asdict()}.items()})


def rank_chain_axis(out: str) -> None:
    parallel.initialize_distributed(device="cpu")  # already joined: a no-op
    mesh = parallel.make_mesh()
    group = mesh.group(parallel.CHAIN_AXIS)
    arrays = {}
    for name, (kernel, init) in chain_runs().items():
        res, flags = recording_min_flags(lambda: parallel.run(
            kernel, torch.Generator().manual_seed(2), init, num_samples=CHAIN_STEPS, burn_in=2, mesh=mesh))
        # One process running this rank's half of the chains (a mesh without process groups).
        half = parallel.run(kernel, torch.Generator().manual_seed(2), init, num_samples=CHAIN_STEPS, burn_in=2,
                            mesh=fake_mesh(dist.get_rank()))
        with torch.inference_mode():
            rhat = split_rhat_device(res.samples, group)
        arrays.update({f"{name}_samples": res.samples, f"{name}_accept": res.accept_rate,
                       f"{name}_warm_accept": res.warmup_accept_rate, f"{name}_div": res.divergences,
                       f"{name}_rhat": rhat, f"{name}_half": half.samples, f"{name}_flags": len(flags)})
    # Checkpoint shards: a run stopped after one segment and resumed, against one not stopped.
    kernel, ck = chain_kernels()["hmc"], Path(out) / "ckpt"
    kw = dict(num_samples=12, burn_in=2, checkpoint_every=4, mesh=mesh)
    full = parallel.run_checkpointed(kernel, 5, chain_init(), checkpoint_path=ck / "full.npz", **kw)
    parallel.run_checkpointed(kernel, 5, chain_init(), checkpoint_path=ck / "cut.npz", _stop_after_segments=1, **kw)
    resumed = parallel.run_checkpointed(kernel, 5, chain_init(), checkpoint_path=ck / "cut.npz", **kw)
    with torch.inference_mode():
        template = kernel.init(parallel.shard_chains(mesh, chain_init()))
    restored, step, _ = checkpoint.load_state(ck / "full.npz", template)
    arrays.update(ckpt_samples=full.samples, ckpt_resumed=resumed.samples, ckpt_accept=full.accept_rate,
                  ckpt_resumed_accept=resumed.accept_rate, ckpt_step=step,
                  ckpt_restored_equal=all(torch.equal(a, b) for a, b in zip(restored, full.final_state)))
    # A two-block state's shards: StochVol's (position, theta, x).
    kernel, init = chain_runs()["stochvol"]
    kw = dict(num_samples=4, burn_in=2, checkpoint_every=2, mesh=mesh)
    sv_full = parallel.run_checkpointed(kernel, 5, init, checkpoint_path=ck / "sv.npz", **kw)
    with torch.inference_mode():
        template = kernel.init(parallel.shard_chains(mesh, init))
    restored, step, _ = checkpoint.load_state(ck / "sv.npz", template)
    pairs = zip(checkpoint.tree_leaves(restored), checkpoint.tree_leaves(sv_full.final_state))
    arrays.update(sv_ckpt_step=step, sv_ckpt_restored_equal=all(torch.equal(a, b) for a, b in pairs))
    for adapt in (False, True):
        res = experiments.run_experiment("hmc", "australian", mesh=mesh, adapt=adapt, **EXPERIMENT)
        arrays.update({f"exp{int(adapt)}_{k}": getattr(res, k) for k in EXPERIMENT_FIELDS})
        arrays[f"exp{int(adapt)}_eps"] = res.adapted_step_size or 0.0
    save(out, "chain", **arrays)


# -- shared inputs ----------------------------------------------------------------


LGC_RUN = dict(step_size=0.05, num_leapfrog=3)
LGC_PHMC = dict(step_size=0.5, num_leapfrog=10)
LGC_MMALA = dict(step_size=0.3, jitter=1e-5)  # test_torch_lgc.py's position-dependent mMALA
EXPERIMENT = dict(device="cpu", num_chains=16, num_samples=40, burn_in=10, ess_mode="exact",
                  sampler_overrides={"num_leapfrog": 10, "step_size": 0.1})
EXPERIMENT_FIELDS = ("ess_min", "ess_median", "ess_max", "accept_rate", "divergences", "posterior_mean",
                     "posterior_std", "rhat_max", "geweke_max_abs_z")


def lgc_init(model) -> torch.Tensor:
    return model.prior_mean().expand(8, -1).clone()


def chain_model():
    ds = synthetic_logreg(seed=1, n=60, d=4)
    return interop.logreg_from_numpy(ds.X, ds.t, device="cpu")


def chain_kernels() -> dict:
    model = chain_model()
    return {"hmc": hmc.build(model, hmc.HMCConfig(step_size=0.1, num_leapfrog=10)),
            "rmhmc": rmhmc.build(model, rmhmc.RMHMCConfig())}


def chain_init() -> torch.Tensor:
    return default_init(chain_model(), torch.Generator().manual_seed(1), CHAIN_C)


def chain_runs() -> dict:
    """name -> (kernel, global initial position) of the chain-axis runs."""
    runs = {name: (kernel, chain_init()) for name, kernel in chain_kernels().items()}
    model = chain_model()
    runs["metropolis"] = (metropolis.build(model, metropolis.AMHConfig(init_proposal_sd=0.3)), chain_init())
    runs["gibbs"] = (gibbs.build(model), chain_init())
    for name, workload, sampler, size in (("stochvol", "stochvol", "rmhmc", dict(stochvol_obs=20)),
                                          ("lgc_joint", "lgc", "mmala_joint", dict(lgc_n=4))):
        kernel, init_fn, *_ = experiments.build_workload(workload, sampler, device="cpu", **size)
        runs[name] = (kernel, init_fn(CHAIN_C))
    return runs


def recording_min_flags(fn):
    """``fn()`` with the flags of any MIN all-reduce it made (an exit test
    agreed over the ranks) recorded: (result, flags)."""
    flags, all_reduce = [], collectives.all_reduce

    def logged(x, group, op=dist.ReduceOp.SUM):
        out = all_reduce(x, group, op)
        if op == dist.ReduceOp.MIN:
            flags.append(out.clone())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(collectives, "all_reduce", logged)
        return fn(), flags


# -- BLR data axis -----------------------------------------------------------------


def rmhmc_jax_noise(key, c: int, d: int) -> dict:
    """The JAX RMHMC step's draws, replayed from its key splits (test_torch_rmhmc.py)."""
    import jax
    import jax.numpy as jnp

    k_mom, k_chi, k_len, k_dir, k_acc = jax.random.split(key, 5)
    draws = {"eps": jax.random.normal(k_mom, (c, d), jnp.float32), "chi_normal": jax.random.normal(k_chi, (c,), jnp.float32),
             "u_len": jax.random.uniform(k_len, (c,)), "u_dir": jax.random.uniform(k_dir, (c,)),
             "u_acc": jax.random.uniform(k_acc, (c,), jnp.float32)}
    return {k: np.asarray(v) for k, v in draws.items()}


@pytest.fixture(scope="module")
def blr_ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import riemannhamiltonianmontecarlo_tpu as rj

    out = tmp_path_factory.mktemp("blr")
    x, t = blr_data()
    jm = rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t))
    center = np.asarray(rj.utils.map_estimate(jm))
    pos = (center + 0.1 * np.random.default_rng(0).normal(size=(BLR_C, BLR_D))).astype(np.float32)
    key = jax.random.key(17)
    noise = rmhmc_jax_noise(key, BLR_C, BLR_D)
    np.savez(out / "blr_inputs.npz", pos=pos, **noise)
    jk = rj.samplers.rmhmc.build(jm, rj.samplers.rmhmc.RMHMCConfig())
    js, ji = jax.jit(jk.step)(key, jk.init(jnp.asarray(pos)))
    launch("rank_blr_data", out)
    return {"ranks": load(out, "blr"), "jax_model": jm, "jax_step": (js, ji), "pos": pos, "noise": noise}


def test_torch_blr_data_axis_pads_and_splits_rows(blr_ranks):
    r0, r1 = blr_ranks["ranks"]
    assert int(r0["rows"]) == int(r1["rows"]) == (BLR_N + 1) // 2  # 101 rows padded to 102, 51 a rank
    assert float(r0["mask_sum"]) + float(r1["mask_sum"]) == BLR_N


def test_torch_blr_data_axis_manifold_state_matches_jax(blr_ranks):
    w = blr_operands()["w"].numpy()
    ms = blr_ranks["jax_model"].manifold_state(w)
    for rank in blr_ranks["ranks"]:
        np.testing.assert_allclose(rank["logp"], np.asarray(ms.logp), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(rank["grad"], np.asarray(ms.grad), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(rank["metric"], np.asarray(ms.metric), rtol=2e-4, atol=2e-4)


def test_torch_blr_data_axis_every_method_matches_the_whole_model(blr_ranks):
    """Each sum over n is all-reduced before the prior term: the prior counts once."""
    whole = model_outputs(interop.logreg_from_numpy(*blr_data(), device="cpu"))
    for rank in blr_ranks["ranks"]:
        for name, ref in whole.items():
            ref = ref.numpy()
            np.testing.assert_allclose(rank[name], ref, rtol=2e-4, atol=2e-4 * max(1.0, np.abs(ref).max()), err_msg=name)


def test_torch_blr_data_axis_rmhmc_transition_matches_jax(blr_ranks):
    js, ji = blr_ranks["jax_step"]
    ap = np.asarray(ji.accept_prob)
    with np.errstate(divide="ignore"):
        away = np.abs(np.log(ap) - np.log(blr_ranks["noise"]["u_acc"])) > MARGIN
    assert away.sum() >= 0.75 * BLR_C
    for rank in blr_ranks["ranks"]:
        np.testing.assert_allclose(rank["t_accept_prob"], ap, atol=1e-3)
        np.testing.assert_array_equal(rank["t_accepted"][away], np.asarray(ji.accepted)[away])
        np.testing.assert_array_equal(rank["t_divergent"], np.asarray(ji.divergent))
        np.testing.assert_allclose(rank["t_position"][away], np.asarray(js.position)[away], atol=1e-3)
        np.testing.assert_allclose(rank["t_logp"][away], np.asarray(js.logp)[away], atol=1e-2)


def test_torch_blr_data_split_run_same_bits_on_both_ranks(blr_ranks):
    """The data-split ranks advance the same chains: after all-reduces of the
    same partial sums their positions are bit-identical; against the whole
    model's run within the JAX package's data-split tolerance (5e-3)."""
    r0, r1 = blr_ranks["ranks"]
    np.testing.assert_array_equal(r0["run_samples"], r1["run_samples"])
    assert float(r0["run_accept"]) == float(r1["run_accept"])
    model = interop.logreg_from_numpy(*blr_data(), device="cpu")
    whole = parallel.run(rmhmc.build(model, rmhmc.RMHMCConfig(num_leapfrog=2)), torch.Generator().manual_seed(3),
                         torch.from_numpy(blr_ranks["pos"]), num_samples=5)
    np.testing.assert_allclose(r0["run_samples"], whole.samples.numpy(), rtol=5e-3, atol=5e-3)


# -- LGC latent axis --------------------------------------------------------------


@pytest.fixture(scope="module")
def lgc_ranks(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from riemannhamiltonianmontecarlo_tpu.models import lgc as jlgc
    from riemannhamiltonianmontecarlo_tpu.samplers import mmala as jmmala
    from riemannhamiltonianmontecarlo_tpu.samplers import phmc as jphmc
    from riemannhamiltonianmontecarlo_tpu.samplers import pmala as jpmala

    out = tmp_path_factory.mktemp("lgc")
    y, x_true = jlgc.generate_data(seed=2, n=LGC_N)
    jm = jlgc.LGCModel(jnp.asarray(y, jnp.float32), n=LGC_N)
    pos = (x_true + 0.05 * np.random.default_rng(0).normal(size=(LGC_C, LGC_D))).astype(np.float32)
    k_phmc, k_pmala = jax.random.key(41), jax.random.key(42)
    k_mom, k_len, k_dir, k_acc = jax.random.split(k_phmc, 4)
    phmc_noise = dict(z=jax.random.normal(k_mom, (LGC_C, LGC_D), jnp.float32), u_len=jax.random.uniform(k_len, (LGC_C,)),
                      u_dir=jax.random.uniform(k_dir, (LGC_C,)), u_acc=jax.random.uniform(k_acc, (LGC_C,), jnp.float32))
    k_noise, k_acc2 = jax.random.split(k_pmala)
    pmala_noise = dict(z=jax.random.normal(k_noise, (LGC_C, LGC_D), jnp.float32),
                       u_acc=jax.random.uniform(k_acc2, (LGC_C,), jnp.float32))
    k_mmala = jax.random.key(43)
    k_prop, k_acc3 = jax.random.split(k_mmala)
    mmala_noise = dict(eps=jax.random.normal(k_prop, (LGC_C, LGC_D), jnp.float32),
                       u_acc=jax.random.uniform(k_acc3, (LGC_C,), jnp.float32))
    ops = {name: np.asarray(getattr(jm, name)) for name in lgc.LGCModel.OPERATORS}
    np.savez(out / "lgc_inputs.npz", y=y, pos=pos, **ops, **{f"phmc_{k}": np.asarray(v) for k, v in phmc_noise.items()},
             **{f"pmala_{k}": np.asarray(v) for k, v in pmala_noise.items()},
             **{f"mmala_{k}": np.asarray(v) for k, v in mmala_noise.items()})
    jk = jphmc.build(jm, jm.metric_chol, jm.metric_inv, jphmc.PHMCConfig(**LGC_PHMC))
    jp = jpmala.build(jm, jm.metric_chol, jm.metric_inv, jpmala.PMALAConfig(step_size=0.5))
    jg = jmmala.build(jm, jmmala.MMALAConfig(**LGC_MMALA))  # the unsharded model
    steps = {"phmc": jax.jit(jk.step)(k_phmc, jk.init(jnp.asarray(pos))),
             "pmala": jax.jit(jp.step)(k_pmala, jp.init(jnp.asarray(pos))),
             "mmala": jax.jit(jg.step)(k_mmala, jg.init(jnp.asarray(pos)))}
    launch("rank_lgc_latent", out)
    model = interop.lgc_from_numpy(y, LGC_N, *ops.values(), device="cpu")
    return {"ranks": load(out, "lgc"), "model": model, "jax_steps": steps,
            "u_acc": {name: np.asarray(noise["u_acc"]) for name, noise in
                      (("phmc", phmc_noise), ("pmala", pmala_noise), ("mmala", mmala_noise))}}


def test_torch_lgc_latent_axis_six_phmc_steps_match_unsharded(lgc_ranks):
    for rank in lgc_ranks["ranks"]:
        assert [tuple(r) for r in rank["rows"]] == [(LGC_D // 2, LGC_D)] * 3
    model = lgc_ranks["model"]
    kernel = phmc.build(model, model.metric_chol, model.metric_inv, phmc.PHMCConfig(**LGC_RUN))
    whole = parallel.run(kernel, torch.Generator().manual_seed(0), lgc_init(model), num_samples=6)
    for rank in lgc_ranks["ranks"]:
        np.testing.assert_allclose(rank["run_samples"], whole.samples.numpy(), rtol=1e-3, atol=1e-3)
        assert float(rank["run_accept"]) == pytest.approx(float(whole.accept_rate), abs=1e-3)


@pytest.mark.parametrize("sampler", ["phmc", "pmala", "mmala"])
def test_torch_lgc_latent_axis_transition_matches_jax(lgc_ranks, sampler):
    js, ji = lgc_ranks["jax_steps"][sampler]
    ap = np.asarray(ji.accept_prob)
    with np.errstate(divide="ignore"):
        away = np.abs(np.log(ap) - np.log(lgc_ranks["u_acc"][sampler])) > MARGIN
    assert away.sum() >= 0.75 * LGC_C
    for rank in lgc_ranks["ranks"]:
        np.testing.assert_allclose(rank[f"{sampler}_accept_prob"], ap, atol=1e-3)
        np.testing.assert_array_equal(rank[f"{sampler}_accepted"][away], np.asarray(ji.accepted)[away])
        np.testing.assert_array_equal(rank[f"{sampler}_divergent"], np.asarray(ji.divergent))
        for name in js._fields:
            port, ref = rank[f"{sampler}_{name}"][away], np.asarray(getattr(js, name))[away]
            atol = 1e-3 if name == "position" else 1e-4 * np.abs(ref).max()
            np.testing.assert_allclose(port, ref, rtol=0, atol=atol, err_msg=name)
        assert rank[f"{sampler}_accepted"].any() and not rank[f"{sampler}_accepted"].all()


# -- chain axis -------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain_ranks(tmp_path_factory):
    data = tmp_path_factory.mktemp("chain_data")
    ds = synthetic_logreg(seed=0, n=200, d=15)
    np.savetxt(data / "australian.csv", np.column_stack([ds.X[:, 1:], ds.t]), delimiter=",")
    out = tmp_path_factory.mktemp("chain")
    launch("rank_chain_axis", out, env={"RHMC_DATA_DIR": str(data)})
    from riemannhamiltonianmontecarlo_tpu_torch.models import datasets

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(datasets, "_SEARCH_PATHS", (str(data),))
        single = {adapt: experiments.run_experiment("hmc", "australian", adapt=adapt, **EXPERIMENT)
                  for adapt in (False, True)}
    return {"ranks": load(out, "chain"), "out": out, "experiments": single}


def moved(samples: np.ndarray) -> np.ndarray:
    """(C, S) accept decisions read off the samples: the chain moved at step s."""
    return (samples[:, 1:] != samples[:, :-1]).any(axis=-1)


@pytest.mark.parametrize("name", ["hmc", "rmhmc", "metropolis", "gibbs", "stochvol", "lgc_joint"])
def test_torch_chain_axis_matches_single_process(chain_ranks, name):
    r0, r1 = chain_ranks["ranks"]
    kernel, init = chain_runs()[name]
    whole = parallel.run(kernel, torch.Generator().manual_seed(2), init, num_samples=CHAIN_STEPS, burn_in=2)
    ref = whole.samples.numpy()
    got = np.concatenate([r0[f"{name}_samples"], r1[f"{name}_samples"]])
    assert r0[f"{name}_samples"].shape == (CHAIN_C // 2, CHAIN_STEPS, init.shape[1])
    for rank in (r0, r1):  # bit for bit one process running the rank's half
        np.testing.assert_array_equal(rank[f"{name}_samples"], rank[f"{name}_half"])
    assert int(r0[f"{name}_flags"]) == 0  # no sampler agrees a flag over the ranks: Gibbs's GIG exits per element
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(moved(got), moved(ref))
    for key in ("accept", "warm_accept", "div", "rhat"):
        np.testing.assert_array_equal(r0[f"{name}_{key}"], r1[f"{name}_{key}"], err_msg=key)  # global on both ranks
    assert float(r0[f"{name}_accept"]) == pytest.approx(float(whole.accept_rate), abs=1e-6)
    assert int(r0[f"{name}_div"]) == int(whole.divergences)
    np.testing.assert_allclose(r0[f"{name}_rhat"], split_rhat_device(whole.samples).numpy(), rtol=1e-5)


def test_torch_chain_axis_checkpoint_shards_round_trip(chain_ranks):
    out = chain_ranks["out"] / "ckpt"
    for base, last in (("full.npz", 2), ("cut.npz", 2), ("sv.npz", 1)):
        assert (out / f"{base}.p0").exists() and (out / f"{base}.p1").exists() and not (out / base).exists()
        assert (out / f"{base}.seg0.p0").exists() and (out / f"{base}.seg{last}.p1").exists()
    for rank in chain_ranks["ranks"]:
        assert bool(rank["ckpt_restored_equal"]) and int(rank["ckpt_step"]) == 3
        assert bool(rank["sv_ckpt_restored_equal"]) and int(rank["sv_ckpt_step"]) == 2
        assert rank["ckpt_samples"].shape == (CHAIN_C // 2, 12, 4)
        np.testing.assert_array_equal(rank["ckpt_resumed"], rank["ckpt_samples"])
    r0, r1 = chain_ranks["ranks"]
    assert not np.array_equal(r0["ckpt_samples"], r1["ckpt_samples"])  # each rank its own chains


@pytest.mark.parametrize("adapt", [False, True], ids=["preset", "adaptive"])
def test_torch_run_experiment_over_the_chain_axis_matches_single_process(chain_ranks, adapt):
    """Preset constants: the same chains, figures within float rounding.
    Adaptive: the pooled acceptance is a mean of the ranks' means, rounded
    another way in float32, and dual averaging multiplies its error by
    sqrt(t) / gamma (~60 at the 10th step): the step sizes agree to ~1e-5,
    the chains after them to 1e-3."""
    single = chain_ranks["experiments"][adapt]
    rel = 1e-3 if adapt else 1e-4
    for rank in chain_ranks["ranks"]:
        got = {k: rank[f"exp{int(adapt)}_{k}"] for k in EXPERIMENT_FIELDS}
        assert float(got["accept_rate"]) == pytest.approx(single.accept_rate, abs=1e-4 if adapt else 1e-6)
        assert int(got["divergences"]) == single.divergences
        for k in ("ess_min", "ess_median", "ess_max"):  # per-chain ESS summed over the ranks
            assert float(got[k]) == pytest.approx(getattr(single, k), rel=rel), k
        np.testing.assert_allclose(got["posterior_mean"], single.posterior_mean, rtol=rel, atol=1e-5)
        np.testing.assert_allclose(got["posterior_std"], single.posterior_std, rtol=rel, atol=1e-5)
        np.testing.assert_allclose(got["rhat_max"], single.rhat_max, rtol=rel)
        assert np.isfinite(single.geweke_max_abs_z)  # 40 samples: no chain of the 8 stuck through a Geweke segment
        np.testing.assert_allclose(got["geweke_max_abs_z"], single.geweke_max_abs_z, rtol=rel)
        if adapt:
            assert float(rank["exp1_eps"]) == pytest.approx(single.adapted_step_size, rel=1e-4)


# -- the dry run and the single-device entry ---------------------------------------


def test_torch_dryrun_multichip_four_ranks():
    report = entry.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK: 4 ranks, 16 chains" in report
    assert "mesh {'chains': 2, 'latent': 2}, LGC D=256, operator rows a rank (128, 256)" in report


def test_torch_entry_one_transition_on_cpu():
    fn, args = entry.entry(device="cpu")
    position, accept = fn(*args)
    assert position.shape == (64, 6) and bool(torch.isfinite(position).all())
    assert accept.shape == (64,) and bool(((accept >= 0) & (accept <= 1)).all())


# -- in one process -----------------------------------------------------------------


def fake_mesh(index: int, k: int = 2) -> Mesh:
    """Rank ``index`` of a k-rank chain axis, without a process group (the
    chain-sliced step needs only the axis's size and the rank's index)."""
    return Mesh((parallel.CHAIN_AXIS,), {parallel.CHAIN_AXIS: k}, {parallel.CHAIN_AXIS: index}, {})


@functools.cache
def sliced_kernels() -> dict:
    ds = synthetic_logreg(seed=3, n=40, d=4)
    model = interop.logreg_from_numpy(ds.X, ds.t, device="cpu")
    kernels = {f"blr/{n}": experiments.build_kernel(n, model, "australian")[0] for n in experiments.SAMPLERS}
    for sampler in ("rmhmc", "mmala"):
        kernels[f"lgc/{sampler}"] = experiments.build_workload("lgc", sampler, device="cpu", lgc_n=4)[0]
    lgc_model = interop.lgc_from_numpy(lgc.generate_data(seed=0, n=4)[0], 4, device="cpu")
    kernels["lgc/pmala"] = pmala.build(lgc_model, lgc_model.metric_chol, lgc_model.metric_inv)
    for sampler in experiments.WORKLOAD_SAMPLERS["fhn"]:
        kernels[f"fhn/{sampler}"] = experiments.build_workload("fhn", sampler, device="cpu", fhn_obs=10, fhn_substeps=2)[0]
    for sampler in ("rmhmc", "mmala"):
        kernels[f"stochvol/{sampler}"] = experiments.build_workload("stochvol", sampler, device="cpu",
                                                                    stochvol_obs=20)[0]
    for sampler in ("rmhmc_joint", "mmala_joint"):
        kernels[f"lgc/{sampler}"] = experiments.build_workload("lgc", sampler, device="cpu", lgc_n=4)[0]
    return kernels


SLICED = ([f"blr/{n}" for n in experiments.SAMPLERS] + ["lgc/rmhmc", "lgc/mmala", "lgc/pmala"]
          + ["lgc/rmhmc_joint", "lgc/mmala_joint"]
          + [f"fhn/{n}" for n in experiments.WORKLOAD_SAMPLERS["fhn"]] + ["stochvol/rmhmc", "stochvol/mmala"])


@pytest.mark.parametrize("name", SLICED)
def test_torch_chain_sliced_step_is_rows_of_the_whole_step(name):
    """Rank i of a 2-rank chain axis: its sliced step on rows 3i:3i+3 gives
    those rows of the step of all 6 chains, from the same generator: AMH's
    and the Gibbs sweep's coordinate-major noise sliced along its chain axis,
    Gibbs's GIG counters indexed by the global element, the two-block
    samplers' noise drawn from a view of the state."""
    kernel = sliced_kernels()[name]
    dim = 2 if name.endswith("_joint") else {"blr": 4, "lgc": 16, "fhn": 3, "stochvol": 3}[name.split("/")[0]]
    gen = torch.Generator().manual_seed(0)
    center = 0.5 if name.startswith("stochvol") else 1.0  # (beta, sigma, phi) inside the support
    position = center + 0.05 * torch.randn((6, dim), generator=gen)
    with torch.inference_mode():
        whole, info = kernel.step(torch.Generator().manual_seed(1), kernel.init(position))
        for i in range(2):
            rows = slice(3 * i, 3 * i + 3)
            part, part_info = parallel.chain_sliced(kernel, fake_mesh(i)).step(
                torch.Generator().manual_seed(1), kernel.init(position[rows]))
            torch.testing.assert_close(part.position, whole.position[rows], rtol=1e-5, atol=1e-5)
            assert torch.equal(part_info.accepted, info.accepted[rows])


@pytest.mark.parametrize("leaf", ["shared draw", "generator"])
def test_torch_chain_sliced_refuses_a_noise_leaf_without_a_chain_axis(leaf):
    """A noise leaf whose shape does not follow the chain count (a draw shared
    by every chain), or that is neither a tensor nor splits itself, cannot be
    split over chains: the step raises, naming the sampler."""
    inner = sliced_kernels()["blr/hmc"]
    extra = {"shared draw": lambda g: torch.rand((5,), generator=g), "generator": lambda g: g}[leaf]

    @functools.wraps(inner.draw_noise)  # the sampler's name: hmc
    def draw_noise(g, position):
        return inner.draw_noise(g, position), extra(g)

    kernel = Kernel(inner.init, inner.step, lambda state, noise: inner.transition(state, noise[0]), draw_noise)
    reason = {"shared draw": "has no chain axis", "generator": "not a tensor"}[leaf]
    with pytest.raises(ValueError, match=f"^hmc: .*{reason}"):
        parallel.chain_sliced(kernel, fake_mesh(0)).step(torch.Generator().manual_seed(1),
                                                         inner.init(torch.zeros((3, 4))))


def test_torch_monitor_windows_equal_the_runner_acceptance(capsys):
    model = chain_model()
    kernel = hmc.build(model, hmc.HMCConfig(step_size=0.1, num_leapfrog=5))
    init = chain_init()
    watched = parallel.run(parallel.monitor(kernel, every=5, label="blr"), torch.Generator().manual_seed(4), init,
                           num_samples=10)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[blr]")]
    assert [line.split(":")[0] for line in lines] == ["[blr] step 5", "[blr] step 10"]
    gen = torch.Generator().manual_seed(4)
    first = parallel.run(kernel, gen, init, num_samples=5)
    second = parallel.run(kernel, gen, None, num_samples=5, init_state=first.final_state)
    for line, window in zip(lines, (first, second)):
        accept = float(line.split("window accept ")[1].split(",")[0])
        assert accept == pytest.approx(float(window.accept_rate), abs=5e-4 + 1e-7)
        assert line.endswith(f"divergences {int(window.divergences)}")
    assert torch.equal(watched.samples, torch.cat([first.samples, second.samples], dim=1))


def test_torch_profile_trace_writes_a_chrome_trace(tmp_path):
    kernel = hmc.build(chain_model(), hmc.HMCConfig(step_size=0.1, num_leapfrog=3))
    with parallel.profile_trace(tmp_path / "trace"):
        parallel.run(kernel, torch.Generator().manual_seed(0), chain_init(), num_samples=2)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_torch_mesh_needs_a_process_group_and_even_chains():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        parallel.make_mesh()
    with pytest.raises(ValueError, match="split evenly"):
        parallel.chain_slice(fake_mesh(0, k=3), 16)
    assert parallel.chain_slice(fake_mesh(1, k=4), 16) == (4, 8)
