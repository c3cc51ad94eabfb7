"""Port: the runner's CUDA-graph path (``parallel.graphs``), on the CPU.

A CUDA graph cannot be captured here, so these tests hold the function the
graph captures -- ``StepGraph.body``: static state in, step, slot write,
sums, static state out -- run eagerly through ``StepGraph.scan``, against
the runner's eager loop (``runner._scan_phase``): for every sampler that
declares itself capturable, at small sizes, samples, final state, accept
rate, divergences and the generator's state after the run are equal, bit for
bit.  Then: the launch counters (each run of the captured function adds its
launches, the warm-up none), the declarations (a step that all-reduces
inside is capturable over NCCL, not Gloo), ``capture=True`` refused on the
CPU, over a Gloo group and for a kernel that cannot be captured, and the
posterior of RMHMC through the static-buffer step against the JAX runner's
(as ``test_torch_slice.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import riemannhamiltonianmontecarlo_tpu as rj
import riemannhamiltonianmontecarlo_tpu_torch as rt
from riemannhamiltonianmontecarlo_tpu_torch import experiments
from riemannhamiltonianmontecarlo_tpu_torch.ops import fhn_sens, hopper_linalg, launches, tridiag
from riemannhamiltonianmontecarlo_tpu_torch.parallel import graphs
from riemannhamiltonianmontecarlo_tpu_torch.parallel.graphs import position_of
from riemannhamiltonianmontecarlo_tpu_torch.parallel.runner import _scan_phase
from riemannhamiltonianmontecarlo_tpu_torch.samplers import hmc, phmc, pmala, rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, tree_map

torch.set_num_threads(1)

CHAINS, STEPS = 4, 3
BLR = ("rmhmc", "rmhmc_studentt", "hmc", "mala", "mmala", "mmala_simplified", "metropolis", "iwls", "gibbs")
LGC = ("rmhmc", "pmala", "mmala", "mala_transient", "mala_stationary")
FHN = experiments.WORKLOAD_SAMPLERS["fhn"]
STOCHVOL = experiments.WORKLOAD_SAMPLERS["stochvol"]
CAPTURABLE = ([f"blr/{s}" for s in BLR] + ["blr/rmhmc-adapt", "blr/mala-transient"]
              + [f"lgc/{s}" for s in LGC] + [f"fhn/{s}" for s in FHN]
              + [f"stochvol/{s}" for s in STOCHVOL] + ["stochvol/mala-transient", "lgc/rmhmc_joint", "lgc/mmala_joint"])
SIZES = {"lgc": dict(lgc_n=4), "fhn": dict(fhn_obs=10, fhn_substeps=2), "stochvol": dict(stochvol_obs=20)}


def blr_model(n=60, d=4):
    ds = rt.models.synthetic_logreg(seed=0, n=n, d=d)
    return rt.interop.logreg_from_numpy(ds.X, ds.t, device="cpu")


def build(name: str):
    """(kernel, (C, D) initial position) of a capturable sampler at a small size."""
    workload, sampler = name.split("/")
    gen = torch.Generator().manual_seed(5)
    if workload == "blr":
        model = blr_model()
        init = rt.utils.default_init(model, gen, CHAINS)
        if sampler == "rmhmc-adapt":
            return rt.parallel.adaptive(rmhmc.build, model, rmhmc.RMHMCConfig(num_leapfrog=3)), init
        kernel, warm = experiments.build_kernel(sampler.split("-")[0], model, "australian")
        return (warm if sampler == "mala-transient" else kernel), init
    if workload == "lgc" and sampler == "pmala":
        y, _ = rt.models.lgc.generate_data(seed=0, n=4)
        model = rt.interop.lgc_from_numpy(y, 4, device="cpu")
        return pmala.build(model, model.metric_chol, model.metric_inv), model.prior_mean().expand(CHAINS, -1).clone()
    kernel, init_fn, _, _, warm = experiments.build_workload(workload, sampler.split("-")[0], device="cpu",
                                                             **SIZES[workload])
    return (warm if sampler.endswith("-transient") else kernel), init_fn(CHAINS)


INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def bits(x: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns (a NaN equals a NaN of the same bits)."""
    return x.contiguous().view(INT_OF[x.dtype]) if x.dtype in INT_OF else x


def assert_trees_equal(a, b):
    flat_a, flat_b = [], []
    tree_map(flat_a.append, a)
    tree_map(flat_b.append, b)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and torch.equal(bits(x), bits(y))


@pytest.mark.parametrize("name", CAPTURABLE)
def test_torch_graph_body_equals_eager_loop(name):
    """Two scans of one entry (static buffers reloaded, sums zeroed) against
    two eager phases from the same generator: equal bit for bit."""
    kernel, init = build(name)
    assert kernel.capturable
    with torch.inference_mode():
        state = kernel.init(init)
        gen_eager, gen_graph = (torch.Generator().manual_seed(9) for _ in range(2))
        entry = graphs.StepGraph(kernel.step, position_of, state)
        eager_state, graph_state = state, state
        for collect in (True, False):
            eager = _scan_phase(kernel.step, gen_eager, eager_state, STEPS, collect)
            graph = entry.scan(gen_graph, graph_state, STEPS, collect)
            (eager_state, eager_out, eager_acc, eager_div) = eager
            (graph_state, graph_out, graph_acc, graph_div) = graph
            assert_trees_equal(graph_state, eager_state)
            assert (graph_out is None) == (not collect)
            if collect:
                assert_trees_equal(graph_out, eager_out)
            assert torch.equal(bits(graph_acc), bits(eager_acc)) and torch.equal(graph_div, eager_div)
            assert torch.equal(gen_graph.get_state(), gen_eager.get_state())
        # what scan returned is the caller's: a later scan does not write into it
        kept = tree_map(torch.clone, graph_state)
        entry.scan(gen_graph, state, 1, True)
        assert_trees_equal(graph_state, kept)


def test_torch_graph_monitor_prints_the_eager_windows(capsys):
    """A monitored kernel is capturable where its inner kernel is; through
    ``StepGraph.scan`` (burn-in and sampling scans of one entry, a warm-up
    first) it prints the window lines of the runner's eager run, counted
    across both phases, and gives the same chains; the warm-up prints nothing."""
    inner, init = build("blr/hmc")
    kernel = rt.parallel.monitor(inner, every=2, label="watch")
    assert kernel.capturable and kernel.after_step is not None
    burn, n = 3, 5
    capsys.readouterr()
    eager = rt.parallel.run(kernel, torch.Generator().manual_seed(9), init, num_samples=n, burn_in=burn)
    eager_lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in eager_lines] == [f"[watch] step {s}" for s in (2, 4, 6, 8)]
    with torch.inference_mode():
        state = kernel.init(init)
        entry = graphs.StepGraph(kernel.step, position_of, state)
        entry._warm_up(2)
        assert capsys.readouterr().out == ""
        gen = torch.Generator().manual_seed(9)
        warm_state, _, warm_acc, _ = entry.scan(gen, state, burn, False, kernel.after_step)
        final, out, acc, div = entry.scan(gen, warm_state, n, True, kernel.after_step)
    assert capsys.readouterr().out.splitlines() == eager_lines
    assert_trees_equal(final, eager.final_state)
    assert torch.equal(out.movedim(0, 1), eager.samples)
    assert torch.equal(bits(acc), bits(eager.accept_rate)) and torch.equal(div, eager.divergences)
    assert torch.equal(bits(warm_acc), bits(eager.warmup_accept_rate))


def swap_step(generator, state):
    """A step that passes one leaf through and swaps two others."""
    s = state.position
    return type(state)(s, state.b, state.a), Info(torch.ones(s.shape[0]), torch.ones(s.shape[0], dtype=torch.bool),
                                                 torch.zeros(s.shape[0], dtype=torch.bool))


def test_torch_graph_write_back_handles_aliases():
    from typing import NamedTuple

    class S(NamedTuple):
        position: torch.Tensor
        a: torch.Tensor
        b: torch.Tensor

    state = S(torch.arange(6.0).reshape(3, 2), torch.zeros(3), torch.ones(3))
    entry = graphs.StepGraph(swap_step, position_of, state)
    out, samples, acc, div = entry.scan(torch.Generator(), state, 3, True)
    assert torch.equal(out.a, torch.ones(3)) and torch.equal(out.b, torch.zeros(3))  # three swaps
    assert torch.equal(out.position, state.position) and samples.shape == (3, 3, 2)
    assert float(acc) == 1.0 and int(div) == 0


def test_torch_graph_warm_up_refuses_a_step_that_changes_the_state():
    kernel, init = build("blr/rmhmc")
    with torch.inference_mode():
        state = kernel.init(init)
        entry = graphs.StepGraph(kernel.step, position_of, state._replace(geo=None))
        with pytest.raises(ValueError, match="structure, shapes and dtypes"):
            entry._warm_up(1)


def counting_step(counted: dict[str, int]):
    """A step that counts ``counted`` launches as a wrapper does (here on
    the CPU; on a card the addition is recorded into the graph)."""

    def step(gen, state):
        for name, n in counted.items():
            for _ in range(n):
                launches.count(name, state.position.device)
        return hmc_kernel.step(gen, state)

    return step


hmc_kernel = hmc.build(blr_model(), hmc.HMCConfig(step_size=0.1, num_leapfrog=2))


def test_torch_graph_launch_counts_are_per_replay():
    """Each run of the captured function adds its launches to the device
    counters; the warm-up before a capture adds none; the two wrappers'
    modules read and reset their own kernels' counts."""
    per_step = {"cholesky": 1, "chol_solve_logdet": 24, "chol_inv_logdet": 7, "bidiag_cholesky": 1,
                "pcr_solve": 52, "fhn_sensitivities/2": 7, "gibbs_sweep": 1, "gig_half": 1}
    launches.reset()
    launches.count("cholesky", torch.device("cpu"))  # outside inference mode
    init = rt.utils.default_init(blr_model(), torch.Generator().manual_seed(0), CHAINS)
    with torch.inference_mode():
        state = hmc_kernel.init(init)
        entry = graphs.StepGraph(counting_step(per_step), position_of, state)
        with launches.paused():
            entry._warm_up(2)
        assert launches.counts() == {**dict.fromkeys(launches.NAMES, 0), "cholesky": 1}
        entry.scan(torch.Generator().manual_seed(0), state, 5, False)
    assert hopper_linalg.launch_counts() == {"cholesky": 1 + 5, "chol_solve_logdet": 5 * 24, "chol_inv_logdet": 5 * 7}
    assert tridiag.launch_counts() == {"bidiag_cholesky": 5, "pcr_solve": 5 * 52}
    assert fhn_sens.launch_counts() == {0: 0, 1: 0, 2: 5 * 7}
    assert launches.counts(("gibbs_sweep", "gig_half", "gig_round")) == {"gibbs_sweep": 5, "gig_half": 5,
                                                                        "gig_round": 0}
    launches.reset(("gibbs_sweep", "gig_half"))
    fhn_sens.reset_launch_counts()
    tridiag.reset_launch_counts()
    assert hopper_linalg.launch_counts() == {"cholesky": 6, "chol_solve_logdet": 120, "chol_inv_logdet": 35}
    assert fhn_sens.launch_counts() == {0: 0, 1: 0, 2: 0}
    assert tridiag.launch_counts() == {"bidiag_cholesky": 0, "pcr_solve": 0}
    hopper_linalg.reset_launch_counts()
    assert launches.counts() == dict.fromkeys(launches.NAMES, 0)


def local_mesh(axis: str):
    """A one-rank mesh without process groups (the layer runs no collective on it)."""
    return rt.parallel.Mesh((axis,), {axis: 1}, {axis: 0}, {})


def stand_in_mesh(axis: str, k: int = 1):
    """A mesh whose ``axis`` has a stand-in group (building a kernel on it runs
    no collective; ``dist.get_backend`` is patched to name its backend)."""
    return rt.parallel.Mesh((axis,), {axis: k}, {axis: 0}, {axis: "group"})


def by_backend() -> dict[str, Kernel]:
    """Kernels whose step all-reduces over a (stand-in) group: capturable where it is NCCL's."""
    model = blr_model()
    y, _ = rt.models.lgc.generate_data(seed=0, n=4)
    lgc = rt.interop.lgc_from_numpy(y, 4, device="cpu").with_sharding(stand_in_mesh("latent"), "latent")
    return {
        "adaptive-pooled-over-ranks": rt.parallel.adaptive(hmc.build, model, hmc.HMCConfig(),
                                                           mesh=stand_in_mesh(rt.parallel.CHAIN_AXIS, 2)),
        "sharded-blr": hmc.build(model.with_sharding(stand_in_mesh("data"), "data")),
        "sharded-lgc": phmc.build(lgc, lgc.metric_chol, lgc.metric_inv),
    }


def not_capturable() -> dict[str, Kernel]:
    model = rt.models.FunctionModel(2, lambda w: -0.5 * torch.sum(w * w))
    return {
        "autodiff-model": hmc.build(model),
        "chain_sliced-autodiff-model": rt.parallel.chain_sliced(hmc.build(model), local_mesh(rt.parallel.CHAIN_AXIS)),
    }


def test_torch_graph_declarations(monkeypatch):
    """A chain split keeps its kernel's declaration; a step that all-reduces
    inside is capturable over NCCL and not over Gloo."""
    for backend in ("gloo", "nccl"):
        monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None, b=backend: b)
        kernels = by_backend()
        for name, kernel in kernels.items():
            assert kernel.capturable == (backend == "nccl"), (name, backend)
        for name, kernel in [*not_capturable().items(), *(kernels.items() if backend == "gloo" else ())]:
            assert not kernel.capturable, name
            with pytest.raises(ValueError, match="declares that its step cannot be captured"):
                graphs.wants_capture(kernel, torch.device("cuda"), True)
            assert not graphs.wants_capture(kernel, torch.device("cuda"), None)
    sliced = rt.parallel.chain_sliced(hmc.build(blr_model()), local_mesh(rt.parallel.CHAIN_AXIS))
    assert sliced.capturable and graphs.wants_capture(sliced, torch.device("cuda"), None)
    for name in CAPTURABLE:
        kernel, _ = build(name)
        assert graphs.wants_capture(kernel, torch.device("cuda"), None), name
        assert not graphs.wants_capture(kernel, torch.device("cpu"), None), name
        assert not graphs.wants_capture(kernel, torch.device("cuda"), False), name


def test_torch_graph_capture_true_is_refused_on_the_cpu(monkeypatch):
    model = blr_model()
    kernel = hmc.build(model, hmc.HMCConfig(step_size=0.1, num_leapfrog=3))
    init = rt.utils.default_init(model, torch.Generator().manual_seed(0), CHAINS)
    with pytest.raises(ValueError, match="needs the chains on a CUDA device"):
        rt.parallel.run(kernel, torch.Generator().manual_seed(1), init, num_samples=2, capture=True)
    with pytest.raises(ValueError, match="a CUDA graph needs a CUDA device"):
        with torch.inference_mode():
            graphs.step_graph(kernel.step, position_of, kernel.init(init))
    # A run with a mesh: refused where a step's group is Gloo's, naming it; a
    # chain split is refused here only for want of a card.
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "gloo")
    with pytest.raises(ValueError, match="'data': 'gloo'.*over NCCL only"):
        rt.parallel.run(hmc.build(model.with_sharding(stand_in_mesh("data"), "data")), torch.Generator().manual_seed(1),
                        init, num_samples=2, capture=True, mesh=stand_in_mesh("data"))
    with pytest.raises(ValueError, match="needs the chains on a CUDA device"):
        rt.parallel.run(kernel, torch.Generator().manual_seed(1), init, num_samples=2, capture=True,
                        mesh=local_mesh(rt.parallel.CHAIN_AXIS))
    for kernel in [*not_capturable().values(), *by_backend().values()]:  # refused before the kernel's init runs
        with pytest.raises(ValueError, match="needs the chains on a CUDA device"):
            rt.parallel.run(kernel, torch.Generator().manual_seed(1), init, num_samples=1, capture=True)
    # the default and capture=False run the eager loop here, the same chains
    a = rt.parallel.run(kernel := hmc.build(model, hmc.HMCConfig(step_size=0.1, num_leapfrog=3)),
                        torch.Generator().manual_seed(1), init, num_samples=3)
    b = rt.parallel.run(kernel, torch.Generator().manual_seed(1), init, num_samples=3, capture=False)
    assert torch.equal(a.samples, b.samples)
    assert graphs.capture_count() == 0


def test_torch_graph_posterior_matches_jax_run():
    """RMHMC through the static-buffer step (burn-in and sampling scans of
    one entry), 64 chains, 50 + 200, against the JAX runner's posterior
    within Monte-Carlo error (the gates of test_torch_slice.py)."""
    ds = rt.models.synthetic_logreg(seed=0, n=250, d=7)
    x, t = ds.X.astype(np.float32), ds.t.astype(np.float32)
    jm = rj.models.LogisticRegression(jnp.asarray(x), jnp.asarray(t))
    tm = rt.interop.logreg_from_numpy(x, t, device="cpu")
    c, burn, n = 64, 50, 200
    jres = rj.parallel.run(
        rj.samplers.rmhmc.build(jm), jax.random.key(1), rj.utils.default_init(jm, jax.random.key(0), c),
        num_samples=n, burn_in=burn,
    )
    gen = torch.Generator().manual_seed(0)
    kernel = rmhmc.build(tm)
    with torch.inference_mode():
        state = kernel.init(rt.utils.default_init(tm, gen, c))
        entry = graphs.StepGraph(kernel.step, position_of, state)
        state, _, _, _ = entry.scan(gen, state, burn, False)
        _, out, acc, div = entry.scan(gen, state, n, True)
    runs = []
    for samples, a, d in ((np.asarray(jres.samples), jres.accept_rate, jres.divergences),
                          (out.movedim(0, 1).numpy(), acc, div)):
        flat = samples.reshape(-1, samples.shape[-1])
        ess = rt.diagnostics.ess_multichain(samples, nfft_mode="exact")
        runs.append((flat.mean(0), flat.var(0), ess, float(a), int(d)))
        assert rt.diagnostics.split_rhat(samples).max() < 1.1
    (mj, vj, ej, aj, dj), (mt, vt, et, at, dt) = runs
    assert (np.abs(mt - mj) / np.sqrt(vj / ej + vt / et)).max() < 5.0
    assert (np.abs(vt - vj) / np.sqrt(2 * vj**2 / ej + 2 * vt**2 / et)).max() < 5.0
    assert abs(at - aj) < 0.03 and 0.8 < at < 0.99
    assert dj <= 0.005 * c * n and dt <= 0.005 * c * n
