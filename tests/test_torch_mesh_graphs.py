"""Port: runs with a mesh through the step's CUDA-graph path, on the CPU.

A CUDA graph cannot be captured here, so, as ``test_torch_graphs.py`` does,
these tests hold the function a graph captures, ``StepGraph.body`` run
eagerly by ``StepGraph.scan``, against the runner's eager loop, now under a
mesh.  The ranks take the runner's graph route as on a card
(``rehearsed_capture``: ``graphs.wants_capture`` answers as it does on a
card and ``StepGraph.capture`` runs its uncounted warm-up and records
nothing).  Two ranks over Gloo (``parallel.launch.spawn``, 120 s), each
writing an .npz that the parent reads:

* chain split (2, 1), 32 chains, BLR D 6: HMC, RMHMC, Gibbs and StochVol
  RMHMC, burn-in and sampling through one graph entry (one capture for both
  phases and for a second run of the same kernel), each rank ``torch.equal``
  to the eager mesh loop;
* row split (1, 2), BLR RMHMC on the sharded model: over Gloo it declares
  itself not capturable, runs eagerly by default and ``capture=True`` raises
  naming Gloo; its step through ``StepGraph.scan``, and through the runner's
  graph route with the group declared NCCL's, equal the eager loop, with the
  same device-counted all-reduces;
* the all-reduce counter: it counts every ``dist.all_reduce`` issued, and
  none under ``launches.paused`` (the warm-up before a capture);
* RMHMC chain-split over the two ranks through the graph's body, 64 chains,
  50 + 200, ``synthetic_logreg(0, 250, 7)``, against the JAX runner's
  sharded run on two virtual CPU devices, with the gates of
  ``test_torch_graphs.py::test_torch_graph_posterior_matches_jax_run``.

This module imports jax only inside the parent's functions: the ranks import
it too.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from riemannhamiltonianmontecarlo_tpu_torch import experiments, interop, parallel
from riemannhamiltonianmontecarlo_tpu_torch.models import synthetic_logreg
from riemannhamiltonianmontecarlo_tpu_torch.ops import launches
from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives, graphs
from riemannhamiltonianmontecarlo_tpu_torch.parallel.launch import spawn
from riemannhamiltonianmontecarlo_tpu_torch.parallel.mesh import CHAIN_AXIS
from riemannhamiltonianmontecarlo_tpu_torch.samplers import gibbs, hmc, rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.utils import default_init

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
LAUNCH_TIMEOUT = 120.0

CHAINS, BURN, STEPS = 32, 3, 6
SPLIT = ("hmc", "rmhmc", "gibbs", "stochvol")
POSTERIOR = dict(chains=64, burn_in=50, num_samples=200, n=250, d=7)


@contextlib.contextmanager
def rehearsed_capture():
    """The runner's graph route on the CPU: ``wants_capture`` answers as on a
    card, and ``capture`` runs the warm-up (uncounted) and records nothing,
    so the entry's ``scan`` runs ``body`` eagerly."""

    def capture(self):
        with launches.paused():
            self._warm_up(graphs.WARMUP_STEPS)
        graphs._CAPTURES[0] += 1

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "wants_capture", lambda kernel, device, capture: kernel.capturable if capture is None
                   else bool(capture))
        mp.setattr(graphs.StepGraph, "capture", capture)
        yield


@contextlib.contextmanager
def issued_all_reduces(record: list):
    """Each ``dist.all_reduce`` issued inside appended to ``record`` (a host count)."""
    real = dist.all_reduce

    def all_reduce(*args, **kwargs):
        record.append(1)
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "all_reduce", all_reduce)
        yield


def blr_model(n: int = 60, d: int = 6, seed: int = 1):
    ds = synthetic_logreg(seed=seed, n=n, d=d)
    return interop.logreg_from_numpy(ds.X.astype(np.float32), ds.t.astype(np.float32), device="cpu")


def split_runs() -> dict:
    """name -> (kernel, global initial position) of the chain-split cases."""
    model = blr_model()
    init = default_init(model, torch.Generator().manual_seed(1), CHAINS)
    sv_kernel, sv_init, *_ = experiments.build_workload("stochvol", "rmhmc", device="cpu", stochvol_obs=20)
    return {"hmc": (hmc.build(model, hmc.HMCConfig(step_size=0.1, num_leapfrog=5)), init),
            "rmhmc": (rmhmc.build(model, rmhmc.RMHMCConfig(num_leapfrog=3)), init),
            "gibbs": (gibbs.build(model), init),
            "stochvol": (sv_kernel, sv_init(CHAINS))}


def result_arrays(prefix: str, res) -> dict:
    return {f"{prefix}_samples": res.samples, f"{prefix}_final": res.final_state.position,
            f"{prefix}_accept": res.accept_rate, f"{prefix}_warm_accept": res.warmup_accept_rate,
            f"{prefix}_div": res.divergences}


def save(out: str, name: str, **arrays) -> None:
    np.savez(Path(out) / f"{name}.r{dist.get_rank()}.npz",
             **{k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in arrays.items()})


def rank_mesh_graphs(out: str) -> None:
    """Both ranks: the chain split's cases, the row split, the counter, the posterior run."""
    arrays = {}
    chains = parallel.make_mesh(2, (CHAIN_AXIS, "data"), (2, 1))
    for name, (kernel, init) in split_runs().items():
        arrays[f"{name}_capturable"] = parallel.chain_sliced(kernel, chains).capturable
        run = lambda: parallel.run(kernel, torch.Generator().manual_seed(2), init, num_samples=STEPS,  # noqa: E731
                                   burn_in=BURN, mesh=chains)
        eager = parallel.run(kernel, torch.Generator().manual_seed(2), init, num_samples=STEPS, burn_in=BURN,
                             mesh=chains, capture=False)
        before = graphs.capture_count()
        with rehearsed_capture():
            graph = run()
            again = run()  # another chain-split wrap of the same kernel: the same entry
        arrays.update(result_arrays(f"{name}_eager", eager), **result_arrays(f"{name}_graph", graph),
                      **{f"{name}_again_samples": again.samples, f"{name}_captures": graphs.capture_count() - before})

    # The row split over Gloo: eager by default, refused with capture=True.
    rows = parallel.make_mesh(2, (CHAIN_AXIS, "data"), (1, 2))
    model = blr_model().with_sharding(rows)
    kernel = rmhmc.build(model, rmhmc.RMHMCConfig(num_leapfrog=3))
    init = default_init(blr_model(), torch.Generator().manual_seed(1), CHAINS)
    arrays["rows_capturable"] = kernel.capturable
    with pytest.raises(ValueError) as refused:
        parallel.run(kernel, torch.Generator().manual_seed(2), init, num_samples=1, capture=True, mesh=rows)
    arrays["rows_refused"] = str(refused.value)
    issued = []
    collectives.reset_call_counts()
    with issued_all_reduces(issued):
        eager = parallel.run(kernel, torch.Generator().manual_seed(2), init, num_samples=STEPS, burn_in=BURN,
                             mesh=rows)
    arrays.update(result_arrays("rows_eager", eager), rows_eager_issued=len(issued),
                  rows_eager_counted=collectives.call_counts()["all_reduce"])
    # The same step through StepGraph.scan, against the runner's eager loop.
    with torch.inference_mode():
        state = kernel.init(init)
        entry = graphs.StepGraph(kernel.step, graphs.position_of, state)
        scanned = entry.scan(torch.Generator().manual_seed(2), state, STEPS, True)
        looped = parallel.runner._scan_phase(kernel.step, torch.Generator().manual_seed(2), state, STEPS, True)
    for prefix, (final, out_, acc, div) in (("rows_scan", scanned), ("rows_loop", looped)):
        arrays.update({f"{prefix}_samples": out_, f"{prefix}_final": final.position, f"{prefix}_accept": acc,
                       f"{prefix}_div": div})
    # Declared NCCL's: the runner's graph route, its all-reduces counted as the eager run's, the warm-up's not.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "get_backend", lambda group=None: "nccl")
        nccl_kernel = rmhmc.build(blr_model().with_sharding(rows), rmhmc.RMHMCConfig(num_leapfrog=3))
    issued = []
    collectives.reset_call_counts()
    with rehearsed_capture(), issued_all_reduces(issued):
        graph = parallel.run(nccl_kernel, torch.Generator().manual_seed(2), init, num_samples=STEPS, burn_in=BURN,
                             mesh=rows)
    arrays.update(result_arrays("rows_graph", graph), rows_nccl_capturable=nccl_kernel.capturable,
                  rows_graph_issued=len(issued), rows_graph_counted=collectives.call_counts()["all_reduce"])

    # The counter alone: one a call, none while paused.
    collectives.reset_call_counts()
    x = torch.ones(3)
    for _ in range(5):
        collectives.all_reduce(x, rows.group("data"))
    with launches.paused():
        collectives.all_reduce(x, rows.group("data"))
    collectives.all_reduce(x, None)  # no group: no collective
    arrays.update(counter_five=collectives.call_counts()["all_reduce"], counter_value=x)

    # The posterior run: RMHMC chain-split through the graph's body.
    ds = synthetic_logreg(seed=0, n=POSTERIOR["n"], d=POSTERIOR["d"])
    model = interop.logreg_from_numpy(ds.X.astype(np.float32), ds.t.astype(np.float32), device="cpu")
    gen = torch.Generator().manual_seed(0)
    init = default_init(model, gen, POSTERIOR["chains"])
    with rehearsed_capture():
        res = parallel.run(rmhmc.build(model), gen, init, num_samples=POSTERIOR["num_samples"],
                           burn_in=POSTERIOR["burn_in"], mesh=chains)
    arrays.update(posterior_samples=res.samples, posterior_accept=res.accept_rate, posterior_div=res.divergences)
    save(out, "mesh_graphs", **arrays)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_graphs")
    spawn(f"{Path(__file__).stem}:rank_mesh_graphs", 2, device="cpu", args=[str(out)], timeout=LAUNCH_TIMEOUT,
          pythonpath=[str(TESTS)])
    return [dict(np.load(out / f"mesh_graphs.r{r}.npz")) for r in range(2)]


KEYS = ("samples", "final", "accept", "warm_accept", "div")


@pytest.mark.parametrize("name", SPLIT)
def test_torch_mesh_graph_chain_split_equals_the_eager_mesh_loop(ranks, name):
    """Each rank: burn-in and sampling through one graph entry, bit for bit
    the eager mesh loop; a second run of the kernel reuses the entry."""
    for rank in ranks:
        assert bool(rank[f"{name}_capturable"])
        assert int(rank[f"{name}_captures"]) == 1
        for key in KEYS:
            np.testing.assert_array_equal(rank[f"{name}_graph_{key}"], rank[f"{name}_eager_{key}"], err_msg=key)
        np.testing.assert_array_equal(rank[f"{name}_again_samples"], rank[f"{name}_graph_samples"])
        assert rank[f"{name}_graph_samples"].shape[:2] == (CHAINS // 2, STEPS)
    assert not np.array_equal(ranks[0][f"{name}_graph_samples"], ranks[1][f"{name}_graph_samples"])


def test_torch_mesh_graph_row_split(ranks):
    """Over Gloo the row-split step is not captured and ``capture=True``
    names the backend; its step through ``StepGraph.scan`` and through the
    graph route (declared NCCL's) is the eager loop's, bit for bit, with the
    eager run's device-counted all-reduces."""
    r0, r1 = ranks
    for rank in ranks:
        assert not bool(rank["rows_capturable"]) and bool(rank["rows_nccl_capturable"])
        assert "'data': 'gloo'" in str(rank["rows_refused"]) and "over NCCL only" in str(rank["rows_refused"])
        for key in ("samples", "final", "accept", "div"):
            np.testing.assert_array_equal(rank[f"rows_scan_{key}"], rank[f"rows_loop_{key}"], err_msg=key)
        for key in KEYS:
            np.testing.assert_array_equal(rank[f"rows_graph_{key}"], rank[f"rows_eager_{key}"], err_msg=key)
        # Every issued all-reduce is counted, but the two warm-up steps' before the graph route's capture.
        assert int(rank["rows_eager_counted"]) == int(rank["rows_eager_issued"]) > 0
        assert int(rank["rows_graph_counted"]) == int(rank["rows_eager_counted"])
        per_step = (int(rank["rows_graph_issued"]) - int(rank["rows_graph_counted"])) / graphs.WARMUP_STEPS
        assert per_step > 0 and per_step == int(per_step)
    for key in ("samples", "final"):  # the data split: every rank holds the same chains
        np.testing.assert_array_equal(r0[f"rows_graph_{key}"], r1[f"rows_graph_{key}"])


def test_torch_mesh_graph_all_reduce_counter(ranks):
    for rank in ranks:
        assert int(rank["counter_five"]) == 5
        np.testing.assert_array_equal(rank["counter_value"], np.full(3, 2.0**6, dtype=np.float32))


def test_torch_mesh_graph_posterior_matches_jax_sharded_run(ranks):
    """The two ranks' chains together against ``rj.parallel.run(...,
    mesh=rj.parallel.make_mesh(2))``: means and variances z < 5, acceptance
    within 0.03, split R-hat < 1.1."""
    import jax
    import jax.numpy as jnp

    import riemannhamiltonianmontecarlo_tpu as rj
    import riemannhamiltonianmontecarlo_tpu_torch as rt

    c, burn, n = POSTERIOR["chains"], POSTERIOR["burn_in"], POSTERIOR["num_samples"]
    ds = synthetic_logreg(seed=0, n=POSTERIOR["n"], d=POSTERIOR["d"])
    jm = rj.models.LogisticRegression(jnp.asarray(ds.X.astype(np.float32)), jnp.asarray(ds.t.astype(np.float32)))
    jres = rj.parallel.run(rj.samplers.rmhmc.build(jm), jax.random.key(1), rj.utils.default_init(jm, jax.random.key(0), c),
                           num_samples=n, burn_in=burn, mesh=rj.parallel.make_mesh(2))
    r0, r1 = ranks
    assert float(r0["posterior_accept"]) == float(r1["posterior_accept"])  # global on both ranks
    samples = np.concatenate([r0["posterior_samples"], r1["posterior_samples"]])
    assert samples.shape == (c, n, POSTERIOR["d"])
    runs = []
    for smp, a, d in ((np.asarray(jres.samples), jres.accept_rate, jres.divergences),
                      (samples, r0["posterior_accept"], r0["posterior_div"])):
        flat = smp.reshape(-1, smp.shape[-1])
        ess = rt.diagnostics.ess_multichain(smp, nfft_mode="exact")
        runs.append((flat.mean(0), flat.var(0), ess, float(a), int(d)))
        assert rt.diagnostics.split_rhat(smp).max() < 1.1
    (mj, vj, ej, aj, dj), (mt, vt, et, at, dt) = runs
    assert (np.abs(mt - mj) / np.sqrt(vj / ej + vt / et)).max() < 5.0
    assert (np.abs(vt - vj) / np.sqrt(2 * vj**2 / ej + 2 * vt**2 / et)).max() < 5.0
    assert abs(at - aj) < 0.03 and 0.8 < at < 0.99
    assert dj <= 0.005 * c * n and dt <= 0.005 * c * n
