"""Where a step's time goes, per workload sampler, on a CUDA card.

For each (workload, sampler) at its full size: wall milliseconds per step
from unprofiled steps (``torch.cuda.synchronize()`` at both ends), then
``torch.profiler`` over a few more steps for the device's busy time, the
number of kernel launches and the share of device time in GEMMs (kernel
names with gemm / cutlass / xmma) and in the library factorizations
(potrf / trsm; the trsm part also on its own) and, for FitzHugh-Nagumo,
in the sensitivity kernel (``fhn_sensitivities_kernel``), for BLR Gibbs in
its sweep kernel G1, its GIG kernel G2 and PyTorch's random draws (kernel
names with ``distribution``), and the peak of allocated device memory.  The idle share is 1 - busy / wall.  For StochVol
(rmhmc, hmc and mmala, which run the bidiagonal Cholesky scan
``ops.tridiag.cholesky`` once a sweep and the PCR solve ``ops.tridiag.solve``
L + 2 or 3 times) it also gives the scan's and the solve's device time and
launches a call (a CUDA graph of one call alone at the sweep's shapes,
off StochVol's expanded view: CUDA events over its replays for the time,
torch.profiler's events for the launches), the solve's calls a sweep
(counted in one more eager sweep) and each one's share of the sweep's
device time, and on the eager row the scan's wall time inside the sweep,
for its share of the sweep's wall.  For BLR RMHMC it gives RMHMC's geometry the same way
(``ops.chol_inv_logdet``: a CUDA graph of one geometry at the step's G),
the geometries a step builds (the kernels' device counters) and their
share of the step's device time, and its two fixed points the same way
(``position_fixed_point`` and ``momentum_fixed_point`` of the model at the
step's state, each as a graph of one call: the momentum fixed point, its
one-round half-step and the position fixed point, six of each a step) with
their launches a call and their shares of the step's device time.

``--routes kernel,parent,pcr-plain`` profiles each run on each route: on
this checkout's kernels; on the route the kernels K4 and K5 replaced
(``parent``: BLR RMHMC's two fixed points as the sampler's loops, K2 a
position round, ``LogisticRegression.fixed_point_kernels`` patched to
False for the run, ``parent_routes``); and on this checkout's kernels but
T2 (``pcr-plain``: ``tridiag.solve_plain`` alone patched in,
``plain_solve_route``): the rows before and after those changes, from one
process on one card.  Each row names its ``route``.

Each run whose kernel declares itself capturable gets four rows, in turns
E C C E (both paths on either side of a drift in the card's state):
``eager`` (the step launched from the host, as ``run(..., capture=False)``)
and ``captured`` (replays of the step's CUDA graph, ``parallel.graphs``, as
``run`` does by default on a card), the captured rows with the capture's
seconds and the bytes of device memory its graph pool reserved.  The BLR
rows are RMHMC at the reference constants (4096 chains) and Gibbs (1024) on
synthetic data of australian's shape (N = 690, D = 15); the ``blr-german``
rows are that RMHMC run on german's shape (N = 1000, D = 25); the ``blr-wide``
rows Gibbs (64 chains) on N = 300, D = 2,049 under a prior of variance 1e-2,
where G1 takes its wide layout (chip_smoke.py phase 6).  The ``blr-mesh``
rows are that RMHMC run on a ("chains", "data") mesh of shape (1, 1) over
NCCL in this process (world 1, a TCP store on a free local port), the model
from ``with_sharding``: every row gives its all-reduces a step, counted on
the device (``collectives.call_counts``).

    python -m riemannhamiltonianmontecarlo_tpu_torch.step_profile [--out FILE] \\
        [--only lgc/rmhmc_joint fhn/rmhmc] [--routes kernel,parent,pcr-plain]

Prints one JSON line per row (and writes them to FILE).  Needs a CUDA
device; there is no CPU path.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import time
import unittest.mock

import torch
from torch.profiler import ProfilerActivity, profile

from riemannhamiltonianmontecarlo_tpu_torch import experiments, interop, models, ops, parallel, samplers, utils
from riemannhamiltonianmontecarlo_tpu_torch.ops import hopper_linalg, launches, tridiag
from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives, graphs
from riemannhamiltonianmontecarlo_tpu_torch.parallel.launch import free_port
from riemannhamiltonianmontecarlo_tpu_torch.samplers import pmala, rmhmc

# (workload, sampler, chains): the chip-smoke configurations.
RUNS = (
    ("blr", "rmhmc", 4096), ("blr-german", "rmhmc", 4096), ("blr-mesh", "rmhmc", 4096), ("blr", "gibbs", 1024),
    ("blr-wide", "gibbs", 64),
    ("stochvol", "rmhmc", 1024), ("stochvol", "hmc", 1024), ("stochvol", "mala", 1024), ("stochvol", "mmala", 1024),
    ("lgc", "rmhmc", 64), ("lgc", "pmala", 64), ("lgc", "mmala", 8), ("lgc", "mala_stationary", 16),
    ("lgc", "rmhmc_joint", 4), ("lgc", "mmala_joint", 4),
    ("fhn", "rmhmc", 256), ("fhn", "hmc", 256), ("fhn", "mmala", 256), ("fhn", "mala", 256),
)
BLR = ("blr", "blr-german", "blr-mesh")  # BLR workloads: australian's shape, german's, australian's on a mesh
WIDE_PRIOR_VARIANCE = 1e-2  # blr-wide: a ridge prior for more features than rows (chip_smoke.SWEEP_DIRECT_PRIOR_VARIANCE)
GEMM = re.compile(r"gemm|cutlass|xmma|gemv", re.IGNORECASE)
FACTOR = re.compile(r"potrf|trsm|chol", re.IGNORECASE)
TRSM = re.compile(r"trsm", re.IGNORECASE)  # the triangular solves' part of FACTOR
FHN = re.compile(r"fhn_sensitivities")
GIBBS = {"gibbs_sweep_kernel": re.compile(r"gibbs_sweep_\w*kernel"),
         "gig_half_kernel": re.compile(r"gig_half_kernel"), "draws": re.compile(r"distribution")}


ROUTES = ("kernel", "parent", "pcr-plain")


def parent_routes():
    """Inside, BLR RMHMC's two fixed points take the route the kernels K4 and K5 replaced: the sampler's
    loops (``ops.logreg_fixed_point``'s plain versions), K2 a position round on a card."""
    return unittest.mock.patch.object(models.LogisticRegression, "fixed_point_kernels", lambda self, w, linalg=None: False)


def plain_solve_route():
    """Inside, StochVol's PCR solve is ``tridiag.solve_plain`` on the card, every other kernel this checkout's."""
    return unittest.mock.patch.object(tridiag, "solve", tridiag.solve_plain)


def _route(route: str):
    return {"parent": parent_routes, "pcr-plain": plain_solve_route}.get(route, contextlib.nullcontext)()


def _world1_mesh() -> parallel.Mesh:
    """A ("chains", "data") mesh of shape (1, 1) over a world of one NCCL rank
    (joined here the first time; ``main`` leaves it)."""
    parallel.initialize_distributed(device="cuda", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    return parallel.make_mesh(1, (parallel.CHAIN_AXIS, "data"), (1, 1))


def _kernel(workload: str, sampler: str, device: torch.device):
    """(kernel, init_fn, mesh or None, the BLR model or None) of a run of RUNS."""
    if workload in BLR:  # chip_smoke.py's main path (rmhmc) and phase 6's samplers
        ds = models.synthetic_logreg(seed=0, n=1000, d=25) if workload == "blr-german" else \
            models.synthetic_logreg(seed=0, n=690, d=15)
        model = interop.logreg_from_numpy(ds.X, ds.t, device=device)
        mesh = _world1_mesh() if workload == "blr-mesh" else None
        if mesh is not None:
            model = model.with_sharding(mesh)
        kernel = rmhmc.build(model) if sampler == "rmhmc" else experiments.build_kernel(sampler, model, "australian")[0]
        return (kernel, lambda c: utils.default_init(model, torch.Generator(device=device).manual_seed(0), c), mesh,
                model)
    if workload == "blr-wide":  # chip_smoke.py phase 6's Gibbs past 32 x 34 features, G1's wide layout
        ds = models.synthetic_logreg(seed=0, n=300, d=2049)
        model = interop.logreg_from_numpy(ds.X, ds.t, device=device)
        kernel = samplers.gibbs.build(model, samplers.gibbs.GibbsConfig(prior_variance=WIDE_PRIOR_VARIANCE))
        return kernel, lambda c: utils.default_init(model, torch.Generator(device=device).manual_seed(0), c), None, model
    if sampler == "pmala":  # constant-metric mMALA, built on the model's metric (RESULTS.md:78)
        y, _ = models.lgc.generate_data(seed=0, n=64)
        model = experiments.interop.lgc_from_numpy(y, 64, device=device)
        return (pmala.build(model, model.metric_chol, model.metric_inv),
                lambda c: model.prior_mean().expand(c, -1).clone(), None, None)
    kernel, init_fn, _, _, _ = experiments.build_workload(workload, sampler, device=device, seed=0)
    return kernel, init_fn, None, None


def _wall_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def profile_run(workload: str, sampler: str, chains: int, *, warm: int, steps: int, profiled: int,
                captured: bool = False) -> dict:
    device = torch.device("cuda")
    kernel, init_fn, mesh, model = _kernel(workload, sampler, device)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        state = parallel.run(kernel, gen, init_fn(chains), num_samples=0, burn_in=warm, collect=False,
                             mesh=mesh, capture=captured).final_state
        box = [state]
        if captured:  # the runner's own graph of this step (captured by the burn-in above)
            entry = graphs.lookup(kernel.step, None, state)
            if entry is None:
                raise RuntimeError(f"{workload}/{sampler}: the burn-in left no captured graph of the step")

            def run_steps(n: int) -> None:
                box[0] = entry.scan(gen, box[0], n, False)[0]
        else:
            def run_steps(n: int) -> None:
                for _ in range(n):
                    box[0], _ = kernel.step(gen, box[0])

        collectives.reset_call_counts()
        launches.reset()
        wall = _wall_ms(lambda: run_steps(steps), 1) / steps
        all_reduce = collectives.call_counts()["all_reduce"] / steps
        linalg_launches = {name: n / steps for name, n in launches.counts().items() if name != "all_reduce"}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_steps(profiled)
            torch.cuda.synchronize()
    # Device-side events (kernels, memcpy, memset) and their durations in ms per step.
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3 / profiled) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, ms in kernels)
    out = {
        "workload": workload, "sampler": sampler, "chains": chains, "path": "captured" if captured else "eager",
        "capturable": kernel.capturable,
        "wall_ms_per_step": wall, "device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / wall,
        "kernel_launches_per_step": len(kernels) / profiled, "all_reduce_per_step": all_reduce,
        "gemm_share_of_device": sum(ms for name, ms in kernels if GEMM.search(name)) / busy,
        "factor_share_of_device": sum(ms for name, ms in kernels if FACTOR.search(name)) / busy,
        "trsm_share_of_device": sum(ms for name, ms in kernels if TRSM.search(name)) / busy,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    if captured:
        out.update(capture_s=entry.capture_s, graph_pool_bytes=entry.pool_bytes)
    if workload == "fhn":
        out["fhn_kernel_share_of_device"] = sum(ms for name, ms in kernels if FHN.search(name)) / busy
    if sampler == "gibbs":
        out.update({f"{part}_share_of_device": sum(ms for name, ms in kernels if pattern.search(name)) / busy
                    for part, pattern in GIBBS.items()})
    if workload in BLR and sampler == "rmhmc":  # the geometry: K3, or K1 and the inverse
        geo = _geometry_device(box[0].geo.metric)
        calls = linalg_launches["chol_inv_logdet"] + linalg_launches["cholesky"]
        out.update(geo, geometry_calls_per_step=calls,
                   geometry_share_of_device=calls * geo["geometry_device_ms_per_call"] / busy,
                   fixed_point_launches_per_step={name: linalg_launches[name] for name in
                                                  ("position_fixed_point", "momentum_fixed_point", "chol_solve_logdet")})
        fixed = _fixed_point_device(model, box[0], gen)
        out.update(fixed, fixed_point_share_of_device=fixed["fixed_point_device_ms_per_step"] / busy)
    if workload == "stochvol" and sampler != "mala":
        scan = _scan_device(box[0].x)
        out.update(scan, tridiag_scan_share_of_device=scan["tridiag_scan_device_ms_per_step"] / busy)
        pcr = _solve_device(box[0].x)
        calls = _solve_calls(lambda: kernel.step(gen, box[0]))
        out.update(pcr, pcr_solve_calls_per_step=calls,
                   pcr_solve_share_of_device=calls * pcr["pcr_solve_device_ms_per_call"] / busy)
        if not captured:  # a replay runs no Python: the wall share is the eager step's
            out.update(_scan_share(lambda: run_steps(1), steps))
    return out


def _graph_alone(fn, replays: int = 10) -> tuple[float, float]:
    """(device ms, launches) per call of ``fn`` captured alone as a CUDA graph: CUDA events around
    ``replays`` replays back to back (a graph of a launch or two is too short for torch.profiler, which
    now and then misses its events), the launches from torch.profiler's events over as many replays."""
    with torch.inference_mode():
        fn()  # warm
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(replays):
                graph.replay()
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return start.elapsed_time(end) / replays, len(events) / replays


def _latent_metric_like(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An SPD tridiagonal G at ``x``'s (C, T), its off-diagonal an expanded view as the latent metric's."""
    return torch.full_like(x, 2.5), torch.full_like(x[:, :1], -1.0).expand(-1, x.shape[-1] - 1)


def _scan_device(x: torch.Tensor) -> dict:
    """The bidiagonal scan's device ms and launches per call at ``x``'s (C, T): ``tridiag.cholesky``
    alone as a CUDA graph (``_graph_alone``)."""
    diag, off = _latent_metric_like(x)
    ms, n = _graph_alone(lambda: tridiag.cholesky(diag, off))
    return {"tridiag_scan_device_ms_per_step": ms, "tridiag_scan_launches": n}


def _solve_device(x: torch.Tensor) -> dict:
    """The PCR solve's device ms and launches per call at ``x``'s (C, T): ``tridiag.solve`` of ``x`` alone
    as a CUDA graph (``_graph_alone``), on whichever route ``tridiag.solve`` takes."""
    diag, off = _latent_metric_like(x)
    ms, n = _graph_alone(lambda: tridiag.solve(diag, off, x))
    return {"pcr_solve_device_ms_per_call": ms, "pcr_solve_launches_per_call": n}


def _solve_calls(one_step) -> int:
    """The calls of ``tridiag.solve`` in one eager step (the samplers call it through the module)."""
    inner, calls = tridiag.solve, [0]

    def counted(*args):
        calls[0] += 1
        return inner(*args)

    with unittest.mock.patch.object(tridiag, "solve", counted), torch.inference_mode():
        one_step()
    return calls[0]


def _geometry_device(g: torch.Tensor) -> dict:
    """RMHMC's geometry (``ops.chol_inv_logdet``: L, G^-1, 1/2 log|G|) at the step's G: device ms and
    launches per call, one call as a CUDA graph (``_graph_alone``)."""
    ms, n = _graph_alone(lambda: ops.chol_inv_logdet(g))
    return {"geometry_device_ms_per_call": ms, "geometry_launches_per_call": n}


def _fixed_point_device(model, state, gen: torch.Generator) -> dict:
    """BLR RMHMC's two fixed points at the step's state (``rmhmc.RMHMCConfig()``'s: L 6, 4 rounds each, eps
    0.5): the momentum fixed point, its one-round half-step and the position fixed point, each one call of
    the model's method as a CUDA graph (``_graph_alone``): device ms and launches a call, and ms a step (six
    of each: the leapfrog loop runs L steps in lockstep)."""
    cfg = rmhmc.RMHMCConfig()
    w, geo = state.position, state.geo
    p = ops.mvn_sample(geo.chol, torch.randn(w.shape, generator=gen, device=w.device, dtype=w.dtype))
    dt = torch.where(torch.rand(w.shape[:1], generator=gen, device=w.device) < 0.5, 1.0, -1.0) * cfg.step_size
    base = geo.grad - 0.5 * model.dg_trace(w, geo.inv, cache=geo.cache)
    mom = lambda rounds: model.momentum_fixed_point(w, geo.inv, geo.cache, p, p, base, dt, rounds=rounds)
    with torch.inference_mode():
        pm = mom(cfg.num_fixed_point)
        u0 = torch.einsum("...ab,...b->...a", geo.inv, pm)
    calls = {"momentum_fixed_point": lambda: mom(cfg.num_fixed_point), "momentum_half_step": lambda: mom(1),
             "position_fixed_point": lambda: model.position_fixed_point(w, pm, u0, dt, rounds=cfg.num_fixed_point)}
    out, total = {}, 0.0
    with launches.paused():
        for name, fn in calls.items():
            ms, n = _graph_alone(fn)
            out[f"{name}_device_ms_per_call"], out[f"{name}_launches_per_call"] = ms, n
            total += cfg.num_leapfrog * ms
    out["fixed_point_device_ms_per_step"] = total
    return out


def _scan_share(one_step, steps: int) -> dict:
    """The bidiagonal scan's wall ms per step and share of the step, in place:
    ``tridiag.cholesky`` is wrapped with a synchronize on both sides while
    ``steps`` more steps run (the samplers call it through the module)."""
    inner, spent = tridiag.cholesky, [0.0]

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = inner(*args)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return result

    tridiag.cholesky = timed
    try:
        with torch.inference_mode():
            wall = _wall_ms(one_step, steps)
    finally:
        tridiag.cholesky = inner
    scan = 1e3 * spent[0] / steps
    return {"tridiag_scan_wall_ms_per_step": scan, "tridiag_scan_share_of_step": scan / wall}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--warm", type=int, default=3, help="steps before any timing")
    ap.add_argument("--steps", type=int, default=5, help="unprofiled steps timed for the wall clock")
    ap.add_argument("--profiled", type=int, default=3, help="steps under torch.profiler")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    ap.add_argument("--only", nargs="+", default=None, metavar="WORKLOAD/SAMPLER",
                    help="profile these runs only (default: all of RUNS)")
    ap.add_argument("--routes", default="kernel",
                    help=f"comma-separated subset of {','.join(ROUTES)}: this checkout's kernels, the route "
                         "K4 and K5 replaced, and this checkout's kernels with the plain PCR solve "
                         "(default: kernel)")
    args = ap.parse_args(argv)
    routes = [r for r in args.routes.split(",") if r]
    if not routes or set(routes) - set(ROUTES):
        ap.error(f"--routes takes a comma-separated subset of {','.join(ROUTES)}, got {args.routes!r}")
    known = {f"{w}/{s}" for w, s, _ in RUNS}
    if args.only and not set(args.only) <= known:
        ap.error(f"--only takes names among {sorted(known)}")
    if not torch.cuda.is_available():
        ap.error("needs a CUDA device (torch.cuda.is_available() is False)")
    lines = []
    for workload, sampler, chains in RUNS:
        if args.only and f"{workload}/{sampler}" not in args.only:
            continue
        for route in routes:
            for captured in (False, True, True, False):
                with _route(route):
                    rec = profile_run(workload, sampler, chains, warm=args.warm, steps=args.steps,
                                      profiled=args.profiled, captured=captured)
                rec.update(route=route, device=torch.cuda.get_device_name(0))
                lines.append(json.dumps(rec))
                print(lines[-1], flush=True)
                if not rec["capturable"]:
                    break
    if torch.distributed.is_initialized():  # the blr-mesh rows' world of one rank
        torch.distributed.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
