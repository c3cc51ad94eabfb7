"""The experiment layer: a library and a CLI.

Port of ``riemannhamiltonianmontecarlo_tpu/experiments.py``: build the model
and kernel from the reference presets, run the chains on one device, and
report the reference's summary statistics (min / median / mean / max ESS,
sampling-phase wall clock, time per min-ESS -- ``code/main.py:70-79``,
``CalculateStatistics.m:24-31``).  Two halves:

* BLR (``run_experiment``): the nine samplers on the five datasets;
* the other workloads (``run_workload``): stochastic volatility (the
  two-block samplers), log-Gaussian Cox (constant-metric RMHMC,
  position-dependent mMALA, whitened MALA, and the joint samplers over
  (sigma^2, beta, x), ``rmhmc_joint`` / ``mmala_joint``) and FitzHugh-Nagumo
  (six samplers on the ODE posterior), on data generated from ``seed``.

Timing protocol: only the post-burn-in sampling phase is timed.  It runs as
two identical half-scans; the reported time is twice the *second* half, a
steady-state measurement, with ``torch.cuda.synchronize()`` at both ends on
a CUDA device.  On a card the first half also captures the step's CUDA graph
(``parallel.graphs``), which the second replays: a capture inside the timed
half raises.

The device is explicit.  A CUDA request on a machine without CUDA raises;
nothing falls back to the CPU.

Ranks: ``run_experiment(..., mesh=)`` splits the chains over the mesh's
``"chains"`` axis (and the BLR rows over a ``"data"`` axis, when it has one)
and reports global figures on every rank.  The CLI joins a process group of
its own when it runs under ``torchrun`` (``parallel.initialize_distributed``
reads its environment) and prints on rank 0:

    torchrun --nproc-per-node 2 -m riemannhamiltonianmontecarlo_tpu_torch.experiments \\
        --sampler hmc --device cpu --chains 64

CLI::

    python -m riemannhamiltonianmontecarlo_tpu_torch.experiments \\
        --sampler mmala --dataset australian --device cuda
    python -m riemannhamiltonianmontecarlo_tpu_torch.experiments \\
        --workload stochvol --sampler rmhmc --device cuda
    python -m riemannhamiltonianmontecarlo_tpu_torch.experiments \\
        --workload lgc --sampler rmhmc_joint --chains 4 --device cuda
    python -m riemannhamiltonianmontecarlo_tpu_torch.experiments \\
        --workload fhn --sampler mmala --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from riemannhamiltonianmontecarlo_tpu_torch import diagnostics, interop, models, parallel, samplers, utils
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import tree_map
from riemannhamiltonianmontecarlo_tpu_torch.utils.config import (
    MALA_STEP_SIZES,
    MALA_TRANSIENT_FACTOR,
    reference_preset,
)

SAMPLERS = (
    "metropolis",
    "hmc",
    "mala",
    "mmala",
    "mmala_simplified",
    "iwls",
    "gibbs",
    "rmhmc",
    "rmhmc_studentt",
)
ESS_MODES = ("reference", "exact", "device", "native")


@dataclasses.dataclass
class ExperimentResult:
    sampler: str
    dataset: str
    num_chains: int
    num_samples: int
    ess_min: float
    ess_median: float
    ess_mean: float
    ess_max: float
    sampling_time_s: float
    time_per_min_ess: float
    accept_rate: float
    divergences: int
    posterior_mean: np.ndarray
    posterior_std: np.ndarray
    rhat_max: float = float("nan")
    geweke_max_abs_z: float = float("nan")
    adapted_step_size: float | None = None  # set by --adapt runs
    samples: np.ndarray | None = None

    def summary(self) -> str:
        return (
            f"{self.sampler} on {self.dataset}: {self.num_chains} chains x "
            f"{self.num_samples} samples\n"
            f"  ESS (total over chains): min {self.ess_min:.0f}  median "
            f"{self.ess_median:.0f}  mean {self.ess_mean:.0f}  max {self.ess_max:.0f}\n"
            f"  sampling time: {self.sampling_time_s:.3f} s   "
            f"time/minESS: {self.time_per_min_ess:.3e} s   "
            f"accept: {self.accept_rate:.3f}   divergences: {self.divergences}   "
            f"max R-hat: {self.rhat_max:.4f}   max |Geweke z|: {self.geweke_max_abs_z:.2f}\n"
            f"  posterior mean[:5]: {np.round(self.posterior_mean[:5], 3)}"
        )


def build_kernel(name: str, model, dataset: str, overrides: dict[str, Any] | None = None):
    """(kernel, warmup_kernel_or_None) from reference presets."""
    kw = dict(reference_preset(name, dataset).sampler_kwargs)
    if overrides:
        kw.update(overrides)
    s = samplers
    if name == "metropolis":
        return s.metropolis.build(model, s.metropolis.AMHConfig()), None
    if name == "hmc":
        return s.hmc.build(model, s.hmc.HMCConfig(**kw)), None
    if name == "mala":
        step = kw.get("step_size", MALA_STEP_SIZES.get(dataset, 0.05))
        factor = MALA_TRANSIENT_FACTOR.get(dataset, 1.0)
        kernel = s.mala.build(model, s.mala.MALAConfig(step_size=step))
        warm = s.mala.build(model, s.mala.MALAConfig(step_size=step, transient=True, transient_factor=factor))
        return kernel, warm
    if name == "mmala":
        return s.mmala.build(model, s.mmala.MMALAConfig(**kw)), None
    if name == "mmala_simplified":
        return s.mmala.build(model, s.mmala.MMALAConfig(simplified=True, **kw)), None
    if name == "iwls":
        return s.iwls.build(model), None
    if name == "gibbs":
        return s.gibbs.build(model), None
    if name == "rmhmc":
        return s.rmhmc.build(model, s.rmhmc.RMHMCConfig(**kw)), None
    if name == "rmhmc_studentt":
        return s.rmhmc.build(model, s.rmhmc.RMHMCConfig(student_t=True, **kw)), None
    raise KeyError(f"unknown sampler '{name}'; options: {SAMPLERS}")


# Samplers whose step size dual averaging can adapt: (build_fn, config,
# optimal-scaling acceptance target).  Targets: 0.651 for the HMC family
# (Beskos et al. 2013), 0.574 for Langevin (Roberts & Rosenthal 1998).
def adaptive_parts(name: str, dataset: str, overrides: dict[str, Any] | None = None):
    """(build_fn, config, target_accept) for --adapt runs.

    The step size starts from a dimension-blind guess, not the hand-tuned
    reference constant: the point is zero per-dataset tuning.
    """
    kw = dict(reference_preset(name, dataset).sampler_kwargs)
    if overrides:
        kw.update(overrides)
    kw.pop("step_size", None)  # discard the hand-tuned constant
    s = samplers
    if name == "hmc":
        return s.hmc.build, s.hmc.HMCConfig(step_size=0.1, **kw), 0.651
    if name == "mala":
        return s.mala.build, s.mala.MALAConfig(step_size=0.1), 0.574
    if name == "mmala":
        return s.mmala.build, s.mmala.MMALAConfig(step_size=0.5, **kw), 0.574
    if name == "mmala_simplified":
        return s.mmala.build, s.mmala.MMALAConfig(step_size=0.5, simplified=True, **kw), 0.574
    if name == "rmhmc":
        return s.rmhmc.build, s.rmhmc.RMHMCConfig(step_size=0.1, **kw), 0.8
    if name == "rmhmc_studentt":
        return s.rmhmc.build, s.rmhmc.RMHMCConfig(step_size=0.1, student_t=True, **kw), 0.8
    raise KeyError(f"sampler '{name}' has no adaptable step size")


def _check_no_capture(captures: int) -> None:
    """Raise if a CUDA graph was captured since ``captures`` (inside a timed half)."""
    if parallel.graphs.capture_count() != captures:
        raise RuntimeError("a CUDA graph was captured inside the timed half: the time would include the capture")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device to run on; a CUDA request without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return device


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_experiment(
    sampler: str,
    dataset: str = "australian",
    *,
    device: str | torch.device = "cuda",
    num_chains: int = 1024,
    num_samples: int | None = None,
    burn_in: int | None = None,
    seed: int = 0,
    init: str = "map",
    ess_mode: str = "reference",
    keep_samples: bool = False,
    sampler_overrides: dict[str, Any] | None = None,
    adapt: bool = False,
    mesh: parallel.Mesh | None = None,
) -> ExperimentResult:
    """One BLR experiment at the reference presets (``code/main.py``).

    ``ess_mode``: "reference" / "exact" (host NumPy, with or without the
    reference's nFFT quirk), "device" (torch on the samples' device),
    "native" (the C++ engine of ``native/fastess.cpp``, exact mode).  With a
    ``mesh`` the chains (and, on a ``"data"`` axis, the rows) are split over
    ranks; every figure is global and the same on each rank, and
    ``samples`` are the rank's own chains.
    """
    if ess_mode not in ESS_MODES:
        raise ValueError(f"ess_mode must be one of {ESS_MODES}, got {ess_mode!r}")
    device = resolve_device(device)
    preset = reference_preset(sampler, dataset)
    num_samples = preset.num_samples if num_samples is None else num_samples
    burn_in = preset.burn_in if burn_in is None else burn_in

    ds = models.load_dataset(dataset)
    model = interop.logreg_from_numpy(ds.X, ds.t, device=device)
    if mesh is not None and "data" in mesh.axis_names:
        model = model.with_sharding(mesh, "data")

    gen = torch.Generator(device=device).manual_seed(seed)
    if init == "map":
        position = utils.default_init(model, gen, num_chains)
    elif init == "zeros":
        position = torch.zeros((num_chains, model.dim), device=device)
    elif init == "reference":
        # code/rmhmc.py:27 uses 1e-3; code/hmc.py:27 zeros.
        position = torch.full((num_chains, model.dim), 1e-3, device=device)
    else:
        raise ValueError(f"init must be map|zeros|reference, got {init!r}")

    half = max(num_samples // 2, 1)
    adapted_eps = None
    if adapt:
        # Dual-averaging warmup on pooled acceptance: no hand-tuned step.
        build_fn, cfg, target = adaptive_parts(sampler, dataset, sampler_overrides)
        warm_kernel = parallel.adaptive(build_fn, model, cfg, parallel.AdaptationConfig(target_accept=target), mesh)
        warm = parallel.run(warm_kernel, gen, position, num_samples=burn_in, collect=False, mesh=mesh)
        adapted_eps = parallel.frozen_step_size(warm.final_state)
        kernel = build_fn(model, dataclasses.replace(cfg, step_size=adapted_eps))
        warm_state = warm.final_state.inner
    else:
        kernel, warmup_kernel = build_kernel(sampler, model, dataset, sampler_overrides)
        # The transient-phase kernel (MALA's sqrt(D) scaling, BLR_MALA.m:167)
        # steps the burn-in; its state type matches the stationary kernel's.
        warm = parallel.run(warmup_kernel or kernel, gen, position, num_samples=burn_in, collect=False, mesh=mesh)
        warm_state = warm.final_state
    _synchronize(device)

    res_a = parallel.run(kernel, gen, None, num_samples=half, init_state=warm_state, mesh=mesh)
    _synchronize(device)
    captures = parallel.graphs.capture_count()
    t0 = time.perf_counter()
    res_b = parallel.run(kernel, gen, None, num_samples=half, init_state=res_a.final_state, mesh=mesh)
    _synchronize(device)
    sampling_time = 2.0 * (time.perf_counter() - t0)
    _check_no_capture(captures)

    accept = 0.5 * (float(res_a.accept_rate) + float(res_b.accept_rate))
    div = int(res_a.divergences) + int(res_b.divergences)
    dev_samples = torch.cat([res_a.samples, res_b.samples], dim=1)  # (C, S, D)
    num_kept = dev_samples.shape[1]

    # Every figure is over the chains of every rank: ESS and the moments are
    # sums over chains, all-reduced over the chain group (None without a mesh:
    # the local sums), and R-hat pools its chain means and variances the same
    # way.  Only the ESS engine depends on ``ess_mode``; "device" keeps the
    # samples on the device unless they are asked for.
    group = None if mesh is None else mesh.group(parallel.CHAIN_AXIS)
    samples = dev_samples.cpu().numpy() if keep_samples or ess_mode != "device" else None
    if ess_mode == "device":
        ess = diagnostics.ess_geyer_device(dev_samples)
    else:
        ess = torch.from_numpy(_host_ess(samples, ess_mode)).to(dev_samples.device)
    ess = parallel.collectives.all_reduce(ess.to(torch.float64), group).cpu().numpy()
    stats = dev_samples.to(torch.float64)
    rhat_max = float(diagnostics.split_rhat_device(stats, group).max())
    flat = stats.reshape(-1, stats.shape[-1])
    mean = parallel.cross_chain_mean(flat, group)
    flat_mean = mean.cpu().numpy()
    flat_std = torch.sqrt(parallel.cross_chain_mean((flat - mean) ** 2, group)).cpu().numpy()
    # Geweke on the run's first 8 chains, the chain group's first rank's.
    first = mesh is None or mesh.index(parallel.CHAIN_AXIS) == 0
    geweke = np.abs(diagnostics.geweke_z(dev_samples[:8].cpu().numpy())).max() if first else 0.0
    geweke_max = float(parallel.collectives.all_reduce(torch.tensor(geweke, dtype=torch.float64, device=dev_samples.device), group))

    return ExperimentResult(
        sampler=sampler,
        dataset=dataset,
        num_chains=num_chains,
        num_samples=num_kept,
        ess_min=float(ess.min()),
        ess_median=float(np.median(ess)),
        ess_mean=float(ess.mean()),
        ess_max=float(ess.max()),
        sampling_time_s=sampling_time,
        time_per_min_ess=sampling_time / float(ess.min()),
        accept_rate=accept,
        divergences=div,
        posterior_mean=flat_mean,
        posterior_std=flat_std,
        rhat_max=rhat_max,
        geweke_max_abs_z=geweke_max,
        adapted_step_size=adapted_eps,
        samples=samples if keep_samples else None,
    )


def _host_ess(samples: np.ndarray, ess_mode: str) -> np.ndarray:
    if ess_mode == "native":
        return diagnostics.native.ess_geyer_native(samples)
    return diagnostics.ess_multichain(samples, nfft_mode=ess_mode)


def aggregate(results: list[ExperimentResult]) -> dict[str, tuple[float, float]]:
    """Mean +- standard error over independent repeats.

    The reference aggregates 10 runs this way (``code/main.py:43-54``,
    ``Results/CalculateStatistics.m:7-31``).  Returns {stat: (mean,
    stderr)} for the ESS summary, sampling time, time/minESS and
    acceptance.
    """
    out: dict[str, tuple[float, float]] = {}
    n = len(results)
    for stat in (
        "ess_min",
        "ess_median",
        "ess_mean",
        "ess_max",
        "sampling_time_s",
        "time_per_min_ess",
        "accept_rate",
    ):
        vals = np.asarray([getattr(r, stat) for r in results], np.float64)
        out[stat] = (float(vals.mean()), float(vals.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0)
    return out


def run_repeated(
    sampler: str, dataset: str = "australian", *, n_repeats: int = 10, seed: int = 0, **kwargs
) -> tuple[list[ExperimentResult], dict[str, tuple[float, float]]]:
    """n independent repeats (seeds seed .. seed + n - 1) and their aggregate."""
    results = [run_experiment(sampler, dataset, seed=seed + i, **kwargs) for i in range(n_repeats)]
    return results, aggregate(results)


# --------------------------------------------------------------------------
# Non-BLR workloads: the reference's Run_* scripts behind one entry point.
# --------------------------------------------------------------------------

WORKLOAD_SAMPLERS = {
    "blr": SAMPLERS,
    "stochvol": ("rmhmc", "hmc", "mala", "mmala"),
    "lgc": ("rmhmc", "mmala", "mala_transient", "mala_stationary", "rmhmc_joint", "mmala_joint"),
    "fhn": ("rmhmc", "hmc", "mala", "mmala", "mmala_simplified", "metropolis"),
}


def _stream_to_host(kernel, gen, state, *, steps: int, segment: int, collect_fn, out, offset: int):
    """``steps`` steps in runs of ``segment``, each run's samples copied into
    columns offset.. of the host tensors ``out``: the samples of one run of
    ``steps``, as the runs draw from one generator in turn.  Returns
    (state, mean acceptance, divergences)."""
    accept, div = 0.0, 0
    for lo in range(0, steps, segment):
        n = min(segment, steps - lo)
        r = parallel.run(kernel, gen, None, num_samples=n, init_state=state, collect_fn=collect_fn)
        tree_map(lambda buf, x: buf[:, offset + lo : offset + lo + n].copy_(x), out, r.samples)
        state, accept, div = r.final_state, accept + float(r.accept_rate) * n, div + int(r.divergences)
    return state, accept / steps, div


def timed_sampling(kernel, init, *, device: torch.device, burn_in: int, num_samples: int, seed: int = 0,
                   collect_fn=None, warmup_kernel=None, init_state=None, host_segment: int | None = None):
    """Burn-in, then the two-half steady-state timing protocol (module docstring).

    ``warmup_kernel`` (or None) steps the burn-in; ``init_state`` (with
    ``init`` None) starts it from a state instead of a position.  Returns
    (samples, accept_rate, divergences, sampling_time_s); samples holds both
    halves along the sample axis (a tree, as ``collect_fn`` returns), on
    the device.  With ``host_segment`` the samples go to host tensors
    instead (pinned on a card), copied there every ``host_segment`` steps:
    the same samples, for runs whose kept samples do not fit on the device
    twice (the halves and their concatenation); the timed half then
    includes its copies.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    warm = parallel.run(kernel, gen, init, num_samples=0, burn_in=max(burn_in, 1), collect=False,
                        warmup_kernel=warmup_kernel, init_state=init_state, collect_fn=collect_fn)
    _synchronize(device)
    half = max(num_samples // 2, 1)
    if host_segment is None:
        res_a = parallel.run(kernel, gen, None, num_samples=half, init_state=warm.final_state, collect_fn=collect_fn)
        _synchronize(device)
        captures = parallel.graphs.capture_count()
        t0 = time.perf_counter()
        res_b = parallel.run(kernel, gen, None, num_samples=half, init_state=res_a.final_state, collect_fn=collect_fn)
        _synchronize(device)
        t = 2.0 * (time.perf_counter() - t0)
        _check_no_capture(captures)
        samples = tree_map(lambda a, b: torch.cat([a, b], dim=1), res_a.samples, res_b.samples)
        accept = 0.5 * (float(res_a.accept_rate) + float(res_b.accept_rate))
        return samples, accept, int(res_a.divergences) + int(res_b.divergences), t

    pin = device.type == "cuda"
    out = tree_map(lambda x: torch.empty((x.shape[0], 2 * half, *x.shape[1:]), dtype=x.dtype, pin_memory=pin),
                   (collect_fn or (lambda st: st.position))(warm.final_state))
    kw = dict(steps=half, segment=host_segment, collect_fn=collect_fn, out=out)
    state, acc_a, div_a = _stream_to_host(kernel, gen, warm.final_state, offset=0, **kw)
    _synchronize(device)
    captures = parallel.graphs.capture_count()
    t0 = time.perf_counter()
    _, acc_b, div_b = _stream_to_host(kernel, gen, state, offset=half, **kw)
    _synchronize(device)
    t = 2.0 * (time.perf_counter() - t0)
    _check_no_capture(captures)
    return out, 0.5 * (acc_a + acc_b), div_a + div_b, t


def build_workload(workload: str, sampler: str, *, device: str | torch.device = "cuda",
                   overrides: dict[str, Any] | None = None, seed: int = 0,
                   stochvol_obs: int = 2000, lgc_n: int = 64, fhn_obs: int = 200, fhn_substeps: int = 5):
    """(kernel, init_position_fn, collect_fn, groups_fn, warmup_kernel).

    All at reference constants, on data generated from ``seed``.
    ``groups_fn(samples) -> {group_name: (C, S, P) tensor}`` maps the
    collected tree to the named quantities whose ESS the paper reports
    (StochVol hyperparameters vs latent volatilities, Tables 8/9).
    ``warmup_kernel`` (or None) steps the burn-in only: StochVol MALA's
    transient-phase step sizes.
    """
    if workload not in WORKLOAD_SAMPLERS or workload == "blr":
        options = [w for w in WORKLOAD_SAMPLERS if w != "blr"]
        raise KeyError(f"unknown workload '{workload}' for run_workload; options: {', '.join(options)}")
    if sampler not in WORKLOAD_SAMPLERS[workload]:
        raise KeyError(f"unknown {workload} sampler '{sampler}'; options: {WORKLOAD_SAMPLERS[workload]}")
    device = resolve_device(device)
    kw = dict(overrides or {})
    s = samplers

    if workload == "stochvol":
        y, _ = models.stochvol.generate_data(seed=seed, num_obs=stochvol_obs)
        model = interop.stochvol_from_numpy(y, device=device)
        t13 = stochvol_obs ** (1.0 / 3.0)
        t12 = stochvol_obs**0.5
        presets = {
            # StochVol_RMHMC.m:66-77
            "rmhmc": dict(),
            # StochVol_HMC.m:57-67
            "hmc": dict(method="hmc", latent_num_leapfrog=100, latent_step_size=0.03,
                        hyper_num_leapfrog=100, hyper_step_size=0.015),
            # StochVol_MALA.m stationary phase (:279-283): eps = StepSize/T^(1/3)
            "mala": dict(method="mala", latent_step_size=0.03 / t13, hyper_step_size=0.005 / t13),
            # StochVol_mMALA.m:66-72
            "mmala": dict(method="mmala", latent_step_size=0.07, hyper_step_size=1.0),
        }
        kernel = s.stochvol.build(model, s.stochvol.StochVolConfig(**{**presets[sampler], **kw}))
        warmup_kernel = None
        if sampler == "mala":
            # Transient phase (StochVol_MALA.m:62-67): eps = 0.05/T^(1/2)
            # latents, 0.01/T^(1/2) hypers, switched to the stationary
            # constants at the burn-in boundary (:279-283).
            warmup_kernel = s.stochvol.build(model, s.stochvol.StochVolConfig(**{**dict(
                method="mala", latent_step_size=0.05 / t12, hyper_step_size=0.01 / t12), **kw}))

        def init_fn(chains: int) -> torch.Tensor:
            # (beta, sigma, phi) = 0.5, StochVol_RMHMC.m:86-89
            return torch.full((chains, 3), 0.5, device=device)

        return (kernel, init_fn, lambda st: (st.position, st.x),
                lambda smp: {"hyper": smp[0], "latent": smp[1]}, warmup_kernel)

    if workload == "fhn":
        data, _ = models.fhn.generate_data(seed=seed if seed > 0 else 1, num_obs=fhn_obs)
        model = interop.fhn_from_numpy(data, device=device, substeps=fhn_substeps)
        builders = {
            # ODE_RMHMC.m:72-74
            "rmhmc": lambda: s.rmhmc.build(model, s.rmhmc.RMHMCConfig(
                **{"step_size": 0.5, "num_leapfrog": 6, "num_fixed_point": 5, "jitter": 1e-6, **kw})),
            # ODE_HMC.m:68-69
            "hmc": lambda: s.hmc.build(model, s.hmc.HMCConfig(**{"step_size": 1.0 / 150.0, "num_leapfrog": 150, **kw})),
            # ODE_MALA.m:64
            "mala": lambda: s.mala.build(model, s.mala.MALAConfig(**{"step_size": 2e-4, **kw})),
            # ODE_mMALA.m:69
            "mmala": lambda: s.mmala.build(model, s.mmala.MMALAConfig(**{"step_size": 1.0, "jitter": 1e-6, **kw})),
            # ODE_mMALA_Simp.m:74
            "mmala_simplified": lambda: s.mmala.build(model, s.mmala.MMALAConfig(
                **{"step_size": 1.0, "simplified": True, "jitter": 1e-6, **kw})),
            "metropolis": lambda: s.metropolis.build(model, s.metropolis.AMHConfig(
                **{"init_proposal_sd": 0.05, **kw})),
        }
        theta0 = torch.tensor(models.fhn.THETA_TRUE, device=device)

        def fhn_init(chains: int) -> torch.Tensor:
            # theta0 (1 + 0.05 N(0, 1)), the JAX package's law; it draws from
            # jax.random.key(seed + 11) (threefry), this from a torch.Generator
            # seeded with seed + 11: the same law, not the same numbers.
            gen = torch.Generator(device=device).manual_seed(seed + 11)
            return theta0 * (1.0 + 0.05 * torch.randn((chains, 3), generator=gen, device=device))

        return builders[sampler](), fhn_init, None, lambda smp: {"params": smp}, None

    # lgc
    y, _ = models.lgc.generate_data(seed=seed, n=lgc_n)
    if sampler in ("rmhmc_joint", "mmala_joint"):
        # Joint (sigma^2, beta, x) inference: LGC_RMHMC_Paras_LV.m /
        # LGC_mMALA_Paras_LV.m (hyper eps 0.2; latent eps 0.1 / 0.07).
        jm = interop.lgc_joint_from_numpy(y, lgc_n, device=device)
        preset = dict(method="mmala", latent_step_size=0.07) if sampler == "mmala_joint" else {}
        kernel = s.lgc_joint.build(jm, s.lgc_joint.LGCJointConfig(**{**preset, **kw}))
        theta0 = torch.tensor([jm.init_sigma_sq, jm.init_beta], device=device)
        return (kernel, lambda c: theta0.expand(c, -1).clone(), lambda st: (st.position, st.x),
                lambda smp: {"hyper": smp[0], "latent": smp[1]}, None)
    model = interop.lgc_from_numpy(y, lgc_n, device=device)
    if sampler in ("mala_transient", "mala_stationary"):
        # Whitened parametrization, LGC_MALA_Transient.m:32-33 /
        # LGC_MALA_Stationary.m:32-33.
        wh = model.whitened()
        cfg = (s.mala.MALAConfig(step_size=2.0, transient=True, **kw) if sampler == "mala_transient"
               else s.mala.MALAConfig(step_size=1.65**2, **kw))
        return (s.mala.build(wh, cfg), lambda c: torch.zeros((c, model.dim), device=device), None,
                lambda smp: {"latent": wh.to_x(smp)}, None)
    if sampler == "mmala":
        # LGC_mMALA_LV.m:31-34: the position-dependent metric, a (C, D, D) build per step.
        kernel = s.mmala.build(model, s.mmala.MMALAConfig(**{"step_size": 0.07, "jitter": 1e-5, **kw}))
    else:
        # Constant-metric RMHMC == preconditioned HMC, LGC_RMHMC_LV.m:95-101,149-196
        # (L=30, eps=0.1 :32-33).
        kernel = s.phmc.build(model, model.metric_chol, model.metric_inv,
                              s.phmc.PHMCConfig(**{"step_size": 0.1, "num_leapfrog": 30, **kw}))
    prior = model.prior_mean()
    return kernel, lambda c: prior.expand(c, -1).clone(), None, lambda smp: {"latent": smp}, None


@dataclasses.dataclass
class WorkloadResult:
    workload: str
    sampler: str
    num_chains: int
    num_samples: int
    accept_rate: float
    divergences: int
    sampling_time_s: float
    ess: dict[str, np.ndarray]  # group -> per-coordinate chain-summed ESS
    rhat_max: dict[str, float] = dataclasses.field(default_factory=dict)
    geweke_max_abs_z: dict[str, float] = dataclasses.field(default_factory=dict)
    samples: dict[str, np.ndarray] | None = None  # group -> (C, S, P), set by keep_samples runs

    def summary(self) -> str:
        lines = [
            f"{self.workload}/{self.sampler}: {self.num_chains} chains x "
            f"{self.num_samples} samples   accept {self.accept_rate:.3f}   "
            f"divergences {self.divergences}   sampling {self.sampling_time_s:.3f} s"
        ]
        for group, ess in self.ess.items():
            rhat = self.rhat_max.get(group, float("nan"))
            gz = self.geweke_max_abs_z.get(group, float("nan"))
            lines.append(
                f"  {group}: ESS min {ess.min():.0f}  median {np.median(ess):.0f}  "
                f"max {ess.max():.0f}   time/minESS {self.sampling_time_s / ess.min():.3e} s"
                f"   max R-hat {rhat:.4f}   max |Geweke z| {gz:.2f}"
            )
        return "\n".join(lines)


def run_workload(workload: str, sampler: str, *, device: str | torch.device = "cuda", num_chains: int = 64,
                 num_samples: int = 1000, burn_in: int = 300, seed: int = 0,
                 overrides: dict[str, Any] | None = None, keep_samples: bool = False,
                 **data_kw) -> WorkloadResult:
    """Reference-preset experiment on the stochvol, lgc or fhn workload.

    ESS, split R-hat and moments run on the device per group; Geweke z on
    an 8-chain slice on the host.  ``keep_samples`` also returns each
    group's samples as NumPy.
    """
    if workload == "blr":
        raise ValueError("use run_experiment(...) for the BLR workload")
    device = resolve_device(device)
    kernel, init_fn, collect_fn, groups_fn, warmup_kernel = build_workload(
        workload, sampler, device=device, overrides=overrides, seed=seed, **data_kw)
    samples, accept, div, t = timed_sampling(
        kernel, init_fn(num_chains), device=device, burn_in=burn_in, num_samples=num_samples,
        seed=seed, collect_fn=collect_fn, warmup_kernel=warmup_kernel)
    with torch.inference_mode():
        groups = groups_fn(samples)
        ess = {g: diagnostics.ess_geyer_device(a).cpu().numpy() for g, a in groups.items()}
        rhat = ({g: float(diagnostics.split_rhat_device(a).max()) for g, a in groups.items()}
                if num_chains >= 2 else {})
    # Geweke stationarity per group on a small chain subset (z ~ N(0,1)
    # under stationarity).
    geweke = {g: float(np.abs(diagnostics.geweke_z(a[:8].cpu().numpy())).max()) for g, a in groups.items()}
    kept = {g: a.cpu().numpy() for g, a in groups.items()} if keep_samples else None
    num_kept = next(iter(groups.values())).shape[1]
    return WorkloadResult(workload, sampler, num_chains, num_kept, accept, div, t, ess, rhat, geweke, kept)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", choices=tuple(WORKLOAD_SAMPLERS), default="blr")
    ap.add_argument("--sampler", default="rmhmc")
    ap.add_argument("--dataset", default="australian", choices=sorted(models.datasets.DATASET_SPECS),
                    help="BLR only")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1 or cpu")
    ap.add_argument("--chains", type=int, default=None, help="default 1024 for blr, 64 otherwise")
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--burn-in", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lgc-n", type=int, default=64,
                    help="lgc only: the grid is n x n (D = n^2 latents; 64 is the reference size)")
    ap.add_argument("--fhn-obs", type=int, default=200, help="fhn only: observation times (200 is the reference's)")
    ap.add_argument("--fhn-substeps", type=int, default=5, help="fhn only: RK4 steps per observation interval")
    ap.add_argument("--init", choices=("map", "zeros", "reference"), default="map", help="BLR only")
    ap.add_argument("--ess-mode", choices=ESS_MODES, default="reference",
                    help="BLR only; 'native' is the C++ engine of native/fastess.cpp (exact mode)")
    ap.add_argument("--adapt", action="store_true",
                    help="BLR only: dual-averaging step-size warmup instead of the hand-tuned reference constant")
    args = ap.parse_args(argv)
    if args.sampler not in WORKLOAD_SAMPLERS[args.workload]:
        ap.error(f"sampler '{args.sampler}' not available for workload '{args.workload}' "
                 f"(options: {WORKLOAD_SAMPLERS[args.workload]})")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    mesh = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        if args.workload != "blr":
            ap.error(f"--workload {args.workload} does not split over ranks; run it in one process")
        parallel.initialize_distributed(device=device)
        mesh = parallel.make_mesh()
    if args.workload == "blr":
        res = run_experiment(
            args.sampler,
            args.dataset,
            device=device,
            num_chains=args.chains or 1024,
            num_samples=args.samples,
            burn_in=args.burn_in,
            seed=args.seed,
            init=args.init,
            ess_mode=args.ess_mode,
            adapt=args.adapt,
            mesh=mesh,
        )
        if mesh is not None:
            rank = torch.distributed.get_rank()
            torch.distributed.destroy_process_group()
            if rank != 0:
                return
        if args.adapt:
            print(f"adapted step size: {res.adapted_step_size:.4g}")
    else:
        size = {"lgc": {"lgc_n": args.lgc_n},
                "fhn": {"fhn_obs": args.fhn_obs, "fhn_substeps": args.fhn_substeps}}.get(args.workload, {})
        res = run_workload(
            args.workload,
            args.sampler,
            device=device,
            num_chains=args.chains or 64,
            num_samples=args.samples or 1000,
            burn_in=args.burn_in if args.burn_in is not None else 300,
            seed=args.seed,
            **size,
        )
    print(res.summary())


if __name__ == "__main__":
    main()
