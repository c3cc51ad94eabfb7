#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It imports no jax.  Phases, each printing one line of findings:

1. device: the card's name and power limit (nvidia-smi), torch / CUDA
   versions, the fp32 precision flags;
2. build: compiles ``ops/csrc/*.cu`` with nvcc (cached by source hash under
   the git-ignored ``build/``), prints the build seconds and the ptxas
   register / spill report;
3. kernels: K1 (Cholesky) and K2 (fused solve + log-det) against their
   plain-PyTorch twins on the card, on seeded SPD batches at
   C in {4096, 4097} and D in {7, 10, 15, 25} (10 takes the kernels'
   runtime-width instantiation, the others a compile-time width):
   tolerance, exact-zero upper
   triangle, and one non-PD chain giving non-finite output in that chain
   only; then the median CUDA-event time of each beside its twin's;
4. one RMHMC transition through the kernels against one through the plain
   linalg, on the same state and noise (BLR, synthetic data of the
   australian shape N=690, D=15, 4096 chains);
5. the main path: MAP + jitter init, burn-in, timed sampling run, with the
   kernels' launch counts, acceptance, divergences, split R-hat, and the
   posterior means against a plain-linalg run under another seed; prints
   seconds per transition and min-ESS/s;
6. blr-samplers: the experiment entry point
   ``experiments.run_experiment(..., device="cuda")`` for all nine BLR
   samplers on a synthetic CSV of australian's shape (N=690, D=15), mMALA
   and RMHMC once more on one of german's shape (N=1000, D=25: K1's and
   K2's spilling D=25 instantiations end to end), and adaptive RMHMC (K1
   and K2 under a tensor step size).  Each run: finite samples of the
   right shape, acceptance in a window from RESULTS.md or the JAX
   package's tests, divergences, posterior means against the RMHMC run on
   the same data (z < 5 from exact-mode ESS), and K1 / K2 launch counts
   equal to the formulas the samplers' code gives; prints seconds per
   transition and min-ESS/s beside the nvidia-smi line.

It ends with the nvidia-smi line, one JSON line per kernel summary
(``{"kernels": [...]}``) and, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and the last line is not printed; so does a machine with
no CUDA device.

Phase 6 writes its CSVs under the git-ignored ``build/smoke_data`` and
points ``RHMC_DATA_DIR`` there, before the port is imported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SMOKE_DATA = Path(__file__).resolve().parent / "build" / "smoke_data"
os.environ["RHMC_DATA_DIR"] = str(SMOKE_DATA)  # read when the port's datasets module is imported

import torch  # noqa: E402

import riemannhamiltonianmontecarlo_tpu_torch as rt  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch import experiments  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch._precision import precision_flags  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.ops import _build  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.ops import hopper_linalg as hl  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.samplers import rmhmc  # noqa: E402

DEVICE = "cuda"
NUM_CHAINS = 4096
N_DATA, DIM = 690, 15  # australian's shape: 690 rows, 14 features + intercept
BURN_IN, NUM_SAMPLES = 100, 300
# Phase 5's plain-linalg comparison run is shorter than its kernel run: the
# plain path takes ~6x as long per transition, and phase 6 needs the time.
PLAIN_BURN_IN, PLAIN_SAMPLES = 100, 100
L, K = 6, 4  # reference constants (RMHMCConfig defaults)
# Tolerances of the kernels against their twins: those of the JAX package's
# Pallas tests (tests/test_pallas_linalg.py), |k - p| <= atol + rtol |p|.
TOL = {"L": (2e-4, 2e-4), "x": (2e-3, 2e-3), "logdet": (2e-4, 2e-3)}
ACCEPT_WINDOW = (0.85, 0.97)
MAX_DIVERGENT_FRACTION = 1e-4
MAX_RHAT = 1.05
Z_BOUND = 5.0  # posterior means, kernel run vs plain run, per coordinate
BOUNDARY_MARGIN = 1e-2  # |log a - log u| below this: accept decision too close to call
SOURCE = "riemannhamiltonianmontecarlo_tpu_torch/ops/csrc/hopper_linalg.cu"
REPLACES = {
    "cholesky": "riemannhamiltonianmontecarlo_tpu/ops/pallas_linalg.py:116",
    "chol_solve_logdet": "riemannhamiltonianmontecarlo_tpu/ops/pallas_linalg.py:150",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median over ``reps`` calls of the CUDA-event time of one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def spd_batch(c: int, d: int, seed: int):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    a = torch.randn((c, d, d), generator=gen, device=DEVICE)
    g = a @ a.mT + d * torch.eye(d, device=DEVICE)
    b = torch.randn((c, d), generator=gen, device=DEVICE)
    return g, b


def excess(k: torch.Tensor, p: torch.Tensor, tol) -> tuple[float, float]:
    """(max |k - p|, max of |k - p| - (atol + rtol |p|)), over finite entries of p."""
    rtol, atol = tol
    diff = (k - p).abs()
    return float(diff.max()), float((diff - (atol + rtol * p.abs())).max())


# -- phases --------------------------------------------------------------------


def phase_device() -> str:
    line = smi_line()
    print(line, flush=True)
    say("device", nvidia_smi=line, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        precision=precision_flags())
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    hl._lib()  # load and bind
    seconds = time.perf_counter() - t0
    log = (lib_path.parent / "ptxas.log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    stack = [int(s) for s in re.findall(r"(\d+) bytes stack frame", log)]
    check(regs, "ptxas report names no kernel")
    say("build", seconds=seconds, library=str(lib_path), kernels=len(regs),
        max_registers=max(regs), max_spill_store_bytes=max(spills, default=0),
        max_stack_frame_bytes=max(stack, default=0))


def phase_kernels(smi: str) -> dict:
    """K1 and K2 against their twins; returns per-kernel max |err| and times."""
    err = {"cholesky": 0.0, "chol_solve_logdet": 0.0}
    for d in (7, 10, 15, 25):
        for c in (NUM_CHAINS, NUM_CHAINS + 1):
            g, b = spd_batch(c, d, seed=1000 * d + c)
            bad = c // 2 + 1
            g[bad] = -torch.eye(d, device=DEVICE)  # not PD
            ok = torch.ones(c, dtype=torch.bool, device=DEVICE)
            ok[bad] = False

            lk, lp = hl.cholesky_cuda(g), hl.cholesky_plain(g)
            torch.cuda.synchronize()
            check(bool((torch.triu(lk, 1) == 0).all()), f"K1 upper triangle not exactly 0 (C={c}, D={d})")
            check(bool(torch.isfinite(lk[ok]).all()), f"K1 non-finite on a PD chain (C={c}, D={d})")
            check(not bool(torch.isfinite(lk[bad]).all()), f"K1 finite on the non-PD chain (C={c}, D={d})")
            e, over = excess(lk[ok], lp[ok], TOL["L"])
            check(over <= 0, f"K1 vs twin beyond tolerance at C={c}, D={d}: max |err| {e}")
            err["cholesky"] = max(err["cholesky"], e)

            (xk, ldk), (xp, ldp) = hl.chol_solve_logdet_cuda(g, b), hl.chol_solve_logdet_plain(g, b)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(xk[ok]).all() and torch.isfinite(ldk[ok]).all()),
                  f"K2 non-finite on a PD chain (C={c}, D={d})")
            check(not bool(torch.isfinite(xk[bad]).all()) and not bool(torch.isfinite(ldk[bad])),
                  f"K2 finite on the non-PD chain (C={c}, D={d})")
            ex, over_x = excess(xk[ok], xp[ok], TOL["x"])
            el, over_l = excess(ldk[ok], ldp[ok], TOL["logdet"])
            check(over_x <= 0 and over_l <= 0,
                  f"K2 vs twin beyond tolerance at C={c}, D={d}: max |err| x {ex}, logdet {el}")
            err["chol_solve_logdet"] = max(err["chol_solve_logdet"], ex, el)
    say("kernels", checked="C in (4096, 4097) x D in (7, 10, 15, 25), one non-PD chain each",
        max_abs_err=err, tolerance_rtol_atol=TOL)

    times = {}
    for d in (15, 25):
        g, b = spd_batch(NUM_CHAINS, d, seed=d)
        gt = g.permute(1, 2, 0).contiguous()
        lt = torch.empty_like(gt)
        times[d] = {
            "cholesky_ms": median_ms(lambda: hl.cholesky_cuda(g)),
            "cholesky_kernel_only_ms": median_ms(
                lambda: hl._launch("cholesky", hl._lib().rhmc_cholesky, (gt, lt), NUM_CHAINS, d)),
            "cholesky_plain_ms": median_ms(lambda: hl.cholesky_plain(g)),
            "chol_solve_logdet_ms": median_ms(lambda: hl.chol_solve_logdet_cuda(g, b)),
            "chol_solve_logdet_plain_ms": median_ms(lambda: hl.chol_solve_logdet_plain(g, b)),
        }
        say("kernel-times", C=NUM_CHAINS, D=d, card=smi, **times[d])
    return {"err": err, "times": times}


def blr_model():
    ds = rt.models.synthetic_logreg(seed=0, n=N_DATA, d=DIM)
    return rt.interop.logreg_from_numpy(ds.X, ds.t, device=DEVICE)


def phase_transition(model) -> None:
    """One transition through the kernels vs one through the plain linalg."""
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    position = rt.utils.default_init(model, gen, NUM_CHAINS)
    noise = rmhmc.draw_noise(gen, position)
    out = {}
    for name, method in (("kernel", None), ("plain", "unrolled")):
        kern = rmhmc.build(model, rmhmc.RMHMCConfig(linalg=method))
        out[name] = kern.transition(kern.init(position), noise)
    (sk, ik), (sp, ip) = out["kernel"], out["plain"]
    torch.cuda.synchronize()
    margin = (torch.log(ip.accept_prob) - torch.log(noise.u_acc)).abs()
    away = margin > BOUNDARY_MARGIN
    n_away = int(away.sum())
    check(n_away >= 0.9 * NUM_CHAINS, f"only {n_away} chains away from the accept boundary")
    check(bool((ik.accepted[away] == ip.accepted[away]).all()), "accept decisions differ")
    check(bool((ik.divergent[away] == ip.divergent[away]).all()), "divergence flags differ")
    pos_err = float((sk.position[away] - sp.position[away]).abs().max())
    logp_err = float((sk.logp[away] - sp.logp[away]).abs().max())
    ap_err = float((ik.accept_prob - ip.accept_prob).abs().max())
    check(pos_err <= 1e-3 and logp_err <= 1e-2 and ap_err <= 1e-3,
          f"transition kernel vs plain: position {pos_err}, logp {logp_err}, accept_prob {ap_err}")
    say("transition", chains=NUM_CHAINS, away_from_boundary=n_away,
        accept_rate=float(ik.accepted.float().mean()),
        max_abs_err={"position": pos_err, "logp": logp_err, "accept_prob": ap_err},
        tolerance={"position": 1e-3, "logp": 1e-2, "accept_prob": 1e-3})


def sample(model, method, seed: int, burn_in: int = BURN_IN, num_samples: int = NUM_SAMPLES) -> dict:
    """Burn-in, then a timed sampling run; returns the run's numbers and samples."""
    kern = rmhmc.build(model, rmhmc.RMHMCConfig(linalg=method))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    init = rt.utils.default_init(model, gen, NUM_CHAINS)
    torch.cuda.synchronize()
    warm = rt.parallel.run(kern, gen, init, num_samples=burn_in, collect=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rt.parallel.run(kern, gen, None, num_samples=num_samples, init_state=warm.final_state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    samples = res.samples.cpu().numpy()
    check(samples.shape == (NUM_CHAINS, num_samples, DIM) and np.isfinite(samples).all(),
          f"samples of shape {samples.shape}, finite: {bool(np.isfinite(samples).all())}")
    ess = rt.diagnostics.ess_multichain(samples)
    return {
        "samples": samples,
        "seconds": seconds,
        "accept": float(res.accept_rate),
        "divergent": int(warm.divergences) + int(res.divergences),
        "ess": ess,
        "ess_exact": rt.diagnostics.ess_multichain(samples, nfft_mode="exact"),
        "rhat": float(rt.diagnostics.split_rhat(samples).max()),
    }


def phase_main_path(model, smi: str) -> dict:
    steps = BURN_IN + NUM_SAMPLES
    hl.reset_launch_counts()
    kern = sample(model, None, seed=1)
    launches = hl.launch_counts()
    expected = {"cholesky": 1 + L * steps, "chol_solve_logdet": L * K * steps}
    check(launches == expected, f"launch counts {launches}, expected {expected}")
    lo, hi = ACCEPT_WINDOW
    check(lo <= kern["accept"] <= hi, f"acceptance {kern['accept']} outside {ACCEPT_WINDOW}")
    max_div = MAX_DIVERGENT_FRACTION * NUM_CHAINS * steps
    check(kern["divergent"] <= max_div, f"{kern['divergent']} divergences > {max_div}")
    check(kern["rhat"] < MAX_RHAT, f"max split R-hat {kern['rhat']} >= {MAX_RHAT}")

    plain = sample(model, "unrolled", seed=2, burn_in=PLAIN_BURN_IN, num_samples=PLAIN_SAMPLES)
    check(hl.launch_counts() == launches, "the plain-linalg run launched a kernel")
    for run in (kern, plain):
        s = run["samples"].reshape(-1, DIM)
        run["mean"], run["var"] = s.mean(0), s.var(0)
    se = np.sqrt(kern["var"] / kern["ess_exact"] + plain["var"] / plain["ess_exact"])
    z = np.abs(kern["mean"] - plain["mean"]) / se
    check(float(z.max()) < Z_BOUND, f"posterior means differ: max z {float(z.max())}")

    min_ess = float(kern["ess"].min())
    say("main-path", chains=NUM_CHAINS, burn_in=BURN_IN, samples=NUM_SAMPLES,
        launches=launches, accept_rate=kern["accept"], divergent=kern["divergent"],
        max_split_rhat=kern["rhat"], max_z_means_vs_plain=float(z.max()),
        plain_burn_in=PLAIN_BURN_IN, plain_samples=PLAIN_SAMPLES,
        plain_accept_rate=plain["accept"], plain_divergent=plain["divergent"])
    say("main-path-times", card=smi, sampling_s=kern["seconds"],
        s_per_transition=kern["seconds"] / NUM_SAMPLES, min_ess=min_ess,
        min_ess_per_s=min_ess / kern["seconds"],
        plain_sampling_s=plain["seconds"], plain_s_per_transition=plain["seconds"] / PLAIN_SAMPLES,
        plain_min_ess_per_s=float(plain["ess"].min()) / plain["seconds"])
    return launches


# -- phase 6: the other BLR samplers through the experiment entry point --------

# Acceptance windows: the min-max acceptance of the sampler over the five BLR
# tables of RESULTS.md (lines 114-206, reference presets), widened by 0.15 on
# each side, since the data here is synthetic; the adaptive run: the JAX
# package's own tolerance, |accept - 0.8| < 0.12 (tests/test_adaptation.py:34).
RESULTS_WINDOW = "RESULTS.md BLR tables, min-max over 5 datasets +- 0.15"
ACCEPT = {
    "metropolis": (0.183, 0.495),  # 0.333-0.345
    "hmc": (0.669, 1.0),  # 0.819-0.873
    "mala": (0.465, 0.838),  # 0.615-0.688
    "mmala": (0.255, 0.843),  # 0.405-0.693
    "mmala_simplified": (0.202, 0.819),  # 0.352-0.669
    "iwls": (0.103, 0.881),  # 0.253-0.731
    "gibbs": (1.0, 1.0),  # 1.000 (every sweep is taken)
    "rmhmc": (0.708, 1.0),  # 0.858-0.949
    "rmhmc_studentt": (0.781, 1.0),  # 0.931-0.972
}
SHAPES = {"australian": (690, 15, 0), "german": (1000, 25, 1)}  # (N, D, synthetic seed)


@dataclasses.dataclass(frozen=True)
class BlrRun:
    sampler: str
    dataset: str = "australian"
    chains: int = NUM_CHAINS
    burn_in: int = 100
    samples: int = 200
    adapt: bool = False

    @property
    def label(self) -> str:
        return f"{self.sampler}{'-adapt' if self.adapt else ''}/{self.dataset}"

    @property
    def steps(self) -> int:
        """Transitions run_experiment takes: burn-in and two half-scans."""
        return self.burn_in + 2 * (self.samples // 2)

    def expected_launches(self) -> dict:
        """K1 / K2 launches, read from the samplers' code (init + per step)."""
        k1, k2 = 0, 0
        if self.sampler in ("mmala", "mmala_simplified", "iwls"):
            k1 = 1 + self.steps  # one factorization in init, one per proposal
        elif self.sampler == "gibbs":
            k1 = 2 * self.steps  # ops.inv_psd and chol(V), no factorization in init
        elif self.sampler in ("rmhmc", "rmhmc_studentt"):
            k1, k2 = 1 + L * self.steps, L * K * self.steps  # as phase 5
        return {"cholesky": k1, "chol_solve_logdet": k2}


# Burn-in lengths: enough for the slow mixers (component-wise AMH adapts its
# SDs every 100 sweeps; MALA's steps are small) to forget the MAP + jitter
# start, so the means can be held against RMHMC's.  Gibbs at 1024 chains.
BLR_RUNS = (
    BlrRun("rmhmc"),
    BlrRun("rmhmc_studentt"),
    BlrRun("metropolis", burn_in=3000),
    BlrRun("hmc"),
    BlrRun("mala", burn_in=2000),
    BlrRun("mmala", burn_in=300),
    BlrRun("mmala_simplified", burn_in=300),
    BlrRun("iwls", burn_in=300),
    BlrRun("gibbs", chains=1024, burn_in=200, samples=100),
    BlrRun("rmhmc", adapt=True),
    BlrRun("rmhmc", dataset="german"),
    BlrRun("mmala", dataset="german", burn_in=300),
)


def write_smoke_csvs() -> None:
    """Synthetic CSVs in the datasets' own layout: features, then the label
    (0/1 for australian, 1/2 for german)."""
    SMOKE_DATA.mkdir(parents=True, exist_ok=True)
    for name, (n, d, seed) in SHAPES.items():
        ds = rt.models.synthetic_logreg(seed=seed, n=n, d=d)
        _, one_two, _ = rt.models.datasets.DATASET_SPECS[name]
        label = ds.t + 1.0 if one_two else ds.t
        np.savetxt(SMOKE_DATA / f"{name}.csv", np.column_stack([ds.X[:, 1:], label]), delimiter=",")


def exact_ess(samples: np.ndarray) -> tuple[np.ndarray, int]:
    """Exact-mode Geyer ESS summed over chains, and the number of chains
    whose series stood still (no ESS defined: they add none)."""
    c, s, d = samples.shape
    with np.errstate(invalid="ignore", divide="ignore"):
        per = rt.diagnostics.ess_geyer(np.moveaxis(samples, 1, 0).reshape(s, c * d), nfft_mode="exact").reshape(c, d)
    return np.nansum(per, axis=0), int(np.isnan(per).any(axis=1).sum())


def phase_blr_samplers(smi: str) -> dict:
    write_smoke_csvs()
    refs, launches_by_path = {}, {}
    for run in BLR_RUNS:
        n, d, _ = SHAPES[run.dataset]
        hl.reset_launch_counts()
        res = experiments.run_experiment(
            run.sampler, run.dataset, device=DEVICE, num_chains=run.chains, num_samples=run.samples,
            burn_in=run.burn_in, seed=7, adapt=run.adapt, keep_samples=True,
        )
        launches = hl.launch_counts()
        expected = run.expected_launches()
        check(launches == expected, f"{run.label}: launch counts {launches}, expected {expected}")
        launches_by_path[run.label] = launches

        samples = res.samples
        check(samples.shape == (run.chains, run.samples, d) and np.isfinite(samples).all(),
              f"{run.label}: samples of shape {samples.shape}, finite: {bool(np.isfinite(samples).all())}")
        lo, hi = (0.68, 0.92) if run.adapt else ACCEPT[run.sampler]
        source = "tests/test_adaptation.py:34, |accept - 0.8| < 0.12" if run.adapt else RESULTS_WINDOW
        check(lo <= res.accept_rate <= hi, f"{run.label}: acceptance {res.accept_rate} outside ({lo}, {hi}), {source}")
        max_div = MAX_DIVERGENT_FRACTION * run.chains * run.samples
        check(res.divergences <= max_div, f"{run.label}: {res.divergences} divergences > {max_div}")

        flat = samples.reshape(-1, d)
        ess, still = exact_ess(samples)
        here = {"mean": flat.mean(0), "var": flat.var(0), "ess": ess}
        ref_label = f"rmhmc/{run.dataset}"
        if run.label == ref_label:
            refs[run.dataset] = here
            z_max = 0.0
        else:
            ref = refs[run.dataset]
            z = np.abs(here["mean"] - ref["mean"]) / np.sqrt(here["var"] / here["ess"] + ref["var"] / ref["ess"])
            z_max = float(z.max())
            check(z_max < Z_BOUND, f"{run.label}: posterior means differ from {ref_label}: max z {z_max}")

        per_transition = res.sampling_time_s / (2 * (run.samples // 2))
        say("blr-samplers", run=run.label, N=n, D=d, chains=run.chains, burn_in=run.burn_in,
            samples=run.samples, accept_rate=res.accept_rate, accept_window=[lo, hi], accept_source=source,
            divergent=res.divergences, max_z_means_vs=[ref_label, z_max], chains_standing_still=still,
            adapted_step_size=res.adapted_step_size, max_split_rhat=res.rhat_max, launches=launches)
        # min_ess: run_experiment's own (reference nFFT; NaN when a chain stood
        # still); min_ess_exact: exact nFFT, still chains adding no ESS.
        say("blr-samplers-times", run=run.label, card=smi, s_per_transition=per_transition,
            min_ess=res.ess_min, min_ess_per_s=res.ess_min / res.sampling_time_s,
            min_ess_exact=float(ess.min()), min_ess_exact_per_s=float(ess.min()) / res.sampling_time_s,
            sampling_s=res.sampling_time_s)
    return launches_by_path


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    seconds, t0 = {}, time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    with torch.inference_mode():
        smi = phase_device()
        phase_build()
        lap("device+build")
        kernels = phase_kernels(smi)
        lap("kernels")
        model = blr_model()
        phase_transition(model)
        lap("transition")
        launches = phase_main_path(model, smi)
        lap("main-path")
        by_path = phase_blr_samplers(smi)
        lap("blr-samplers")
    say("phase-seconds", **seconds)

    t15 = kernels["times"][15]
    summary = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": kernels["err"][name],
         "ms": t15[f"{name}_ms"], "plain_ms": t15[f"{name}_plain_ms"],
         "launches_by_path": {"rmhmc-main-path": launches[name],
                              **{label: counts[name] for label, counts in by_path.items()}}}
        for name in ("cholesky", "chol_solve_logdet")
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
