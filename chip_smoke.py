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
   seconds per transition and min-ESS/s.

It ends with the nvidia-smi line, one JSON line per kernel summary
(``{"kernels": [...]}``) and, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and the last line is not printed; so does a machine with
no CUDA device.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import riemannhamiltonianmontecarlo_tpu_torch as rt
from riemannhamiltonianmontecarlo_tpu_torch._precision import precision_flags
from riemannhamiltonianmontecarlo_tpu_torch.ops import _build
from riemannhamiltonianmontecarlo_tpu_torch.ops import hopper_linalg as hl
from riemannhamiltonianmontecarlo_tpu_torch.samplers import rmhmc

DEVICE = "cuda"
NUM_CHAINS = 4096
N_DATA, DIM = 690, 15  # australian's shape: 690 rows, 14 features + intercept
BURN_IN, NUM_SAMPLES = 100, 300
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


def sample(model, method, seed: int) -> dict:
    """Burn-in, then a timed sampling run; returns the run's numbers and samples."""
    kern = rmhmc.build(model, rmhmc.RMHMCConfig(linalg=method))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    init = rt.utils.default_init(model, gen, NUM_CHAINS)
    torch.cuda.synchronize()
    warm = rt.parallel.run(kern, gen, init, num_samples=BURN_IN, collect=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rt.parallel.run(kern, gen, None, num_samples=NUM_SAMPLES, init_state=warm.final_state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    samples = res.samples.cpu().numpy()
    check(samples.shape == (NUM_CHAINS, NUM_SAMPLES, DIM) and np.isfinite(samples).all(),
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

    plain = sample(model, "unrolled", seed=2)
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
        plain_accept_rate=plain["accept"], plain_divergent=plain["divergent"])
    say("main-path-times", card=smi, sampling_s=kern["seconds"],
        s_per_transition=kern["seconds"] / NUM_SAMPLES, min_ess=min_ess,
        min_ess_per_s=min_ess / kern["seconds"],
        plain_sampling_s=plain["seconds"], plain_s_per_transition=plain["seconds"] / NUM_SAMPLES,
        plain_min_ess_per_s=float(plain["ess"].min()) / plain["seconds"])
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    with torch.inference_mode():
        smi = phase_device()
        phase_build()
        kernels = phase_kernels(smi)
        model = blr_model()
        phase_transition(model)
        launches = phase_main_path(model, smi)

    t15 = kernels["times"][15]
    summary = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": kernels["err"][name],
         "ms": t15[f"{name}_ms"], "plain_ms": t15[f"{name}_plain_ms"]}
        for name in ("cholesky", "chol_solve_logdet")
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
