#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It imports no jax.  Phases, each printing one line of findings:

1. device: the card's name and power limit (nvidia-smi), torch / CUDA
   versions, the fp32 precision flags;
2. build: compiles ``ops/csrc/*.cu`` with nvcc (cached by source hash under
   the git-ignored ``build/``; one nvcc per source, all started together),
   prints the build seconds and the ptxas register / spill report (K1 / K2
   per width, the FHN kernel per order), and holds ``hopper_linalg.launch_geometry``
   (lanes per chain, chains per block, shared-memory tile) against the
   built library's own answer for every width 1..48;
3. kernels: K1 (Cholesky) and K2 (fused solve + log-det) against their
   plain-PyTorch twins on the card, on seeded SPD batches at
   C in {4096, 4097} and D in {3, 7, 10, 15, 25}, at StochVol's
   C = 1024, D = 3, FHN's C = 256, D = 3 and at the joint LGC hyper block's (C, D) = (4, 2) and
   (4097, 2) (2 and 10 take the kernels' runtime-width instantiation, the
   others a compile-time width): tolerance, exact-zero upper triangle, and
   non-PD chains (the first, a middle and the last chain of a block, and
   the batch's last chain) giving non-finite output in those chains only;
   an operand that is not 16-byte aligned and one that is not contiguous
   give the same bits as the aligned contiguous one.  Then, at
   (C, D) = (4096, 15), (4096, 25), (4096, 3), (1024, 3), (256, 3) and (4, 2), for
   each kernel: the wrapper's time (``ms``: median CUDA-event time of one call;
   ``burst_ms``: 200 calls back to back over the count), the launch alone
   on allocated outputs (``kernel_only_ms``, 200 back to back), the
   device's own kernel duration by kernel name from torch.profiler over 50
   launches (``device_us``), the twin's time, the least time the card could
   take (``bound_us``, bytes read once and written once at 3.35 TB/s
   against the operations at 67 TFLOP/s fp32) and the share of it reached,
   and a library yardstick the port never calls on these shapes:
   ``torch.linalg.cholesky_ex`` for K1 (``library_ms``), and for K2, which
   no one call computes, the sequence cholesky_ex, cholesky_solve, log of
   the diagonal (``library_seq_ms``: a sequence, for information only).
   Then the FitzHugh-Nagumo sensitivity kernel (``ops/csrc/fhn_sens.cu``)
   against its plain twin at (C, num_obs, substeps) = (256, 200, 5) and
   (257, 200, 5), orders 0, 1 and 2, on seeded theta around the truth with
   one chain outside the support and one whose trajectory overflows: each
   output within 1e-4 of its largest finite entry, the same non-finite
   entries, logp -inf and a zero gradient in both special chains, the other
   chains' outputs bit for bit those of a batch without the special ones;
   per order its device time beside its bound and the twin's time; then K1
   and K2 against their twins on the metrics it returns at 256 chains (the
   matrices the FHN samplers factor).  A timed kernel that torch.profiler
   does not see fails the run;
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
   transition and min-ESS/s beside the nvidia-smi line;
7. stochvol: ``experiments.run_workload("stochvol", m, device="cuda")`` for
   m in {rmhmc, hmc, mala, mmala} at T = 2000 latents and 1024 chains (the
   hyper block runs K1 / K2 at D = 3): finite hyper and latent samples of
   the right shapes, acceptance in a window around the JAX package's at the
   same constants, depth, seed and data (measured on the CPU, PERF.md),
   divergences (no gate for hmc, whose reference rate is ~0.7%), hyper
   means against the JAX package's at the same depth from the same start
   (z < 5 over the chain means; only RMHMC has mixed at these depths) and
   RMHMC's inside the boxes of tests/test_stochvol.py:77-79, and K1 / K2
   launch counts equal to the formulas;
8. lgc: ``run_workload("lgc", s, device="cuda")`` on the 64 x 64 grid
   (D = 4096) for constant-metric RMHMC (phmc, 64 chains), the
   position-dependent mMALA (8 chains, a (C, 4096, 4096) metric per step)
   and whitened MALA transient / stationary (16 chains), and
   ``samplers.pmala`` on the model's constant metric (64 chains): finite
   samples, acceptance against the JAX package's on the same generated
   data, and the phmc and pmala posterior-mean fields within z < 5 of each
   other; phmc's acceptance with ``trajectory_precision="default"`` (TF32 in
   the trajectory) is printed without a gate;
9. lgc-joint: ``run_workload("lgc", "rmhmc_joint" | "mmala_joint",
   device="cuda")`` on the 64 x 64 grid (D = 4096 latents + 2
   hyperparameters, 4 chains; the hyper block's (4, 2, 2) metric runs K1,
   and under RMHMC K2): positive finite hyper samples, finite latent
   samples, K1 / K2 launch counts equal to the formulas, sweep-level
   acceptance within 0.12 of RESULTS.md:258-261 (another data set), no
   divergences; then the same two samplers at n = 32 (D = 1024, 16 chains) against the
   JAX package's acceptance (within 0.05) and hyper chain means (z < 5) at
   the same constants, depth, seed and generated data (``LGCJ_JAX``,
   measured on the CPU by ``tests/reference_workload_jax.py``); then
   ``parallel.run_checkpointed`` on ``rmhmc_joint`` at n = 32, stopped after
   one segment and resumed, against the run that was not stopped, bit for
   bit, its files under ``build/``.  Seconds per sweep, min-ESS/s and the
   peak of allocated device memory are printed without a gate;
10. fhn: ``run_workload("fhn", m, device="cuda")`` at 200 x 5 and 256 chains
   for the six samplers: finite samples, FHN-kernel launches by order and
   K1 / K2 launches equal to the formulas, acceptance within 0.05 of the JAX
   package's at the same constants, depth, seed and data and chain means
   within z < 5 of its (``FHN_JAX``, measured on the CPU by
   ``tests/reference_workload_jax.py``); divergences and ``RESULTS.md``'s
   acceptance printed beside them, without a gate;
11. distributed: the parallel layer on ``torch.distributed``.  In this
   process, a process group of one rank over NCCL (a TCP store on a free
   local port, torn down at the end): BLR RMHMC at full width (4096 chains,
   20 + 20) through ``parallel.run(..., mesh=)`` on a ("chains", "data")
   mesh of shape (1, 1) with the model from ``with_sharding``, and LGC phmc
   at D = 4096 (64 chains, 20 + 20) on a ("chains", "latent") mesh, each
   ``torch.equal`` to the same run without a mesh, with K1 / K2 launch
   counts equal to the formulas, and the host's time by op (torch.profiler)
   of two BLR transitions with and without the mesh; ``run_checkpointed``
   with the mesh stopped after one segment and resumed, bit for bit, its
   files without a ``.p`` suffix; ``run_experiment("rmhmc",
   ess_mode="native", mesh=)`` on phase 6's CSV, its min-ESS equal to the
   exact-mode ESS of its samples to 1e-10.  Then two ranks sharing the card
   over Gloo on CUDA tensors (``parallel.launch.spawn``, plain subprocesses
   with a timeout): BLR RMHMC at full width, 10 + 10, chains split (2, 1)
   and rows split (1, 2).  Under the chain split each rank is bit for bit
   one process running that rank's half of the chains (the same noise, the
   same batch size); under the row split the ranks' positions are
   bit-identical.  Both against the one-process run of all chains: every
   chain takes the same accept decisions with positions within 1e-5 abs /
   1e-5 rel, except that a chain whose decisions came within 1e-3 of the
   boundary may part (counted); the largest ratio of a difference to its
   tolerance is printed, with which ops of a transition give other bits at
   half the rows.  K1 / K2 launch counts per rank equal the formulas; the
   checkpoint shards ``.p0`` / ``.p1`` round-trip.  Seconds per transition
   (world 1 against no mesh, two ranks) and all-reduces per transition are
   printed beside the card, without a gate.

It ends with the nvidia-smi line, one JSON line per kernel summary
(``{"kernels": [...]}``) and, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and the last line is not printed; so does a machine with
no CUDA device.

Phase 6 writes its CSVs under the git-ignored ``build/smoke_data`` and
points ``RHMC_DATA_DIR`` there, before the port is imported; phase 11 writes
under ``build/smoke_dist``.  ``--phases distributed`` (a comma-separated subset of
the phases' names, ``PHASES``) runs the device and build phases and that
subset alone, and prints no result lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path
from typing import NamedTuple

import numpy as np

SMOKE_DATA = Path(__file__).resolve().parent / "build" / "smoke_data"
os.environ["RHMC_DATA_DIR"] = str(SMOKE_DATA)  # read when the port's datasets module is imported

import torch  # noqa: E402

import torch.distributed as dist  # noqa: E402

import riemannhamiltonianmontecarlo_tpu_torch as rt  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch import experiments  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch._precision import precision_flags  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.ops import _build  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.ops import hopper_linalg as hl  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.parallel.launch import free_port, spawn  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.parallel.mesh import CHAIN_AXIS  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.samplers import pmala, rmhmc  # noqa: E402

DEVICE = "cuda"
NUM_CHAINS = 4096
N_DATA, DIM = 690, 15  # australian's shape: 690 rows, 14 features + intercept
BURN_IN, NUM_SAMPLES = 100, 300
# Phase 5's plain-linalg comparison run is shorter than its kernel run: the
# plain path takes ~6x as long per transition, and phase 6 needs the time.
PLAIN_BURN_IN, PLAIN_SAMPLES = 50, 50
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


def burst_ms(fn, launches: int = 200, warmup: int = 10) -> float:
    """One CUDA-event pair around ``launches`` calls back to back, over the count."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def device_us(fn, launches: int = 50, name_part: str | None = None, sessions: int = 4) -> dict:
    """The device's own time per call of ``fn``, from torch.profiler over
    ``launches`` calls: the summed duration of the device events whose name
    holds ``name_part`` (every device event when None), and how many such
    events one call makes (rounded: the profiler now and then drops an event,
    so the time is the mean event's times that count).  Now and then a
    profiler session of a long process records no device event at all: such
    a session is run again, up to ``sessions`` in all, and how many it took
    is returned.  A profile without the named kernel fails the run."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
    spans = [e.time_range.elapsed_us() for e in device if name_part is None or name_part in e.name]
    check(spans, f"torch.profiler recorded no device event named {name_part!r} over {launches} calls in "
                 f"{session} sessions ({len(device)} device events: {sorted({e.name for e in device})[:5]})")
    per_call = max(1, round(len(spans) / launches))
    return {"us": per_call * sum(spans) / len(spans), "events_per_call": per_call, "source": "torch.profiler",
            "sessions": session}


# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# bytes per second, and float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_us(name: str, c: int, d: int) -> tuple[float, str]:
    """The least microseconds the card could take for kernel ``name`` on a
    (C, D, D) float32 batch, and which side gives it.  Bytes: each input read
    once, each output written once (K1: G in, L out; K2: G and b in, x and
    log|G| out).  Operations: ~D^3/3 for the factor, 2 D^2 more for K2's two
    substitutions, per chain."""
    floats = {"cholesky": 2 * c * d * d, "chol_solve_logdet": c * d * d + 2 * c * d + c}[name]
    ops = c * d**3 / 3 + (2 * c * d * d if name == "chol_solve_logdet" else 0)
    by_bytes, by_ops = 1e6 * 4 * floats / HBM_BYTES_PER_S, 1e6 * ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


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
    # Registers per kernel and width, from the mangled names: K1 / K2, the rows
    # the instantiation is unrolled for, "rt" where the width comes at run time.
    per_kernel = {
        f"{'K1' if name == 'cholesky_kernel' else 'K2'}<{n}{'' if exact == '1' else ',rt'}>": int(r)
        for name, n, exact, r in re.findall(
            r"(cholesky_kernel|chol_solve_logdet_kernel)INS_5WidthILi(\d+)ELb([01])E.*?Used (\d+) registers", log, re.S)
    }
    # The FHN kernel per order: registers and spill stores (none expected).
    fhn = {f"fhn<{order}>": {"registers": int(r), "spill_store_bytes": int(sp)}
           for order, sp, r in re.findall(rf"{FHN_KERNEL_NAME}ILi(\d)E.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                                          log, re.S)}
    check(sorted(fhn) == [f"fhn<{o}>" for o in rt.ops.fhn_sens.ORDERS], f"ptxas report names FHN kernels {sorted(fhn)}")
    for d in range(1, hl.MAX_DIM + 1):
        mirror, built = hl.launch_geometry(d), hl.built_launch_geometry(d)
        check(mirror == built, f"launch geometry at D={d}: Python mirror {mirror}, built library {built}")
    say("build", seconds=seconds, library=str(lib_path), kernels=len(regs),
        max_registers=max(regs), max_spill_store_bytes=max(spills, default=0),
        max_stack_frame_bytes=max(stack, default=0), registers=per_kernel, fhn_kernel=fhn,
        geometry={d: tuple(hl.launch_geometry(d)) for d in (3, 10, 15, 25, 48)})


# Device kernels by the name torch.profiler shows them under.
KERNEL_NAMES = {"cholesky": "cholesky_kernel", "chol_solve_logdet": "chol_solve_logdet_kernel"}
# BLR australian, german; StochVol hyper; FHN; joint LGC hyper
TIMED_SHAPES = ((NUM_CHAINS, 15), (NUM_CHAINS, 25), (NUM_CHAINS, 3), (1024, 3), (256, 3), (4, 2))


def non_pd_chains(c: int, d: int) -> list[int]:
    """Chains to spoil: the first chain of a block, the middle of the next,
    the last of the one after (blocks near C/2), and the batch's last chain;
    one middle chain where the batch is smaller than that."""
    per_block = hl.launch_geometry(d).chains_per_block
    if c < 8 * per_block:
        return [c // 2]
    block = (c // 2) // per_block
    return [block * per_block, (block + 1) * per_block + per_block // 2, (block + 3) * per_block - 1, c - 1]


def check_kernels(c: int, d: int, err: dict) -> None:
    """K1 and K2 against their twins on one seeded batch with non-PD chains in it."""
    g, b = spd_batch(c, d, seed=1000 * d + c)
    bad = non_pd_chains(c, d)
    g[bad] = -torch.eye(d, device=DEVICE)  # not PD
    ok = torch.ones(c, dtype=torch.bool, device=DEVICE)
    ok[bad] = False
    at = f"(C={c}, D={d})"

    lk, lp = hl.cholesky_cuda(g), hl.cholesky_plain(g)
    torch.cuda.synchronize()
    check(lk.is_contiguous() and lk.shape == g.shape, f"K1 result not a contiguous (C, D, D) {at}")
    check(bool((torch.triu(lk, 1) == 0).all()), f"K1 upper triangle not exactly 0 {at}")
    check(bool(torch.isfinite(lk[ok]).all()), f"K1 non-finite on a PD chain {at}")
    check(not bool(torch.isfinite(lk[bad]).flatten(1).all(1).any()), f"K1 finite on a non-PD chain {at}")
    e, over = excess(lk[ok], lp[ok], TOL["L"])
    check(over <= 0, f"K1 vs twin beyond tolerance at {at}: max |err| {e}")
    err["cholesky"] = max(err["cholesky"], e)

    # x: the back substitution subtracts in descending k where the twin sums in
    # ascending k, and log|G| is a butterfly sum: TOL allows for the rounding.
    (xk, ldk), (xp, ldp) = hl.chol_solve_logdet_cuda(g, b), hl.chol_solve_logdet_plain(g, b)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(xk[ok]).all() and torch.isfinite(ldk[ok]).all()), f"K2 non-finite on a PD chain {at}")
    check(not bool(torch.isfinite(xk[bad]).all(1).any()) and not bool(torch.isfinite(ldk[bad]).any()),
          f"K2 finite on a non-PD chain {at}")
    ex, over_x = excess(xk[ok], xp[ok], TOL["x"])
    el, over_l = excess(ldk[ok], ldp[ok], TOL["logdet"])
    check(over_x <= 0 and over_l <= 0, f"K2 vs twin beyond tolerance at {at}: max |err| x {ex}, logdet {el}")
    err["chol_solve_logdet"] = max(err["chol_solve_logdet"], ex, el)


def check_operand_forms(c: int, d: int) -> None:
    """An operand off 16-byte alignment (the kernels' 4-byte copy path) and a
    strided one (the wrapper's one copy) give the bits of the plain call."""
    g, b = spd_batch(c, d, seed=77)
    l0, (x0, ld0) = hl.cholesky_cuda(g), hl.chol_solve_logdet_cuda(g, b)
    flat = torch.empty(g.numel() + 1, device=DEVICE)
    shifted = flat[1:].view_as(g).copy_(g)
    check(shifted.data_ptr() % 16 != 0 and shifted.is_contiguous(), "the shifted operand is 16-byte aligned")
    wide = torch.zeros((c, d + 1, d + 2), device=DEVICE)
    wide[:, :d, :d] = g
    strided = wide[:, :d, :d]
    check(not strided.is_contiguous(), "the strided operand is contiguous")
    for form, gf in (("unaligned", shifted), ("strided", strided)):
        lf, (xf, ldf) = hl.cholesky_cuda(gf), hl.chol_solve_logdet_cuda(gf, b)
        torch.cuda.synchronize()
        check(torch.equal(lf, l0) and torch.equal(xf, x0) and torch.equal(ldf, ld0),
              f"{form} operand at C={c}, D={d}: result differs from the aligned contiguous one")


def library_cholesky(g):
    return torch.linalg.cholesky_ex(g)[0]


def library_solve_logdet_sequence(g, b):
    l = torch.linalg.cholesky_ex(g)[0]
    x = torch.cholesky_solve(b[..., None], l)[..., 0]
    return x, 2.0 * torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)


def time_kernels(c: int, d: int) -> dict:
    """Both kernels' times at one shape, beside twin, bound and library yardstick."""
    g, b = spd_batch(c, d, seed=d)
    l, x, logdet = torch.empty_like(g), torch.empty_like(b), torch.empty(c, device=DEVICE)
    lib = hl._lib()
    calls = {
        "cholesky": (lambda: hl.cholesky_cuda(g), lambda: hl.cholesky_plain(g),
                     lambda: hl._launch("cholesky", lib.rhmc_cholesky, (g, l), c, d),
                     "library_ms", lambda: library_cholesky(g)),
        "chol_solve_logdet": (lambda: hl.chol_solve_logdet_cuda(g, b), lambda: hl.chol_solve_logdet_plain(g, b),
                              lambda: hl._launch("chol_solve_logdet", lib.rhmc_chol_solve_logdet,
                                                 (g, b, x, logdet), c, d),
                              "library_seq_ms", lambda: library_solve_logdet_sequence(g, b)),
    }
    out = {}
    for name, (wrapper, plain, launch, library_key, library) in calls.items():
        dev = device_us(launch, name_part=KERNEL_NAMES[name])
        check(dev["events_per_call"] == 1, f"{name}: {dev['events_per_call']} device kernels per launch")
        lib_dev = device_us(library)
        bound, bound_by = bound_us(name, c, d)
        out[name] = {
            "ms": median_ms(wrapper), "burst_ms": burst_ms(wrapper), "kernel_only_ms": burst_ms(launch),
            "device_us": dev["us"], "device_us_source": dev["source"], "profiler_sessions": dev["sessions"],
            "plain_ms": median_ms(plain),
            "bound_us": bound, "bound_by": bound_by, "share_of_bound": bound / dev["us"],
            library_key: median_ms(library), "library_device_us": lib_dev["us"],
            "library_device_kernels_per_call": lib_dev["events_per_call"],
        }
    out["chol_solve_logdet"]["library_seq_note"] = "sequence of three library calls, information only"
    return out


def phase_kernels(smi: str) -> dict:
    """K1 and K2 against their twins; returns per-kernel max |err| and times."""
    err = {"cholesky": 0.0, "chol_solve_logdet": 0.0}
    shapes = [(c, d) for d in (3, 7, 10, 15, 25) for c in (NUM_CHAINS, NUM_CHAINS + 1)] + [(SV_CHAINS, 3), (FHN_CHAINS, 3)]
    shapes += [(LGCJ_CHAINS, 2), (NUM_CHAINS + 1, 2)]  # the joint LGC hyper block's width
    for c, d in shapes + [(NUM_CHAINS + 1, 40)]:  # 40: two rows a lane
        check_kernels(c, d, err)
    for c, d in ((NUM_CHAINS + 1, 15), (NUM_CHAINS, 8), (NUM_CHAINS + 1, 40)):
        check_operand_forms(c, d)
    say("kernels", checked="C in (4096, 4097) x D in (3, 7, 10, 15, 25), C in (1024, 256) x D=3, C in (4, 4097) x D=2 and C=4097 x D=40, "
        "four non-PD chains each (first, middle, last of a block; last of the batch; one of the 4 at C=4); unaligned and strided operands at D in (15, 8, 40)",
        max_abs_err=err, tolerance_rtol_atol=TOL)

    times = {}
    for c, d in TIMED_SHAPES:
        times[c, d] = time_kernels(c, d)
        for name, row in times[c, d].items():
            say("kernel-times", kernel=name, C=c, D=d, card=smi, **row)
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


def blr_expected_launches(steps: int) -> dict:
    """K1 / K2 launches of a BLR RMHMC run of ``steps`` steps: one geometry at
    init and after each leapfrog step, one solve a position fixed-point round."""
    return {"cholesky": 1 + L * steps, "chol_solve_logdet": L * K * steps}


def phase_main_path(model, smi: str) -> dict:
    steps = BURN_IN + NUM_SAMPLES
    hl.reset_launch_counts()
    kern = sample(model, None, seed=1)
    launches = hl.launch_counts()
    expected = blr_expected_launches(steps)
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
    samples: int = 100
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
# start, so the means can be held against RMHMC's.  Gibbs at 1024 chains: it
# needs its 200 sweeps (at 100 its means sat z = 12 from RMHMC's).  Samples:
# 100, Gibbs 50 (200 / 100 until the whole script neared its time limit):
# fewer samples only widen the z gate's standard error.
BLR_RUNS = (
    BlrRun("rmhmc"),
    BlrRun("rmhmc_studentt"),
    BlrRun("metropolis", burn_in=3000),
    BlrRun("hmc"),
    BlrRun("mala", burn_in=2000),
    BlrRun("mmala", burn_in=300),
    BlrRun("mmala_simplified", burn_in=300),
    BlrRun("iwls", burn_in=300),
    BlrRun("gibbs", chains=1024, burn_in=200, samples=50),
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


# -- phase 7: stochastic volatility through the workload entry point -----------

SV_CHAINS, SV_OBS, SV_SEED = 1024, 2000, 0
# (burn-in, samples) per method: the reference's 20000 samples cut to a smoke run.
# hmc's sweep is ~1-1.4 s (100 hyper leapfrog steps, each a torch.func
# gradient).  rmhmc, hmc and mmala ran 100 + 100, 30 + 30 and 200 + 200, then
# rmhmc 60 + 60 and mmala 120 + 120, until the joint LGC and FHN phases needed
# their seconds: the whole script keeps its time.
SV_RUNS = {"rmhmc": (40, 40), "hmc": (20, 20), "mmala": (80, 80), "mala": (500, 200)}
# The JAX package at the same constants, depth, seed and data, on the CPU with
# 64 chains (tests/reference_workload_jax.py --workload stochvol --chains 64
# at each depth; mala as first measured, PERF.md): acceptance, and the mean and
# sd over chains of the per-chain hyper means (beta, sigma, phi).
SV_JAX_CHAINS = 64
SV_JAX = {
    "rmhmc": {"accept": 0.97919, "mean": [0.57688, 0.39101, 0.90810], "sd": [0.022739, 0.076522, 0.033959]},
    "hmc": {"accept": 0.76414, "mean": [0.55987, 0.62500, 0.77352], "sd": [0.037463, 0.22994, 0.12187]},
    "mmala": {"accept": 0.87643, "mean": [0.61066, 0.60137, 0.28221], "sd": [0.0071586, 0.026313, 0.083836]},
    "mala": {"accept": 0.81891, "mean": [0.63407, 0.54942, 0.11832], "sd": [0.0061821, 0.016158, 0.049598]},
}
ACCEPT_TOL = 0.05  # |accept - JAX accept|
SV_BOXES = ((0.4, 0.95), (0.03, 0.45), (0.55, 1.0))  # (beta, sigma, phi), tests/test_stochvol.py:77-79
HYPER_L = rt.samplers.stochvol.StochVolConfig().hyper_num_leapfrog  # 6, the rmhmc preset's
HYPER_FP = rt.samplers.stochvol.StochVolConfig().hyper_num_fixed_point  # 5


def sv_expected_launches(method: str, sweeps: int) -> dict:
    """K1 / K2 launches of a stochvol run, read from the code: the hyper kernel
    is rebuilt every sweep; RMHMC builds the geometry at the start and after
    each leapfrog step (K1) and solves once per position fixed-point round
    (K2); mMALA factors in ``init`` and at the proposal (K1)."""
    if method == "rmhmc":
        return {"cholesky": (1 + HYPER_L) * sweeps, "chol_solve_logdet": HYPER_L * HYPER_FP * sweeps}
    if method == "mmala":
        return {"cholesky": 2 * sweeps, "chol_solve_logdet": 0}
    return {"cholesky": 0, "chol_solve_logdet": 0}


def chain_mean_z(a: np.ndarray, b_mean, b_sd, b_chains: int) -> np.ndarray:
    """|mean(a) - b| over the standard error of both, from the spread of per-chain means."""
    cm = a.mean(axis=1)
    se2 = cm.var(axis=0, ddof=1) / cm.shape[0] + np.asarray(b_sd) ** 2 / b_chains
    return np.abs(cm.mean(axis=0) - np.asarray(b_mean)) / np.sqrt(se2)


def check_hyper_autodiff() -> None:
    """The hyper block's torch.func gradient and dG under inference mode, as
    the runner calls them, against central differences of ``hyper_logp`` and
    ``hyper_metric`` in float64 (torch 2.11 returned zeros there unguarded)."""
    y, _ = rt.models.stochvol.generate_data(seed=SV_SEED, num_obs=SV_OBS)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    c = 16
    theta = torch.tensor([0.6, np.log(0.2), np.arctanh(0.95)], device=DEVICE) + 0.05 * torch.randn(
        (c, 3), generator=gen, device=DEVICE)
    x = 0.5 * torch.randn((c, SV_OBS), generator=gen, device=DEVICE)
    hyper = rt.interop.stochvol_from_numpy(y, device=DEVICE).hyper_manifold(x)
    grad, jac = hyper.grad(theta), hyper.dg_cache(theta)
    exact = rt.models.stochvol.StochVolModel(torch.from_numpy(y).to(DEVICE))  # float64
    th64, x64, h = theta.double(), x.double(), 1e-6
    steps = h * torch.eye(3, dtype=torch.float64, device=DEVICE)
    fd_grad = torch.stack([(exact.hyper_logp(th64 + e, x64) - exact.hyper_logp(th64 - e, x64)) / (2 * h)
                           for e in steps], dim=-1)
    fd_jac = torch.stack([(exact.hyper_metric(th64 + e) - exact.hyper_metric(th64 - e)) / (2 * h) for e in steps],
                         dim=1)
    errs = {}
    for name, port, ref in (("grad", grad, fd_grad), ("dg_cache", jac, fd_jac)):
        # per coordinate d of the derivative, relative to its largest entry over the chains
        err = (port.double() - ref).abs().transpose(0, 1).reshape(3, -1).amax(1)
        errs[name] = float((err / ref.abs().transpose(0, 1).reshape(3, -1).amax(1)).max())
        check(errs[name] < 1e-3, f"stochvol hyper {name} under inference mode vs central differences: "
                                 f"max error {errs[name]} of its scale")
    say("stochvol-autodiff", chains=c, T=SV_OBS, max_error_of_scale=errs, tolerance=1e-3)


def phase_stochvol(smi: str) -> dict:
    check_hyper_autodiff()
    launches_by_path, rm = {}, None
    for method, (burn, samples) in SV_RUNS.items():
        label = f"stochvol/{method}"
        hl.reset_launch_counts()
        res = experiments.run_workload("stochvol", method, device=DEVICE, num_chains=SV_CHAINS, num_samples=samples,
                                       burn_in=burn, seed=SV_SEED, keep_samples=True, stochvol_obs=SV_OBS)
        launches = hl.launch_counts()
        sweeps = burn + 2 * (samples // 2)
        expected = sv_expected_launches(method, sweeps)
        check(launches == expected, f"{label}: launch counts {launches}, expected {expected}")
        launches_by_path[label] = launches

        hyper, latent = res.samples["hyper"], res.samples["latent"]
        check(hyper.shape == (SV_CHAINS, samples, 3) and latent.shape == (SV_CHAINS, samples, SV_OBS),
              f"{label}: samples of shapes {hyper.shape}, {latent.shape}")
        check(np.isfinite(hyper).all() and np.isfinite(latent).all(), f"{label}: non-finite samples")
        ref = SV_JAX[method]
        check(abs(res.accept_rate - ref["accept"]) <= ACCEPT_TOL,
              f"{label}: acceptance {res.accept_rate} vs the JAX package's {ref['accept']} +- {ACCEPT_TOL}")
        max_div = MAX_DIVERGENT_FRACTION * SV_CHAINS * samples
        if method != "hmc":  # the JAX package's hmc diverges in ~0.7% of sweeps (RESULTS.md:45)
            check(res.divergences <= max_div, f"{label}: {res.divergences} divergences > {max_div}")
        z_jax = chain_mean_z(hyper, ref["mean"], ref["sd"], SV_JAX_CHAINS)
        check(float(z_jax.max()) < Z_BOUND, f"{label}: hyper means vs the JAX package's: z {z_jax}")
        means = hyper.reshape(-1, 3).mean(0)
        cm = hyper.mean(1)
        if method == "rmhmc":
            rm = (cm.mean(0), cm.std(0, ddof=1))
            inside = all(lo < m < hi for m, (lo, hi) in zip(means, SV_BOXES))
            check(inside, f"{label}: hyper means {means} outside {SV_BOXES}")
        z_rm = chain_mean_z(hyper, rm[0], rm[1], SV_CHAINS)
        say("stochvol", run=label, T=SV_OBS, chains=SV_CHAINS, burn_in=burn, samples=samples,
            accept_rate=res.accept_rate, jax_accept=ref["accept"], divergent=res.divergences,
            hyper_means=means.tolist(), max_z_means_vs_jax=float(z_jax.max()),
            max_z_means_vs_rmhmc_no_gate=float(z_rm.max()), max_split_rhat=res.rhat_max, launches=launches)
        per_sweep = res.sampling_time_s / (2 * (samples // 2))
        say("stochvol-times", run=label, card=smi, s_per_sweep=per_sweep, sampling_s=res.sampling_time_s,
            **{f"min_ess_{g}_per_s": float(e.min()) / res.sampling_time_s for g, e in res.ess.items()})
    return launches_by_path


# -- phase 8: log-Gaussian Cox on the 64 x 64 grid -------------------------------

LGC_N, LGC_SEED = 64, 0
# (sampler, chains, burn-in, samples); chain counts as RESULTS.md:77-79 ran
# them, 8 for the position-dependent mMALA ((C, 4096, 4096) metric, 64 MB per chain).
LGC_RUNS = (("rmhmc", 64, 100, 100), ("mmala", 8, 50, 50),
            ("mala_transient", 16, 200, 200), ("mala_stationary", 16, 200, 200))
# pmala moves the field from the prior mean slowly: at 200 + 200 steps its
# means still sat a median z of 7.8 from phmc's; at 1000 + 1000 (2 s) they
# agree (PERF.md).
PMALA_RUN = (64, 1000, 1000)
# The JAX package's acceptance at the same constants, depth, seed and data, on
# the CPU (PERF.md): 8 chains (mmala 2, hence its wider window).
LGC_JAX = {"rmhmc": 0.95772, "mmala": 0.30671, "mala_transient": 0.79961, "mala_stationary": 4.9e-7, "pmala": 0.88239}
LGC_ACCEPT_TOL = {"mmala": 0.15}


def lgc_check(label: str, accept: float, ref: float, tol: float, samples: np.ndarray, shape) -> None:
    check(samples.shape == shape and np.isfinite(samples).all(),
          f"{label}: samples of shape {samples.shape}, finite: {bool(np.isfinite(samples).all())}")
    check(abs(accept - ref) <= tol, f"{label}: acceptance {accept} vs the JAX package's {ref} +- {tol}")


def phase_lgc(smi: str) -> dict:
    d = LGC_N * LGC_N
    launches_by_path, fields, accepts = {}, {}, {}
    for sampler, chains, burn, samples in LGC_RUNS:
        label = f"lgc/{sampler}"
        hl.reset_launch_counts()
        res = experiments.run_workload("lgc", sampler, device=DEVICE, num_chains=chains, num_samples=samples,
                                       burn_in=burn, seed=LGC_SEED, keep_samples=True, lgc_n=LGC_N)
        launches_by_path[label] = hl.launch_counts()  # D = 4096: the library factorization, no kernel
        check(launches_by_path[label] == {"cholesky": 0, "chol_solve_logdet": 0}, f"{label}: a kernel launched at D={d}")
        tol = LGC_ACCEPT_TOL.get(sampler, ACCEPT_TOL)
        lgc_check(label, res.accept_rate, LGC_JAX[sampler], tol, res.samples["latent"], (chains, samples, d))
        fields[sampler], accepts[sampler] = res.samples["latent"], res.accept_rate
        say("lgc", run=label, D=d, chains=chains, burn_in=burn, samples=samples, accept_rate=res.accept_rate,
            jax_accept=LGC_JAX[sampler], accept_tol=tol, divergent=res.divergences, max_split_rhat=res.rhat_max)
        say("lgc-times", run=label, card=smi, s_per_step=res.sampling_time_s / (2 * (samples // 2)),
            min_ess_per_s=float(res.ess["latent"].min()) / res.sampling_time_s)

    # Constant-metric mMALA (RESULTS.md:78), on the model's metric_chol / metric_inv.
    y, _ = rt.models.lgc.generate_data(seed=LGC_SEED, n=LGC_N)
    model = rt.interop.lgc_from_numpy(y, LGC_N, device=DEVICE)
    chains, burn, samples = PMALA_RUN
    kernel = pmala.build(model, model.metric_chol, model.metric_inv)
    init = model.prior_mean().expand(chains, -1).clone()
    smp, accept, div, seconds = experiments.timed_sampling(kernel, init, device=torch.device(DEVICE), burn_in=burn,
                                                           num_samples=samples, seed=LGC_SEED)
    smp = smp.cpu().numpy()
    lgc_check("lgc/pmala", accept, LGC_JAX["pmala"], ACCEPT_TOL, smp, (chains, samples, d))
    cm = fields["rmhmc"].mean(axis=1)
    z = chain_mean_z(smp, cm.mean(0), cm.std(0, ddof=1), cm.shape[0])
    check(float(z.max()) < Z_BOUND, f"lgc: pmala and phmc posterior-mean fields differ: max z {float(z.max())}")
    say("lgc", run="lgc/pmala", D=d, chains=chains, burn_in=burn, samples=samples, accept_rate=accept,
        jax_accept=LGC_JAX["pmala"], divergent=div, max_z_field_means_vs_phmc=float(z.max()))
    say("lgc-times", run="lgc/pmala", card=smi, s_per_step=seconds / (2 * (samples // 2)))

    # phmc with TF32 inside the trajectory: printed, no gate (samplers/phmc.py).
    chains, burn, samples = LGC_RUNS[0][1:]
    res = experiments.run_workload("lgc", "rmhmc", device=DEVICE, num_chains=chains, num_samples=samples,
                                   burn_in=burn, seed=LGC_SEED, lgc_n=LGC_N,
                                   overrides={"trajectory_precision": "default"})
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 left on after the TF32 trajectory run")
    say("lgc", run="lgc/rmhmc-tf32-trajectory", chains=chains, burn_in=burn, samples=samples,
        accept_rate=res.accept_rate, full_fp32_accept_rate=accepts["rmhmc"], divergent=res.divergences, gate="none")
    say("lgc-times", run="lgc/rmhmc-tf32-trajectory", card=smi,
        s_per_step=res.sampling_time_s / (2 * (samples // 2)))
    return launches_by_path


# -- phase 9: joint log-Gaussian Cox (unknown hyperparameters) --------------------

LGCJ_CHAINS, LGCJ_SEED = 4, 0
# (burn-in, samples) at the full width, n = 64: the reference's 1000 + 5000 cut to a smoke run.
LGCJ_RUNS = {"rmhmc_joint": (30, 60), "mmala_joint": (30, 60)}
# Sweep-level acceptance of RESULTS.md:258-261 (4 chains, 1000 + 5000 sweeps on
# the authors' data set, hence the width of the window).
LGCJ_RESULTS = {"rmhmc_joint": 0.881, "mmala_joint": 0.669}
LGCJ_RESULTS_TOL = 0.12
# The same-data gate: n = 32 (D = 1024), this depth, 16 chains (at 4 the
# spread of the chain means was itself too uncertain to gate on: PERF.md).
LGCJ_SMALL_N, LGCJ_SMALL_RUN, LGCJ_SMALL_CHAINS = 32, (50, 100), 16
# The JAX package at the same constants, depth, seed and generated data, on the
# CPU with 16 chains (tests/reference_workload_jax.py --workload lgc --samplers
# rmhmc_joint mmala_joint --lgc-n 32 --chains 16 --burn-in 50 --samples 100):
# acceptance, and the mean and sd over chains of the per-chain means of (sigma^2, beta).
LGCJ_JAX_CHAINS = 16
LGCJ_JAX = {
    "rmhmc_joint": {"accept": 0.98637, "mean": [1.67089, 0.029062], "sd": [0.46311, 0.0090042]},
    "mmala_joint": {"accept": 0.94732, "mean": [1.50904, 0.086207], "sd": [0.31542, 0.024106]},
}
LGCJ_RESUME = dict(num_samples=12, burn_in=4, checkpoint_every=4)  # three segments, stopped after one
SMOKE_CKPT = SMOKE_DATA.parent / "smoke_ckpt"
JOINT_CFG = rt.samplers.lgc_joint.LGCJointConfig()  # hyper L = 1, 3 position fixed-point rounds


def lgcj_expected_launches(sampler: str, sweeps: int) -> dict:
    """K1 / K2 launches of a joint LGC run, read from the code: the hyper kernel
    is rebuilt and ``init``-ed every sweep.  RMHMC builds the (C, 2, 2) geometry
    in ``init`` and after each of its L leapfrog steps (K1) and solves once per
    position fixed-point round (K2); mMALA factors in ``init`` and at the
    proposal (K1).  The latent block and the GP algebra are at D = n^2: library calls."""
    if sampler == "rmhmc_joint":
        return {"cholesky": (1 + JOINT_CFG.hyper_num_leapfrog) * sweeps,
                "chol_solve_logdet": JOINT_CFG.hyper_num_leapfrog * JOINT_CFG.hyper_num_fixed_point * sweeps}
    return {"cholesky": 2 * sweeps, "chol_solve_logdet": 0}


def lgcj_run(sampler: str, n: int, burn: int, samples: int, chains: int):
    """One joint run through the workload entry point, with its launch counts
    held to the formulas, its shapes and signs checked, and its peak memory."""
    label = f"lgc/{sampler}" + ("" if n == 64 else f"-n{n}")
    torch.cuda.reset_peak_memory_stats()
    hl.reset_launch_counts()
    res = experiments.run_workload("lgc", sampler, device=DEVICE, num_chains=chains, num_samples=samples,
                                   burn_in=burn, seed=LGCJ_SEED, keep_samples=True, lgc_n=n)
    launches = hl.launch_counts()
    expected = lgcj_expected_launches(sampler, max(burn, 1) + 2 * (samples // 2))
    check(launches == expected, f"{label}: launch counts {launches}, expected {expected}")
    hyper, latent = res.samples["hyper"], res.samples["latent"]
    check(hyper.shape == (chains, samples, 2) and latent.shape == (chains, samples, n * n),
          f"{label}: samples of shapes {hyper.shape}, {latent.shape}")
    check(np.isfinite(hyper).all() and (hyper > 0).all(), f"{label}: hyper samples not finite and positive")
    check(np.isfinite(latent).all(), f"{label}: non-finite latent samples")
    check(res.divergences == 0, f"{label}: {res.divergences} divergences")
    return label, res, launches, torch.cuda.max_memory_allocated()


def phase_lgc_joint(smi: str) -> dict:
    launches_by_path = {}
    for sampler, (burn, samples) in LGCJ_RUNS.items():
        label, res, launches, peak = lgcj_run(sampler, LGC_N, burn, samples, LGCJ_CHAINS)
        launches_by_path[label] = launches
        ref = LGCJ_RESULTS[sampler]
        check(abs(res.accept_rate - ref) <= LGCJ_RESULTS_TOL,
              f"{label}: acceptance {res.accept_rate} vs RESULTS.md:258-261 {ref} +- {LGCJ_RESULTS_TOL}")
        say("lgc-joint", run=label, D=LGC_N * LGC_N, chains=LGCJ_CHAINS, burn_in=burn, samples=samples,
            accept_rate=res.accept_rate, results_md_accept=ref, accept_tol=LGCJ_RESULTS_TOL,
            divergent=res.divergences, hyper_means=res.samples["hyper"].reshape(-1, 2).mean(0).tolist(),
            launches=launches)
        say("lgc-joint-times", run=label, card=smi, s_per_sweep=res.sampling_time_s / (2 * (samples // 2)),
            sampling_s=res.sampling_time_s, max_memory_allocated_bytes=peak,
            **{f"min_ess_{g}_per_s": float(e.min()) / res.sampling_time_s for g, e in res.ess.items()})

    # The same data as the JAX package's run, at n = 32.
    burn, samples = LGCJ_SMALL_RUN
    for sampler, ref in LGCJ_JAX.items():
        label, res, launches, peak = lgcj_run(sampler, LGCJ_SMALL_N, burn, samples, LGCJ_SMALL_CHAINS)
        launches_by_path[label] = launches
        check(abs(res.accept_rate - ref["accept"]) <= ACCEPT_TOL,
              f"{label}: acceptance {res.accept_rate} vs the JAX package's {ref['accept']} +- {ACCEPT_TOL}")
        cm = res.samples["hyper"].mean(axis=1)
        z = chain_mean_z(res.samples["hyper"], ref["mean"], ref["sd"], LGCJ_JAX_CHAINS)
        check(float(z.max()) < Z_BOUND, f"{label}: hyper chain means {cm.mean(axis=0)} vs the JAX package's {ref['mean']}: z {z}")
        say("lgc-joint", run=label, D=LGCJ_SMALL_N**2, chains=LGCJ_SMALL_CHAINS, burn_in=burn, samples=samples,
            accept_rate=res.accept_rate, jax_accept=ref["accept"], accept_tol=ACCEPT_TOL, divergent=res.divergences,
            hyper_chain_means=cm.mean(axis=0).tolist(), hyper_chain_means_sd=cm.std(axis=0, ddof=1).tolist(),
            jax_hyper_chain_means=ref["mean"], jax_hyper_chain_means_sd=ref["sd"],
            max_z_means_vs_jax=float(z.max()), launches=launches)
        say("lgc-joint-times", run=label, card=smi, s_per_sweep=res.sampling_time_s / (2 * (samples // 2)),
            max_memory_allocated_bytes=peak)

    # Resume on the card: stopped after one segment and resumed, against the run not stopped.
    shutil.rmtree(SMOKE_CKPT, ignore_errors=True)
    kernel, init_fn, collect_fn, _, _ = experiments.build_workload("lgc", "rmhmc_joint", device=DEVICE,
                                                                   seed=LGCJ_SEED, lgc_n=LGCJ_SMALL_N)
    kw = dict(collect_fn=collect_fn, **LGCJ_RESUME)
    full = rt.parallel.run_checkpointed(kernel, LGCJ_SEED, init_fn(LGCJ_CHAINS), checkpoint_path=SMOKE_CKPT / "full.npz", **kw)
    stopped = rt.parallel.run_checkpointed(kernel, LGCJ_SEED, init_fn(LGCJ_CHAINS), checkpoint_path=SMOKE_CKPT / "cut.npz",
                                           _stop_after_segments=1, **kw)
    resumed = rt.parallel.run_checkpointed(kernel, LGCJ_SEED, init_fn(LGCJ_CHAINS), checkpoint_path=SMOKE_CKPT / "cut.npz", **kw)
    every = LGCJ_RESUME["checkpoint_every"]
    check(stopped.samples[0].shape[1] == every and resumed.samples[0].shape[1] == LGCJ_RESUME["num_samples"],
          f"resume: {stopped.samples[0].shape[1]} samples when stopped, {resumed.samples[0].shape[1]} when resumed")
    check(all(t.is_cuda for t in (*full.samples, *resumed.samples, *resumed.final_state)), "resume: a tensor left the card")
    same = {name: torch.equal(a, b) for name, a, b in (
        ("hyper", full.samples[0], resumed.samples[0]), ("latent", full.samples[1], resumed.samples[1]),
        ("theta", full.final_state.theta, resumed.final_state.theta), ("x", full.final_state.x, resumed.final_state.x))}
    check(all(same.values()), f"resume: the resumed run differs from the run that was not stopped: {same}")
    check(bool(torch.isfinite(full.samples[1]).all()) and not torch.equal(full.samples[1][:, 0], full.samples[1][:, -1]),
          "resume: the run did not move")
    say("lgc-joint-resume", sampler="rmhmc_joint", n=LGCJ_SMALL_N, chains=LGCJ_CHAINS, **LGCJ_RESUME,
        stopped_after_segments=1, bit_identical=same, files=sorted(f.name for f in SMOKE_CKPT.iterdir()))
    return launches_by_path

# -- phase 10: FitzHugh-Nagumo: the sensitivity kernel and six samplers ------------

FHN_OBS, FHN_SUBSTEPS, FHN_CHAINS, FHN_SEED = 200, 5, 256, 0  # the JAX build_workload defaults
FHN_SOURCE = "riemannhamiltonianmontecarlo_tpu_torch/ops/csrc/fhn_sens.cu"
FHN_REPLACES = "riemannhamiltonianmontecarlo_tpu/models/fhn.py:55-85 (jacfwd through lax.scan; no pallas_call)"
FHN_KERNEL_NAME = "fhn_sensitivities_kernel"
# Kernel against twin: |k - p| <= 1e-4 x the output's largest finite |entry|.  Both
# are float32 with another order of operations (FMAs, another summation
# order); the JAX package's own float32 / float64 spread on this model is
# <= 1.9e-5 of each output's scale.
FHN_TOL = 1e-4
FHN_SPECIAL = ((-0.1, 0.2, 3.0), (0.2, 0.2, 100.0))  # outside the support; a trajectory that overflows
# (burn-in, samples) per sampler, the reference's 5000 + 5000 (hmc 1000 + 5000) cut to a smoke run.
FHN_RUNS = {"rmhmc": (50, 50), "mmala": (100, 100), "mmala_simplified": (100, 100), "mala": (200, 200),
            "metropolis": (200, 200), "hmc": (20, 20)}
FHN_RMHMC_L, FHN_RMHMC_FP, FHN_HMC_L = 6, 5, 150  # the fhn presets of experiments.build_workload
FHN_JITTER = 1e-6  # added to G by the fhn rmhmc and mmala presets
# The JAX package at the same constants, depth, seed and generated data, on the
# CPU with 64 chains (JAX_PLATFORMS=cpu python tests/reference_workload_jax.py
# --workload fhn --chains 64 --samplers <m> --burn-in <b> --samples <s>, the
# depths of FHN_RUNS; ~5 min for the six): acceptance, divergences, and the
# mean and sd over chains of the per-chain means of (a, b, c).
FHN_JAX_CHAINS = 64
FHN_JAX = {
    "rmhmc": {"accept": 0.96256, "divergent": 2, "mean": [0.19076, 0.2667, 2.9703], "sd": [0.0029123, 0.013862, 0.0056827]},
    "mmala": {"accept": 0.50693, "divergent": 3, "mean": [0.19057, 0.26196, 2.9718], "sd": [0.0038499, 0.020282, 0.009644]},
    "mmala_simplified": {"accept": 0.64583, "divergent": 11, "mean": [0.19039, 0.2592, 2.9721], "sd": [0.004396, 0.033025, 0.010497]},
    "mala": {"accept": 0.67635, "divergent": 3, "mean": [0.18905, 0.26738, 2.973], "sd": [0.006251, 0.066566, 0.026531]},
    "metropolis": {"accept": 0.34307, "divergent": 0, "mean": [0.19017, 0.27304, 2.9675], "sd": [0.0065591, 0.043494, 0.019747]},
    "hmc": {"accept": 0.91902, "divergent": 44, "mean": [0.19094, 0.26392, 2.9809], "sd": [0.0044489, 0.021497, 0.05897]},
}
# RESULTS.md:96-101 (the reference's depth, another data set): printed, no gate.
FHN_RESULTS = {"metropolis": 0.340, "mala": 0.676, "hmc": 0.942, "mmala": 0.509, "mmala_simplified": 0.641,
               "rmhmc": 0.963}


def fhn_constants() -> dict:
    return dict(substeps=FHN_SUBSTEPS, noise_sd=0.5, gamma_scale=3.0)


def fhn_data():
    data, _ = rt.models.fhn.generate_data(seed=FHN_SEED if FHN_SEED > 0 else 1, num_obs=FHN_OBS)
    return torch.tensor(data, dtype=torch.float32, device=DEVICE)


def fhn_thetas(c: int) -> tuple[torch.Tensor, list[int]]:
    """Seeded theta around the truth, with the special chains in the middle
    of a block and as the batch's last chain."""
    gen = torch.Generator(device=DEVICE).manual_seed(c)
    truth = torch.tensor(rt.models.fhn.THETA_TRUE, device=DEVICE)
    theta = truth * (1.0 + 0.1 * torch.randn((c, 3), generator=gen, device=DEVICE))
    special = [c // 2 + 5, c - 1]
    theta[special] = torch.tensor(FHN_SPECIAL, device=DEVICE)
    return theta, special


def check_fhn_kernel(c: int, order: int, data, err: dict) -> float:
    """The kernel against its twin at one (C, order); returns the twin's ms."""
    theta, special = fhn_thetas(c)
    at = f"(C={c}, order {order})"
    k = rt.ops.fhn_sens.fhn_sensitivities_cuda(theta, data, order, **fhn_constants())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = rt.ops.fhn_sens.fhn_sensitivities_plain(theta, data, order, **fhn_constants())
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    keep = torch.ones(c, dtype=torch.bool, device=DEVICE)
    keep[special] = False
    alone = rt.ops.fhn_sens.fhn_sensitivities_cuda(theta[keep].contiguous(), data, order, **fhn_constants())
    torch.cuda.synchronize()
    for name, kt, pt, at_ in zip(k._fields, k, p, alone):
        if kt is None:
            continue
        fin = torch.isfinite(pt)
        check(torch.equal(torch.isfinite(kt), fin), f"fhn {name} {at}: non-finite entries differ from the twin's")
        scale = float(pt[fin].abs().max())
        e = float((kt - pt)[fin].abs().max())
        check(e <= FHN_TOL * scale, f"fhn {name} vs twin {at}: max |err| {e} > {FHN_TOL} x {scale}")
        err[name] = max(err.get(name, 0.0), e / scale)
        same = (kt[keep] == at_) | (torch.isnan(kt[keep]) & torch.isnan(at_))
        check(bool(same.all()), f"fhn {name} {at}: other chains' outputs change with the special chains")
    check(bool((k.logp[special] == -torch.inf).all() and (p.logp[special] == -torch.inf).all()),
          f"fhn logp {at}: not -inf at the special chains")
    if order >= 1:
        check(bool((k.grad[special] == 0).all() and (p.grad[special] == 0).all()),
              f"fhn grad {at}: not 0 at the special chains")
    return plain_ms


def fhn_bound_us(order: int, c: int) -> tuple[float, str, float]:
    """(bound_us, bound_by, operations): bytes once (theta, data in; the
    order's outputs out) at 3.35 TB/s against the operations counted from the
    source at 67 TFLOP/s."""
    outputs = {0: 1, 1: 1 + 3 + 9, 2: 1 + 3 + 9 + 27}[order]
    nbytes = 4 * (3 * c + 2 * FHN_OBS + outputs * c)
    ops = rt.ops.fhn_sens.operations(order, c, FHN_OBS, FHN_SUBSTEPS)
    by_bytes, by_ops = 1e6 * nbytes / HBM_BYTES_PER_S, 1e6 * ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", ops


def check_kernels_on_fhn_metrics(data, k_err: dict) -> dict:
    """K1 and K2 against their twins on the metrics the FHN samplers factor:
    G + jitter I from the kernel's order-2 call at 256 chains around the
    truth (entries up to ~2e4), b a momentum L z, as RMHMC's fixed point
    solves.  Tolerances as phase 3's."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    truth = torch.tensor(rt.models.fhn.THETA_TRUE, device=DEVICE)
    theta = truth * (1.0 + 0.1 * torch.randn((FHN_CHAINS, 3), generator=gen, device=DEVICE))
    g = rt.ops.fhn_sens.fhn_sensitivities_cuda(theta, data, 2, **fhn_constants()).metric
    g = g + FHN_JITTER * torch.eye(3, device=DEVICE)
    check(bool(torch.isfinite(g).all()), "FHN metrics around the truth not finite")
    lp = hl.cholesky_plain(g)
    b = (lp @ torch.randn((FHN_CHAINS, 3, 1), generator=gen, device=DEVICE))[..., 0]
    lk, (xk, ldk), (xp, ldp) = hl.cholesky_cuda(g), hl.chol_solve_logdet_cuda(g, b), hl.chol_solve_logdet_plain(g, b)
    torch.cuda.synchronize()
    errs = {"L": excess(lk, lp, TOL["L"]), "x": excess(xk, xp, TOL["x"]), "logdet": excess(ldk, ldp, TOL["logdet"])}
    check(all(over <= 0 for _, over in errs.values()), f"K1 / K2 vs twins on FHN metrics beyond tolerance: {errs}")
    k_err["cholesky"] = max(k_err["cholesky"], errs["L"][0])
    k_err["chol_solve_logdet"] = max(k_err["chol_solve_logdet"], errs["x"][0], errs["logdet"][0])
    cond = torch.linalg.cond(g.double())
    return {"max_abs_err": {name: e for name, (e, _) in errs.items()}, "max_entry": float(g.abs().max()),
            "condition_min_max": [float(cond.min()), float(cond.max())]}


def phase_fhn_kernel(smi: str, k_err: dict) -> dict:
    """The FHN kernel against its twin and its times, then K1 / K2 on its
    metrics (``k_err``: phase 3's max |err| per kernel, raised here).  Runs
    right after phase 3, where torch.profiler sees the device."""
    data = fhn_data()
    err, plain_ms = {}, {}
    for c in (FHN_CHAINS, FHN_CHAINS + 1):
        for order in rt.ops.fhn_sens.ORDERS:
            ms = check_fhn_kernel(c, order, data, err)
            if c == FHN_CHAINS:  # the timed batch: the twin's one call there is its time
                plain_ms[order] = ms
    say("fhn-kernel", checked=f"C in ({FHN_CHAINS}, {FHN_CHAINS + 1}) x orders 0-2 at {FHN_OBS} x {FHN_SUBSTEPS}, "
        "one chain outside the support and one that overflows", max_err_of_scale=err, tolerance_of_scale=FHN_TOL)
    say("kernels-on-fhn-metrics", C=FHN_CHAINS, jitter=FHN_JITTER, tolerance_rtol_atol=TOL,
        **check_kernels_on_fhn_metrics(data, k_err))
    theta, _ = fhn_thetas(FHN_CHAINS)
    times = {}
    for order in rt.ops.fhn_sens.ORDERS:
        def launch():
            return rt.ops.fhn_sens.fhn_sensitivities_cuda(theta, data, order, **fhn_constants())
        dev = device_us(launch, launches=20, name_part=FHN_KERNEL_NAME)
        check(dev["events_per_call"] == 1, f"fhn: {dev['events_per_call']} device kernels per launch")
        bound, bound_by, ops = fhn_bound_us(order, FHN_CHAINS)
        times[order] = {"ms": median_ms(launch, reps=20), "device_us": dev["us"], "device_us_source": dev["source"],
                        "profiler_sessions": dev["sessions"],
                        "plain_ms": plain_ms[order], "bound_us": bound, "bound_by": bound_by, "operations": ops,
                        "share_of_bound": bound / dev["us"]}
        say("fhn-kernel-times", order=order, C=FHN_CHAINS, num_obs=FHN_OBS, substeps=FHN_SUBSTEPS, card=smi,
            **times[order], library="none: no single PyTorch call integrates an ODE with its sensitivities")
    say("fhn-kernel-scaling", card=smi, **fhn_scaling(data))
    return {"err": max(err.values()), "err_by_output": err, "times": times}


FHN_SCALING_CHAINS = (32, FHN_CHAINS, 4224, 16896, 33792)  # 4224: one warp on each SM; 16896: on each scheduler


def fhn_scaling(data) -> dict:
    """Milliseconds per launch (CUDA events over 10 launches) by order and
    chain count on theta around the truth, and at 256 chains with the two
    special chains in the batch: flat in C while each warp has a scheduler
    of its own says the bound is one chain's sequence of steps."""
    truth = torch.tensor(rt.models.fhn.THETA_TRUE, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    out = {}
    for order in rt.ops.fhn_sens.ORDERS:
        row = {}
        for c in FHN_SCALING_CHAINS:
            theta = truth * (1.0 + 0.05 * torch.randn((c, 3), generator=gen, device=DEVICE))
            row[str(c)] = burst_ms(lambda: rt.ops.fhn_sens.fhn_sensitivities_cuda(theta, data, order, **fhn_constants()),
                                   launches=10, warmup=2)
        special, _ = fhn_thetas(FHN_CHAINS)
        row[f"{FHN_CHAINS}_with_special_chains"] = burst_ms(
            lambda: rt.ops.fhn_sens.fhn_sensitivities_cuda(special, data, order, **fhn_constants()), launches=10, warmup=2)
        out[f"order{order}_ms_by_chains"] = row
    return out


def fhn_expected_launches(sampler: str, sweeps: int) -> tuple[dict, dict]:
    """(FHN-kernel launches by order, K1 / K2 launches) of a run, read from the
    code: RMHMC calls ``manifold_state`` (order 2, then K1) in ``init`` and
    after each leapfrog step and ``metric`` (order 1, then K2) in each round of
    the position fixed point; mMALA ``manifold_state`` and K1 in ``init`` and
    at the proposal; HMC ``logp`` in ``init`` and at the trajectory's end and
    ``grad`` at its start and after each of the L steps; MALA
    ``logp_and_grad`` in ``init`` and at the proposal; Metropolis ``logp``
    in ``init`` and once per coordinate."""
    fhn, k1, k2 = {0: 0, 1: 0, 2: 0}, 0, 0
    if sampler == "rmhmc":
        fhn[2] = k1 = 1 + FHN_RMHMC_L * sweeps
        fhn[1] = k2 = FHN_RMHMC_L * FHN_RMHMC_FP * sweeps
    elif sampler in ("mmala", "mmala_simplified"):
        fhn[2] = k1 = 1 + sweeps
    elif sampler == "hmc":
        fhn[1], fhn[0] = (1 + FHN_HMC_L) * sweeps, 1 + sweeps
    elif sampler == "mala":
        fhn[1] = 1 + sweeps
    else:  # metropolis
        fhn[0] = 1 + 3 * sweeps
    return fhn, {"cholesky": k1, "chol_solve_logdet": k2}


def phase_fhn(smi: str, kernel: dict) -> dict:
    """The six samplers; ``kernel`` is ``phase_fhn_kernel``'s result."""
    fhn_by_path, k_by_path = {}, {}
    for sampler, (burn, samples) in FHN_RUNS.items():
        label = f"fhn/{sampler}"
        rt.ops.fhn_sens.reset_launch_counts()
        hl.reset_launch_counts()
        res = experiments.run_workload("fhn", sampler, device=DEVICE, num_chains=FHN_CHAINS, num_samples=samples,
                                       burn_in=burn, seed=FHN_SEED, keep_samples=True, fhn_obs=FHN_OBS,
                                       fhn_substeps=FHN_SUBSTEPS)
        fhn_launches, k_launches = rt.ops.fhn_sens.launch_counts(), hl.launch_counts()
        fhn_expected, k_expected = fhn_expected_launches(sampler, burn + 2 * (samples // 2))
        check(fhn_launches == fhn_expected, f"{label}: FHN kernel launches {fhn_launches}, expected {fhn_expected}")
        check(k_launches == k_expected, f"{label}: K1 / K2 launches {k_launches}, expected {k_expected}")
        fhn_by_path[label], k_by_path[label] = fhn_launches, k_launches

        params = res.samples["params"]
        check(params.shape == (FHN_CHAINS, samples, 3) and np.isfinite(params).all(),
              f"{label}: samples of shape {params.shape}, finite: {bool(np.isfinite(params).all())}")
        ref = FHN_JAX[sampler]
        check(abs(res.accept_rate - ref["accept"]) <= ACCEPT_TOL,
              f"{label}: acceptance {res.accept_rate} vs the JAX package's {ref['accept']} +- {ACCEPT_TOL}")
        z = chain_mean_z(params, ref["mean"], ref["sd"], FHN_JAX_CHAINS)
        check(float(z.max()) < Z_BOUND, f"{label}: chain means vs the JAX package's: z {z}")
        cm = params.mean(axis=1)
        say("fhn", run=label, num_obs=FHN_OBS, substeps=FHN_SUBSTEPS, chains=FHN_CHAINS, burn_in=burn,
            samples=samples, accept_rate=res.accept_rate, jax_accept=ref["accept"], accept_tol=ACCEPT_TOL,
            results_md_accept_no_gate=FHN_RESULTS[sampler], divergent=res.divergences,
            jax_divergent=ref["divergent"], jax_chains=FHN_JAX_CHAINS, chain_means=cm.mean(0).tolist(),
            jax_chain_means=ref["mean"], max_z_means_vs_jax=float(z.max()), max_split_rhat=res.rhat_max,
            fhn_launches=fhn_launches, launches=k_launches)
        say("fhn-times", run=label, card=smi, s_per_transition=res.sampling_time_s / (2 * (samples // 2)),
            sampling_s=res.sampling_time_s, min_ess_per_s=float(res.ess["params"].min()) / res.sampling_time_s)
    return {"kernel": kernel, "fhn_by_path": fhn_by_path, "k_by_path": k_by_path}


def fhn_summary(fhn: dict, smi: str) -> dict:
    """The FHN kernel's entry of the kernels line: order 2 at (256, 200, 5) at
    the top (RMHMC's and mMALA's geometry), every order under "orders"."""
    times = fhn["kernel"]["times"]
    top = times[2]
    total = sum(sum(counts.values()) for counts in fhn["fhn_by_path"].values())
    return {
        "name": "fhn_sensitivities", "route": "cuda", "source": FHN_SOURCE, "replaces": FHN_REPLACES,
        "launches": total, "max_abs_err": fhn["kernel"]["err"], "max_abs_err_is": "of each output's scale",
        "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_us"] / 1e3, "bound_by": top["bound_by"],
        "library_ms": None, "library_note": "no single PyTorch call integrates an ODE with its sensitivities",
        "device_us": top["device_us"], "share_of_bound": top["share_of_bound"], "card": smi,
        "shape": {"C": FHN_CHAINS, "num_obs": FHN_OBS, "substeps": FHN_SUBSTEPS, "order": 2},
        "orders": {str(order): row for order, row in times.items()},
        "launches_by_path": {label: {str(o): n for o, n in counts.items()}
                             for label, counts in fhn["fhn_by_path"].items()},
    }


# -- phase 11: the parallel layer on torch.distributed ------------------------------

DIST_SEED = 21
DIST_BLR_RUN = (20, 20)  # (burn-in, samples): world 1 over NCCL against no mesh (torch.equal needs no depth)
DIST_LGC_RUN = (20, 20)  # phmc at the lgc "rmhmc" preset (L 30, eps 0.1), 64 chains
DIST_LGC_CHAINS = 64
DIST_TWO_RANK_RUN = (10, 10)  # two ranks sharing the card over Gloo, against a run without a mesh
DIST_TIMEOUT = 300.0  # seconds: the process groups' timeout and the two-rank launch's
DIST_TOL = (1e-5, 1e-5)  # (rtol, atol): two-rank positions against the one-process run
# A chain whose |log a - log u| came this close to 0 in either run may take
# another decision under another order of float32 sums (|logp| ~ 3e2, so
# ~1e-5 of rounding), and then another path: such a chain may part from the
# one-process run; every other chain takes the same decisions, with its
# positions within DIST_TOL.
DIST_MARGIN = 1e-3
DIST_CKPT = dict(num_samples=6, burn_in=2, checkpoint_every=2)  # three segments, stopped after one
DIST_ESS_RUN = dict(num_chains=1024, burn_in=50, num_samples=50)
DIST_DIR = SMOKE_DATA.parent / "smoke_dist"


class MarginState(NamedTuple):
    inner: object
    margin: torch.Tensor  # (C,) the smallest |log a - log u| of the run so far

    @property
    def position(self) -> torch.Tensor:
        return self.inner.position


def with_margins(kernel):
    """``kernel`` that also keeps, per chain, how close its accept decisions came to the boundary."""
    def init(position):
        return MarginState(kernel.init(position), torch.full(position.shape[:1], float("inf"), device=position.device))

    def transition(state, noise):
        inner, info = kernel.transition(state.inner, noise)
        margin = (torch.log(info.accept_prob) - torch.log(noise.u_acc)).abs()
        return MarginState(inner, torch.minimum(state.margin, margin)), info

    def step(generator, state):
        return transition(state, kernel.draw_noise(generator, state.position))

    return rt.samplers.Kernel(init, step, transition, kernel.draw_noise)


def dist_run(kernel, init, mesh, burn: int, samples: int) -> dict:
    """Burn-in and a timed sampling run through ``parallel.run(..., mesh=)``,
    with the K1 / K2 launches and the all-reduces it made."""
    gen = torch.Generator(device=DEVICE).manual_seed(DIST_SEED)
    hl.reset_launch_counts()
    collectives.reset_call_counts()
    warm = rt.parallel.run(kernel, gen, init, num_samples=burn, collect=False, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rt.parallel.run(kernel, gen, None, num_samples=samples, init_state=warm.final_state, mesh=mesh)
    torch.cuda.synchronize()
    return {"samples": res.samples, "accept": res.accept_rate, "div": res.divergences + warm.divergences,
            "seconds": time.perf_counter() - t0, "launches": hl.launch_counts(),
            "all_reduce": collectives.call_counts()["all_reduce"], "state": res.final_state}


def distributed_rank(out: str) -> None:
    """One of two ranks sharing the card over Gloo (run by ``parallel.launch``):
    BLR RMHMC at full width with the chains split, then with the rows split,
    and checkpoint shards; writes ``two_rank.r<rank>.npz`` under ``out``."""
    rank, out = dist.get_rank(), Path(out)
    model = blr_model()
    init = torch.from_numpy(np.load(out / "init.npy")).to(DEVICE)
    burn, samples = DIST_TWO_RANK_RUN
    arrays = {}
    with torch.inference_mode():
        for label, shape in (("chains", (2, 1)), ("data", (1, 2))):
            mesh = rt.parallel.make_mesh(2, (CHAIN_AXIS, "data"), shape)
            run = dist_run(with_margins(rmhmc.build(model.with_sharding(mesh))), init, mesh, burn, samples)
            arrays.update({f"{label}_samples": run["samples"], f"{label}_margin": run["state"].margin,
                           f"{label}_accept": run["accept"], f"{label}_div": run["div"],
                           f"{label}_s_per_transition": run["seconds"] / samples,
                           f"{label}_all_reduce_per_transition": run["all_reduce"] / (burn + samples),
                           **{f"{label}_{k}": v for k, v in run["launches"].items()}})
        mesh = rt.parallel.make_mesh(2, (CHAIN_AXIS,), (2,))
        kernel = rmhmc.build(model)
        res = rt.parallel.run_checkpointed(kernel, DIST_SEED, init, checkpoint_path=out / "ckpt.npz", mesh=mesh,
                                           **DIST_CKPT)
        template = kernel.init(rt.parallel.shard_chains(mesh, init))
    restored, step, _ = rt.utils.checkpoint.load_state(out / "ckpt.npz", template)
    arrays["ckpt_round_trip"] = step == 3 and all(torch.equal(a, b) for a, b in zip(
        rt.utils.checkpoint.tree_leaves(restored), rt.utils.checkpoint.tree_leaves(res.final_state)))
    np.savez(out / f"two_rank.r{rank}.npz",
             **{k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in arrays.items()})


def compare_to_one_process(label: str, samples: np.ndarray, margin: np.ndarray, ref: dict) -> dict:
    """Every chain against the one-process run: the same accept decisions and
    positions within DIST_TOL, unless its decisions came within DIST_MARGIN
    of the boundary in either run (then it may part, and is counted).  Prints
    the largest ratio of a difference to its tolerance, atol + rtol |ref|,
    over the chains that did not part."""
    rtol, atol = DIST_TOL
    moved = lambda smp: (smp[:, 1:] != smp[:, :-1]).any(-1)  # noqa: E731
    diff = np.abs(samples - ref["samples"])
    ratio = (diff / (atol + rtol * np.abs(ref["samples"]))).max(axis=(1, 2))
    kept = (moved(samples) == moved(ref["samples"])).all(axis=1) & (ratio <= 1.0)
    near = np.minimum(margin, ref["margin"]) <= DIST_MARGIN
    stray = ~kept & ~near
    check(not stray.any(), f"{label}: {int(stray.sum())} chains away from the accept boundary part from the "
                           f"one-process run (worst ratio to the tolerance {float(ratio.max())})")
    parted = ~kept
    return {"chains": int(samples.shape[0]), "parted_near_boundary": int(parted.sum()),
            "near_boundary": int(near.sum()),
            "largest_margin_of_parted": float(np.minimum(margin, ref["margin"])[parted].max()) if parted.any() else None,
            "max_abs_diff": float(diff[kept].max()), "worst_ratio_to_tolerance": float(ratio[kept].max()),
            "tolerance": {"rtol": rtol, "atol": atol}}


def local_mesh(index: int, k: int):
    """Rank ``index`` of a k-rank chain axis in one process, without a process
    group: the runner slices the chains and the noise as that rank does."""
    return rt.parallel.Mesh((CHAIN_AXIS,), {CHAIN_AXIS: k}, {CHAIN_AXIS: index}, {})


def batch_invariance(model, init: torch.Tensor) -> dict:
    """Which part of an RMHMC transition gives a chain other bits in a batch of
    half the rows: each op on all rows against the same op on each half."""
    kernel = rmhmc.build(model)
    noise = kernel.draw_noise(torch.Generator(device=DEVICE).manual_seed(DIST_SEED), init)
    g = model.metric(init)
    u = noise.eps
    flat = lambda *ts: torch.cat([t.reshape(t.shape[0], -1) for t in ts], dim=1)  # noqa: E731
    ops = {
        "logits w @ X^T": (model._logits, (init,)),
        "grad resid @ X": (model.grad, (init,)),
        "metric terms v @ F": (model.metric, (init,)),
        "manifold_state": (lambda w: flat(*model.manifold_state(w)), (init,)),
        "dg_trace": (model.dg_trace, (init, torch.linalg.inv(g))),
        "dg_bilinear": (model.dg_bilinear, (init, u, u)),
        "K1 cholesky": (hl.cholesky, (g,)),
        "K2 chol_solve_logdet": (lambda a, b: flat(*hl.chol_solve_logdet(a, b)), (g, init)),
        "transition": (lambda w, *leaves: kernel.transition(kernel.init(w), type(noise)(*leaves))[0].position,
                       (init, *noise)),
    }
    out, h = {}, init.shape[0] // 2
    for name, (fn, args) in ops.items():
        whole = fn(*args)
        diff = max(float((fn(*(a[sl] for a in args)) - whole[sl]).abs().max())
                   for sl in (slice(0, h), slice(h, None)))
        out[name] = {"bit_identical": diff == 0.0, "max_abs_diff": diff}
    return out


def host_profile(kernel, state, mesh) -> dict:
    """The host's time by op over one transition (torch.profiler, CPU
    activity only): the eight ops of largest self time."""
    gen = torch.Generator(device=DEVICE).manual_seed(DIST_SEED)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        rt.parallel.run(kernel, gen, None, num_samples=1, init_state=state, collect=False, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {"s_per_transition_profiled": wall,
            "top_self_cpu": [{"op": e.key, "calls": e.count, "self_us": e.self_cpu_time_total} for e in rows]}


def phase_distributed(smi: str) -> dict:
    """Phase 11: the parallel layer: world 1 over NCCL in this process, then
    two ranks sharing the card over Gloo."""
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    write_smoke_csvs()
    model = blr_model()
    init = rt.utils.default_init(model, torch.Generator(device=DEVICE).manual_seed(DIST_SEED), NUM_CHAINS)
    launches_by_path = {}
    rt.parallel.initialize_distributed(device=DEVICE, init_method=f"tcp://localhost:{free_port()}", world_size=1,
                                       rank=0, timeout=timedelta(seconds=DIST_TIMEOUT))
    try:
        check(dist.get_backend() == "nccl", f"world 1 runs over {dist.get_backend()}, not NCCL")
        # BLR RMHMC at full width: a ("chains", "data") mesh of shape (1, 1) against no mesh.
        mesh = rt.parallel.make_mesh(1, (CHAIN_AXIS, "data"), (1, 1))
        burn, samples = DIST_BLR_RUN
        plain_kernel, world1_kernel = rmhmc.build(model), rmhmc.build(model.with_sharding(mesh))
        plain = dist_run(plain_kernel, init, None, burn, samples)
        world1 = dist_run(world1_kernel, init, mesh, burn, samples)
        same = {k: torch.equal(plain[k], world1[k]) for k in ("samples", "accept", "div")}
        check(all(same.values()), f"distributed: world 1 differs from the run without a mesh: {same}")
        expected = blr_expected_launches(burn + samples)
        for run in (plain, world1):
            check(run["launches"] == expected, f"distributed: launch counts {run['launches']}, expected {expected}")
        launches_by_path["distributed/world1-blr"] = world1["launches"]
        steps = burn + samples
        say("distributed", run="world1-blr", backend="nccl", mesh={CHAIN_AXIS: 1, "data": 1}, chains=NUM_CHAINS,
            burn_in=burn, samples=samples, bit_identical_to_no_mesh=same, launches=world1["launches"],
            accept_rate=float(world1["accept"]), divergent=int(world1["div"]))
        say("distributed-times", run="world1-blr", card=smi, s_per_transition=world1["seconds"] / samples,
            no_mesh_s_per_transition=plain["seconds"] / samples,
            all_reduce_per_transition=world1["all_reduce"] / steps, no_mesh_all_reduce=plain["all_reduce"])
        # Where the host's time goes with and without the mesh (what the all-reduces cost).
        say("distributed-host-profile", run="world1-blr", card=smi,
            world1=host_profile(world1_kernel, world1["state"], mesh), no_mesh=host_profile(plain_kernel, plain["state"], None))

        # LGC phmc at D = 4096: the operators' rows over a ("chains", "latent") mesh of shape (1, 1).
        y, _ = rt.models.lgc.generate_data(seed=LGC_SEED, n=LGC_N)
        lgc_model = rt.interop.lgc_from_numpy(y, LGC_N, device=DEVICE)
        latent = rt.parallel.make_mesh(1, (CHAIN_AXIS, "latent"), (1, 1))
        sharded = lgc_model.with_sharding(latent)
        cfg = rt.samplers.phmc.PHMCConfig(step_size=0.1, num_leapfrog=30)  # the lgc "rmhmc" preset
        lgc_init = lgc_model.prior_mean().expand(DIST_LGC_CHAINS, -1).clone()
        burn, samples = DIST_LGC_RUN
        lgc_plain = dist_run(rt.samplers.phmc.build(lgc_model, lgc_model.metric_chol, lgc_model.metric_inv, cfg),
                             lgc_init, None, burn, samples)
        lgc_world1 = dist_run(rt.samplers.phmc.build(sharded, sharded.metric_chol, sharded.metric_inv, cfg),
                              lgc_init, latent, burn, samples)
        same = {k: torch.equal(lgc_plain[k], lgc_world1[k]) for k in ("samples", "accept", "div")}
        check(all(same.values()), f"distributed: LGC world 1 differs from the run without a mesh: {same}")
        check(lgc_world1["launches"] == {"cholesky": 0, "chol_solve_logdet": 0}, "distributed: a kernel launched at D=4096")
        check(float(lgc_world1["accept"]) > 0.5, f"distributed: LGC acceptance {float(lgc_world1['accept'])}")
        say("distributed", run="world1-lgc-phmc", backend="nccl", mesh={CHAIN_AXIS: 1, "latent": 1},
            D=LGC_N * LGC_N, chains=DIST_LGC_CHAINS, burn_in=burn, samples=samples, bit_identical_to_no_mesh=same,
            accept_rate=float(lgc_world1["accept"]), divergent=int(lgc_world1["div"]))
        say("distributed-times", run="world1-lgc-phmc", card=smi, s_per_transition=lgc_world1["seconds"] / samples,
            no_mesh_s_per_transition=lgc_plain["seconds"] / samples,
            all_reduce_per_transition=lgc_world1["all_reduce"] / (burn + samples))

        # run_checkpointed with the mesh: stopped after one segment and resumed, bit for bit; no .p suffix at world 1.
        kernel = rmhmc.build(model.with_sharding(mesh))
        kw = dict(mesh=mesh, **DIST_CKPT)
        full = rt.parallel.run_checkpointed(kernel, DIST_SEED, init, checkpoint_path=DIST_DIR / "full.npz", **kw)
        rt.parallel.run_checkpointed(kernel, DIST_SEED, init, checkpoint_path=DIST_DIR / "cut.npz",
                                     _stop_after_segments=1, **kw)
        resumed = rt.parallel.run_checkpointed(kernel, DIST_SEED, init, checkpoint_path=DIST_DIR / "cut.npz", **kw)
        same = {"samples": torch.equal(full.samples, resumed.samples),
                "position": torch.equal(full.final_state.position, resumed.final_state.position)}
        check(all(same.values()), f"distributed: the resumed run differs from the run not stopped: {same}")
        files = sorted(f.name for f in DIST_DIR.iterdir())
        check("cut.npz" in files and not any(".p" in f for f in files), f"distributed: checkpoint files {files}")
        say("distributed", run="world1-resume", **DIST_CKPT, stopped_after_segments=1, bit_identical=same, files=files)

        # The native ESS engine through the experiment entry point, on phase 6's CSV.
        res = experiments.run_experiment("rmhmc", "australian", device=DEVICE, ess_mode="native", keep_samples=True,
                                         mesh=mesh, **DIST_ESS_RUN)
        exact = rt.diagnostics.ess_multichain(res.samples, nfft_mode="exact")
        rel = abs(res.ess_min / float(exact.min()) - 1.0)
        check(rel <= 1e-10, f"distributed: native min-ESS {res.ess_min} vs exact {float(exact.min())}")
        say("distributed", run="world1-native-ess", **DIST_ESS_RUN, ess_min_native=res.ess_min,
            ess_min_exact=float(exact.min()), rel_diff=rel, accept_rate=res.accept_rate)
    finally:
        dist.destroy_process_group()

    # Two ranks sharing the card over Gloo, against the run without a mesh and,
    # for the chain split, against one process running each rank's half of
    # the chains (the same batch size a rank's cuBLAS calls see).
    burn, samples = DIST_TWO_RANK_RUN
    np.save(DIST_DIR / "init.npy", init.cpu().numpy())
    as_numpy = lambda run: {"samples": run["samples"].cpu().numpy(), "margin": run["state"].margin.cpu().numpy()}  # noqa: E731
    with torch.inference_mode():
        ref = as_numpy(dist_run(with_margins(rmhmc.build(model)), init, None, burn, samples))
        halves = [as_numpy(dist_run(with_margins(rmhmc.build(model)), init, local_mesh(i, 2), burn, samples))
                  for i in range(2)]
        invariance = batch_invariance(model, init)
    say("distributed-batch-invariance", rows=NUM_CHAINS, half=NUM_CHAINS // 2, ops=invariance)
    t0 = time.perf_counter()
    spawn("chip_smoke:distributed_rank", 2, device=DEVICE, backend="gloo", args=[str(DIST_DIR)], timeout=DIST_TIMEOUT)
    launch_s = time.perf_counter() - t0
    r0, r1 = (np.load(DIST_DIR / f"two_rank.r{r}.npz") for r in range(2))
    expected = blr_expected_launches(burn + samples)
    fields = {}
    for label in ("chains", "data"):
        for r in (r0, r1):
            got = {k: int(r[f"{label}_{k}"]) for k in expected}
            check(got == expected, f"distributed 2-rank {label}: launch counts {got} on a rank, expected {expected}")
            check(float(r[f"{label}_accept"]) == float(r0[f"{label}_accept"]), f"{label}: the ranks' acceptance differs")
        launches_by_path[f"distributed/2rank-{label}-per-rank"] = expected
        if label == "chains":
            same = all(np.array_equal(r[f"chains_{k}"], half[k]) for r, half in zip((r0, r1), halves)
                       for k in ("samples", "margin"))
            check(same, "chain split: a rank differs from one process running its half of the chains")
            samples_, margin = (np.concatenate([r0[f"{label}_{k}"], r1[f"{label}_{k}"]]) for k in ("samples", "margin"))
        else:
            check(np.array_equal(r0["data_samples"], r1["data_samples"]), "data split: the ranks' positions differ")
            samples_, margin = r0["data_samples"], np.minimum(r0["data_margin"], r1["data_margin"])
        fields[label] = compare_to_one_process(f"2-rank {label}", samples_, margin, ref)
        if label == "chains":
            fields[label]["bit_identical_to_one_process_by_half"] = same
        fields[label]["s_per_transition"] = [float(r[f"{label}_s_per_transition"]) for r in (r0, r1)]
        fields[label]["all_reduce_per_transition"] = float(r0[f"{label}_all_reduce_per_transition"])
    check(bool(r0["ckpt_round_trip"]) and bool(r1["ckpt_round_trip"]), "two ranks: a checkpoint shard did not round-trip")
    shards = sorted(f.name for f in DIST_DIR.iterdir() if f.name.startswith("ckpt.npz.p"))
    check("ckpt.npz.p0" in shards and "ckpt.npz.p1" in shards, f"two ranks: checkpoint shards {shards}")
    say("distributed", run="2rank-gloo-blr", backend="gloo", chains=NUM_CHAINS, burn_in=burn, samples=samples,
        boundary_margin=DIST_MARGIN, launches_per_rank=expected, checkpoint_shards=shards,
        **{f"split_{label}": {k: v for k, v in f.items() if k != "s_per_transition"} for label, f in fields.items()})
    say("distributed-times", run="2rank-gloo-blr", card=smi, launch_s=launch_s,
        **{f"split_{label}_s_per_transition": f["s_per_transition"] for label, f in fields.items()})
    return launches_by_path


PHASES = ("kernels", "transition", "main-path", "blr-samplers", "stochvol", "lgc", "lgc-joint", "fhn", "distributed")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Drive the port's main path on one CUDA card and check it.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (default: all).  The device and build "
                         "phases always run; a subset prints the whole ptxas report and no result lines (not a pass)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {','.join(PHASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    seconds, t0 = {}, time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    by_path = {}
    with torch.inference_mode():
        smi = phase_device()
        phase_build()
        lap("device+build")
        k_err = {"cholesky": 0.0, "chol_solve_logdet": 0.0}
        if "kernels" in phases:
            kernels = phase_kernels(smi)
            k_err = kernels["err"]
        if "kernels" in phases or "fhn" in phases:  # the FHN kernel's checks and times; phase 10 reports them
            fhn_kernel = phase_fhn_kernel(smi, k_err)
            lap("kernels")
        model = blr_model()
        if "transition" in phases:
            phase_transition(model)
            lap("transition")
        if "main-path" in phases:
            launches = phase_main_path(model, smi)
            lap("main-path")
        for name, phase in (("blr-samplers", phase_blr_samplers), ("stochvol", phase_stochvol), ("lgc", phase_lgc),
                            ("lgc-joint", phase_lgc_joint)):
            if name in phases:
                by_path.update(phase(smi))
                lap(name)
        if "fhn" in phases:
            fhn = phase_fhn(smi, fhn_kernel)
            by_path.update(fhn["k_by_path"])
            lap("fhn")
        if "distributed" in phases:
            by_path.update(phase_distributed(smi))
            lap("distributed")
    say("phase-seconds", **seconds)
    if set(phases) != set(PHASES):
        print((_build.build().parent / "ptxas.log").read_text(), flush=True)
        return

    # Top-level times: the main path's shape (C 4096, D 15); every timed shape under "shapes".
    summary = []
    for name in ("cholesky", "chol_solve_logdet"):
        main_shape = kernels["times"][NUM_CHAINS, DIM][name]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": kernels["err"][name],
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_us"] / 1e3, "bound_by": main_shape["bound_by"],
            "library_ms": main_shape.get("library_ms"),
            **{key: main_shape[key] for key in ("device_us", "bound_us", "share_of_bound", "library_seq_ms")
               if key in main_shape},
            "card": smi,
            "shapes": {f"C{c}_D{d}": row[name] for (c, d), row in kernels["times"].items()},
            "launches_by_path": {"rmhmc-main-path": launches[name],
                                 **{label: counts[name] for label, counts in by_path.items()}},
        })
    summary.append(fhn_summary(fhn, smi))
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
