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
   prints the build seconds and the ptxas register / spill report (K1 / K2 / K3
   per width, T1, T2 per positions a thread and its device-memory form's
   three rounds, the FHN kernel per order, G1 per count 1..SWEEP_ENT_MAX of
   B's entries a lane holds with and without its prologue and on a block of
   warps, and its wide layout's two forms with B in memory, G2 and the single
   GIG round: exactly one instantiation each, G1's spilling in none but
   G1_SPILLS), holds SWEEP_ENT_MAX, G1's scratch size and its shared memory a
   block against the library's, and
   holds ``hopper_linalg.launch_geometry`` (lanes per chain, chains per
   block, shared-memory tile) against the built library's own answer for
   every width 1..48, ``tridiag.pcr_geometry`` against the library's at
   16 lengths T across its forms' cut-overs, and ``fhn_sens.launch_geometry`` (lanes per chain,
   chains and threads per block, blocks, shared bytes) and
   ``fhn_sens.output_owners`` (the lane of a chain's group that writes each
   output entry) against the library's for orders 0-2 at C in {1, 31, 256,
   257, 4224}; K4's and K5's registers and spill per width (none at D 15
   or 25), ``logreg_fixed_point.launch_geometry`` against the library's,
   and both refusing the widths they do not serve (D 17-24, 26-48);
3. kernels: K1 (Cholesky), K2 (fused solve + log-det) and K3 (factor,
   inverse and half log-det: RMHMC's geometry) against their
   plain-PyTorch twins on the card, on seeded SPD batches at
   C in {4096, 4097} and D in {3, 7, 10, 15, 25}, at StochVol's
   C = 1024, D = 3, FHN's C = 256, D = 3 and at the joint LGC hyper block's (C, D) = (4, 2) and
   (4097, 2) (2 and 10 take the kernels' runtime-width instantiation, the
   others a compile-time width): tolerance, exact-zero upper triangle, and
   non-PD chains (the first, a middle and the last chain of a block, and
   the batch's last chain) giving non-finite output in those chains only;
   an operand that is not 16-byte aligned and one that is not contiguous
   give the same bits as the aligned contiguous one; K3's factor is K1's
   bit for bit and its inverse exactly symmetric.  Then, at
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
   the diagonal (``library_seq_ms``: a sequence, for information only), for
   K3 cholesky_ex, cholesky_inverse, log of the diagonal (the same).  Then
   StochVol's tridiagonal kernels (``ops/csrc/tridiag.cu``; also run by
   ``--phases stochvol``): T1, the bidiagonal scan on the pivots, against
   its twin (the loop of seven launches a position) at (B, T) = (1024, 2000),
   (1025, 2000), (3, 1), (3, 2) and (64, 7) on seeded StochVol metrics, off
   an expanded view as the model makes it, read through its strides
   (rtol / atol 1e-5, NaN exactly where the twin has it), with a chain
   made indefinite at T / 2 (NaN from there on, in it alone) and HMC's
   identity mass (ld 1, e 0 exactly), and its times at (1024, 2000), the
   wrapper one device event (no copy); T2, the PCR solve, against
   ``tridiag.solve_plain`` on the card, ``torch.equal``, at (B, T) =
   (1024, 2000), (1025, 2000), (3, 1), (3, 2), (3, 3), (64, 7), (64, 1025)
   and (64, 2049) on StochVol's metric, at (1024, 2000) on HMC's identity
   mass and with a non-contiguous b, and at (4, 20000), past the
   shared-memory form (one launch a round); its times at (1024, 2000)
   (``pcr-kernel-times``: ``device_us`` beside ``pcr_bound_us``, the
   wrapper's ``ms``, the twin's ``plain_ms`` and device time and launches,
   registers and spill from the ptxas report) and at (4, 20000).  No single
   PyTorch call computes either, so no library yardstick.
   Then the FitzHugh-Nagumo sensitivity kernel (``ops/csrc/fhn_sens.cu``)
   against its plain twin at (C, num_obs, substeps) = (256, 200, 5) and
   (257, 200, 5), orders 0, 1 and 2, on seeded theta around the truth with
   one chain outside the support and one whose trajectory overflows: each
   output within 1e-4 of its largest finite entry, the same non-finite
   entries, logp -inf and a zero gradient in both special chains, the other
   chains' outputs bit for bit those of a batch without the special ones;
   the same past the first form's 6,144 observations at 16 chains and one
   substep (the twin on the host's CPU): orders 0-2 at 8,192, order 0 at
   50,000; per order its device time beside its bound (the roofline) and the
   source's critical path (a chain's longest sequence of dependent
   operations at 4 cycles each and the card's maximum SM clock; printed on
   the times line, not in the kernels line) and the twin's time; then K1
   and K2 against their twins on the metrics it returns at 256 chains (the
   matrices the FHN samplers factor).  Then the Gibbs step's kernels
   (``ops/csrc/gibbs.cu``): G1, the sequential z / B sweep, against
   ``samplers.gibbs.gibbs_sweep_plain`` at (C, N, D) = (1024, 690, 15) (at
   the wrapper's lanes a chain and at each of ``SWEEP_LANES``),
   (1024, 1000, 25), (1025, 690, 15) and (257, 200, 40), on a state one plain step from
   init, past K1's 48 at UCI Sonar's shape (256, 208, 61), UCI Musk v1's
   (1024, 476, 167) and (64, 300, 2049), where the wide layout runs (a block
   of warps a chain, B in registers), at D = 32 x SWEEP_ENT_MAX on (64, 300)
   in both layouts (B in registers on 32 lanes; the wide layout on 8 warps
   with B in registers, in shared memory and in the output buffer: the same
   bits in those three), and at (4, 64, 12800), past the registers and past
   48 KB of shared memory a block (the card's opt-in raised; B in the output
   buffer there the same bits), each timed, and each wide layout also held
   against the float64 plain version (its error at most twice the float32
   plain version's plus 1e-5); at D >= 1024 the conditionals come from
   batched matmuls under a prior variance of 1e-2, not from a BLR model;
   and at (1024, 690, 15) on that state with z scaled by 8 (the tail
   case: some steps' bound a > 3, which must take each of the tail's three
   Rayleigh rounds): every z_j and B entry within rtol / atol 1e-4 except in
   the chains that parted (a value within rounding of a branch threshold, or
   a u within 1e-4 of 1, where ndtri's slope turns one ulp of u into more
   than the tolerance), counted and at most 3% of them; the single GIG
   rejection round (``gig_round_kernel``, off the Gibbs path) against
   ``ops.gig.gig_round_plain`` on the same draws at (1024, 690), r^2
   log-uniform over [1e-4, 25] and 64 exact zeros among the normal draws,
   a first round and a second from its flags: the elements whose decision
   differs counted and at most 1e-4 of them, no zero-draw candidate
   accepted, an accepted element unchanged; G2, the whole GIG draw with its
   Philox numbers made inside, against ``ops.gig.sample_gig_half_plain``
   from one key at (1024, 690) and on rows 512: of a chain split (global
   indices), at most 1e-4 of the elements differing, the split's rows the
   whole call's bit for bit, the rounds the elements ran (mean, maximum).
   For each, its device time beside its bound (G1 also beside the source's
   critical path), the plain version's time, and the wrapper's.  Then BLR
   RMHMC's two fixed points (``ops/csrc/logreg_fixed_point.cu``; also run by
   ``--phases main-path``): K4 (the position fixed point, 4 rounds) and K5
   (the momentum fixed point, 4 rounds, and its one-round half-step) against
   the plain versions (the sampler's loops, K2 a position round) at (C, N, D)
   = (4096, 690, 15), (4096, 1000, 25), (1024, 250, 3), (4, 32, 2),
   (256, 20000, 15) (X and c streamed in tiles) and (1024, 532, 10)
   (capacity 16), Student-t off and on, dt of
   both signs: the yardstick is the plain version in float64 on the same
   float32 inputs, and a kernel's largest error against it must be at most
   twice the float32 plain version's plus 1e-5 (at (256, 20000, 15) K4's
   must also stay below 6.2e-6, the error of the earlier K4 whose row sums
   ran in sequence, and at most 4 times the float32 loops' there, printed
   beside it on a ``fixed-point-large-n`` line); a chain whose G is not positive
   definite is non-finite in both and every other chain bit for bit the
   batch without it; at (4096, 690, 15) and (4096, 1000, 25) each one's
   ``device_us`` beside its bound, the wrapper's and the plain version's ms
   and the parent's route (the loops with K2) captured as one graph (no
   PyTorch call computes either: information only).  A timed kernel that
   torch.profiler does not see fails the run;
4. one RMHMC transition through the kernels against one through the plain
   linalg, on the same state and noise (BLR, synthetic data of the
   australian shape N=690, D=15, 4096 chains);
5. the main path: MAP + jitter init, burn-in, timed sampling run, with the
   kernels' launch counts, acceptance, divergences, split R-hat, and the
   posterior means against a plain-linalg run under another seed; prints
   seconds per transition and min-ESS/s.  The counts are the kernels'
   device counters (``ops.launches``), which the step's CUDA graph adds to
   at each replay: K3 1 + L a step, K4 L and K5 2 L, K1 and K2 none; three
   more replays of that graph under torch.profiler must show as many K1 -
   K5 device events as the counters count;
6. blr-samplers: the experiment entry point
   ``experiments.run_experiment(..., device="cuda")`` for all nine BLR
   samplers on a synthetic CSV of australian's shape (N=690, D=15), mMALA
   and RMHMC once more on one of german's shape (N=1000, D=25: K1's and
   K2's spilling D=25 instantiations end to end), and adaptive RMHMC (K3
   and K2 under a tensor step size); then Gibbs on UCI Musk v1's shape
   (N=476, D=167: V and chol(V) from torch.linalg, G1 on 32 lanes of 6
   entries), 1024 chains, 3 + 3 eager and captured: bit for bit, one
   capture, G1 / G2 counted on the device 6 each and K1 / K2 / K3 0, three
   replays under torch.profiler against the counters; the same at N=300,
   D=2049, 64 chains, under a prior of variance 1e-2 (G1's wide layout, 8
   warps a chain; the outer features ~5.0 GB), printing G1's layout and the
   peak of allocated memory.  Each run: finite samples of the
   right shape, acceptance in a window from RESULTS.md or the JAX
   package's tests, divergences, posterior means against the RMHMC run on
   the same data (z < 5 from exact-mode ESS), and K1 - K5 launch counts
   (Gibbs's: and G1 and G2 once a step; its run, 1024 chains, replays
   a CUDA graph as every capturable run does) equal to the formulas the
   samplers' code gives; prints seconds per transition and min-ESS/s beside
   the nvidia-smi line;
7. stochvol: ``experiments.run_workload("stochvol", m, device="cuda")`` for
   m in {rmhmc, hmc, mala, mmala} at T = 2000 latents and 1024 chains (the
   hyper block runs K1 / K2 / K3 at D = 3, the latent block T1 once a
   sweep and T2 once a latent leapfrog step and twice more (rmhmc, hmc) or
   three times (mmala), but under MALA neither), after one captured sweep
   each of rmhmc, hmc and mmala from one state and one noise through T2
   and again with ``tridiag.solve_plain`` patched in, ``torch.equal`` leaf
   for leaf, T1 once in both and T2 counted on the device in the first
   alone: finite hyper and latent samples of
   the right shapes, acceptance in a window around the JAX package's at the
   same constants, depth, seed and data (measured on the CPU, PERF.md),
   divergences (no gate for hmc, whose reference rate is ~0.7%), hyper
   means against the JAX package's at the same depth from the same start
   (z < 5 over the chain means; only RMHMC has mixed at these depths) and
   RMHMC's inside the boxes of tests/test_stochvol.py:77-79, and K1 / K2 / K3,
   T1 and T2 launch counts equal to the formulas (T2's from each run's own
   latent L);
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
   samples, K1 / K2 / K3 launch counts equal to the formulas, sweep-level
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
   K1 / K2 / K3 launches equal to the formulas, acceptance within 0.05 of the JAX
   package's at the same constants, depth, seed and data and chain means
   within z < 5 of its (``FHN_JAX``, measured on the CPU by
   ``tests/reference_workload_jax.py``); divergences and ``RESULTS.md``'s
   acceptance printed beside them, without a gate; then RMHMC at 8,192
   observations x 5 substeps, 256 chains, 3 + 3 eager and captured: bit for
   bit, one capture, FHN-kernel and K1 / K2 / K3 launches counted on the device
   equal to the formulas, three replays under torch.profiler;
11. distributed: the parallel layer on ``torch.distributed``; runs with a
   mesh replay the step's CUDA graph wherever the kernel declares it (a
   chain split on any backend, a step's all-reduces over NCCL).  In this
   process, a process group of one rank over NCCL (a TCP store on a free
   local port, torn down at the end): BLR RMHMC at full width (4096 chains,
   20 + 20) through ``parallel.run(..., mesh=)`` on a ("chains", "data")
   mesh of shape (1, 1) with the model from ``with_sharding`` (the
   sampler's loops, K2: its metric is all-reduced between the build and the
   factor), and LGC phmc
   at D = 4096 (64 chains, 20 + 20) on a ("chains", "latent") mesh, each
   captured and ``torch.equal`` to the same mesh run eager and to the
   captured run without a mesh (BLR's on the loops too:
   ``step_profile.parent_routes``), one
   capture in the burn-in and none in the
   timed run, with K1 - K5 launch counts equal to the formulas and the
   all-reduces counted on the device equal to those the eager run issued
   (72 a BLR step, 66 an LGC step); three replays of each graph: the device
   count against one eager step's issued all-reduces, and the NCCL kernels
   torch.profiler sees in them against those it sees for as many eager
   all-reduces (NCCL's one-rank in-place sum launches none); the host's
   time by op (torch.profiler) of an eager BLR transition with and without
   the mesh; ``run_checkpointed`` with the mesh, captured (one capture for
   three runs), stopped after one segment and resumed, bit for bit the run
   not stopped and the eager one, its files without a ``.p`` suffix;
   ``run_experiment("rmhmc", adapt=True, mesh=)`` (the adaptive kernel
   pooled over the chain group, 4096 chains, 3 + 6), captured (two
   captures, none in the timed half) and bit for bit the same run with the
   graphs refused; ``run_experiment("rmhmc", ess_mode="native", mesh=)`` on
   phase 6's CSV, its min-ESS equal to the exact-mode ESS of its samples to
   1e-10.  Then two ranks sharing the card over Gloo on CUDA tensors
   (``parallel.launch.spawn``, plain subprocesses with a timeout): BLR RMHMC
   at full width, 10 + 10, chains split (2, 1) on the whole model (K4 /
   K5), captured and bit for bit each rank's eager run, and rows split
   (1, 2) on the model from ``with_sharding`` (the loops, K2), eager (its
   all-reduces are Gloo's), with
   ``capture=True`` refused naming Gloo.  Under the chain split each rank is
   bit for bit one process running that rank's half of the chains (the same
   noise, the same batch size); under the row split the ranks' positions
   are bit-identical.  Both against the one-process run of all chains:
   every chain takes the same accept decisions with positions within 1e-5
   abs / 1e-5 rel, except that a chain whose decisions came within 1e-3 of
   the boundary may part (counted); the largest ratio of a difference to its
   tolerance is printed, with which ops of a transition give other bits at
   half the rows.  K1 - K5 launch counts per rank equal the formulas; the
   checkpoint shards ``.p0`` / ``.p1`` round-trip.  Then, split (2, 1) over
   the same two ranks, the four samplers the chain split took last, 5 + 5
   each, captured and bit for bit each rank's eager run: AMH (BLR, 4096
   chains; coordinate-major noise), Gibbs (BLR, 256 chains; G1 and G2, its
   GIG's Philox counters indexed by the global element), StochVol RMHMC
   (T = 2000, 64 chains) and joint LGC mMALA (n = 32, 4 chains), the last
   two drawing their noise from a view of the state.  Each rank is bit for
   bit one process running its half of the chains, and no rank makes a MIN
   all-reduce (no exit test agreed over the ranks); against one process
   running all chains the rule above holds (Gibbs at 1e-4 and joint LGC at
   1e-3, ``DIST_SPLIT_TOL``, with the ratio to 1e-5 printed), a chain's
   closeness to a decision boundary found by rerunning each step of that
   run on the state with every entry moved by 1e-4 of random sign (these
   samplers expose no one accept margin); K1 / K2 / K3 launch counts per rank
   equal the formulas.  Seconds per transition (world 1 with the mesh
   captured and eager against no mesh captured, two ranks captured and
   eager) and all-reduces per transition are printed beside the card,
   without a gate;
12. tools: the results tools of ``riemannhamiltonianmontecarlo_tpu_torch/tools``
   through their run functions at smoke depth: ``make_results`` (the rmhmc
   and gibbs rows on phase 6's australian CSV, 256 chains, 50 + 50),
   ``make_results_all`` (StochVol rmhmc, 64 chains, 20 + 20, the kept
   samples streamed to pinned host memory and the ESS and R-hat through the
   host-array route), ``ess_engine_bench`` (256 chains, 50 + 50, german CSV,
   the C++ engine against NumPy within 1e-3), ``probe_scaling`` (FHN HMC at
   two chain counts, 2 steps) and ``scaling_table`` (world sizes 1 and 2
   over Gloo on the card, 5 + 5, every rank replaying its chain-split step's graph).  Each section is headed with the nvidia-smi line and holds the
   expected number of rows of finite numbers; K1 - K5 launch counts of the
   make_results, StochVol and ESS-engine rows equal the formulas; the rmhmc
   row's acceptance is within 0.05 of phase 5's, the StochVol row's of
   phase 7's (or, without those phases, in phase 5's window / within 0.05 of
   the JAX package's); ``RESULTS.md`` is byte for byte what it was.  Seconds
   per tool are printed;
13. graphs: the runner's CUDA graphs (``parallel.graphs``).  RMHMC's
   ``draw_noise`` alone replayed 8 times against 8 eager calls from one
   seed; BLR RMHMC at phase 5's configuration (4096 chains, 20 + 20) run
   with ``capture=False`` and ``capture=True`` from one seed: samples,
   final state, acceptance and divergences equal bit for bit, K1 - K5
   launch counts of the captured run equal to ``blr_expected_launches``,
   one capture for both phases; then every other capturable sampler (the
   BLR ones and adaptive RMHMC at 4096 chains, Gibbs at 1024 with its G1 /
   G2 counts equal to phase 6's formula, LGC phmc / pmala / mMALA /
   whitened MALA at D = 4096, the six FHN samplers at 200 x 5 and 256
   chains, StochVol's four methods at T = 2000 and 1024 chains, MALA with
   its transient burn-in kernel, and the joint LGC pair at n = 32 with 16
   chains), 3 + 3, eager against captured, bit for bit, with equal launch
   counts (StochVol's K1 / K2 / K3, T1 and T2 counts and the joint pair's
   K1 / K2 / K3 equal to ``sv_expected_launches`` / ``lgcj_expected_launches``) and one capture
   per kernel of the run, after one eager step of each of the run's kernels under
   ``torch.cuda.set_sync_debug_mode("error")``; where a run launched a
   hand-written kernel (and for the main path), three replays of its graph
   under torch.profiler, the counters against the device's kernel events;
   a monitored BLR HMC (4096 chains) and Gibbs (1024) eager and captured,
   the same window lines and chains;
   ``tools/run_lgc_joint``'s segmented run (n = 32, 4 chains), captured,
   stopped after one segment and resumed bit for bit;
   ``capture=True`` refused for a ``FunctionModel``; ``timed_sampling``
   capturing once before its timed half (which raises on a capture); a
   captured ``run_checkpointed`` stopped after one segment and resumed, bit
   for bit the run not stopped and the eager one.  Then the walls: BLR
   RMHMC, BLR Gibbs (1024 chains), FHN RMHMC and HMC, LGC phmc, eager and
   captured in turns E C C E
   (``step_profile.profile_run``): wall and device-busy ms a step, idle
   share, launches, the capture's seconds and its graph pool's bytes
   (StochVol's and the joint pair's rows: ``python -m
   riemannhamiltonianmontecarlo_tpu_torch.step_profile``).
   Phases 5-12 run the captured path wherever the kernel declares it, as
   ``parallel.run`` does by default on a card, runs with a mesh included
   (phase 11).

It ends with the nvidia-smi line, one JSON line per kernel summary
(``{"kernels": [...]}``) and, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and the last line is not printed; so does a machine with
no CUDA device.

Phase 6 (and phase 12) writes its CSVs under the git-ignored
``build/smoke_data`` and points ``RHMC_DATA_DIR`` there, before the port is
imported; phase 11 writes under ``build/smoke_dist``.  ``--phases distributed`` (a comma-separated subset of
the phases' names, ``PHASES``) runs the device and build phases and that
subset alone, and prints no result lines.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import unittest.mock
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
from riemannhamiltonianmontecarlo_tpu_torch.ops import gig, truncnorm  # noqa: E402
from riemannhamiltonianmontecarlo_tpu_torch.samplers import gibbs, pmala, rmhmc  # noqa: E402

# K4 / K5's module; None where kernel_ab.py imports the port of a checkout from before them
lfp = getattr(rt.ops, "logreg_fixed_point", None)

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
TOL = {"L": (2e-4, 2e-4), "x": (2e-3, 2e-3), "logdet": (2e-4, 2e-3), "inv": (2e-4, 2e-4)}
ACCEPT_WINDOW = (0.85, 0.97)
SEEN_ACCEPT: dict[str, float] = {}  # phase 5's and phase 7's RMHMC acceptance, for phase 12's gates
MAX_DIVERGENT_FRACTION = 1e-4
MAX_RHAT = 1.05
Z_BOUND = 5.0  # posterior means, kernel run vs plain run, per coordinate
BOUNDARY_MARGIN = 1e-2  # |log a - log u| below this: accept decision too close to call
SOURCE = "riemannhamiltonianmontecarlo_tpu_torch/ops/csrc/hopper_linalg.cu"
REPLACES = {
    "cholesky": "riemannhamiltonianmontecarlo_tpu/ops/pallas_linalg.py:116",
    "chol_solve_logdet": "riemannhamiltonianmontecarlo_tpu/ops/pallas_linalg.py:150",
    "chol_inv_logdet": "riemannhamiltonianmontecarlo_tpu/samplers/rmhmc.py:111-118 (ops.cholesky, then "
                       "ops/linalg.py:154-165 inv_psd_from_chol and logdet_from_chol; no pallas_call)",
}
LINALG_COUNTED = tuple(REPLACES)  # K1, K2, K3: hl.launch_counts()'s keys
NO_LINALG = dict.fromkeys(LINALG_COUNTED, 0)  # a run at D = 4096, or of a sampler with no factorization
INV_COND_TOL = 1e-5  # K3's inverse on FHN's ill-conditioned metrics: relative error per chain over its condition
K3_LIBRARY_NOTE = "sequence cholesky_ex, cholesky_inverse, log of the diagonal: information only"

# The StochVol latent block's bidiagonal scan T1 (csrc/tridiag.cu): no Pallas kernel behind it.
BIDIAG = "bidiag_cholesky"  # its name in ops.launches
BIDIAG_SOURCE = "riemannhamiltonianmontecarlo_tpu_torch/ops/csrc/tridiag.cu"
BIDIAG_REPLACES = "riemannhamiltonianmontecarlo_tpu/ops/tridiag.py:37-58 (the factor's lax.scan; no pallas_call)"
BIDIAG_KERNEL_NAME = "bidiag_scan_kernel"
# T1 against its twin at (B, T): StochVol's 1024 chains at T = 2000, a ragged last block, T = 1 (no e), T = 2,
# a few short chains; a non-PD chain and HMC's identity mass each at (1024, 2000).
BIDIAG_SHAPES = ((1024, 2000), (1025, 2000), (3, 1), (3, 2), (64, 7))
BIDIAG_TIMED = (1024, 2000)
BIDIAG_TOL = (1e-5, 1e-5)  # (rtol, atol): the twin's operations in its order, each rounded as in the kernel
# The StochVol latent block's PCR solve T2 (csrc/tridiag.cu): no Pallas kernel behind it either.
PCR = "pcr_solve"  # its name in ops.launches
PCR_REPLACES = "riemannhamiltonianmontecarlo_tpu/ops/tridiag.py:79-112 (the PCR solve's compiled loop; no pallas_call)"
PCR_KERNEL_NAME = "pcr_solve"  # a part of both forms' names: pcr_solve_kernel<P>, pcr_solve_global_kernel<..>
# T2 against solve_plain at (B, T), torch.equal: StochVol's width, a ragged batch, T = 1 (no round), 2, 3, a few
# short chains, a one-warp block with rounds in registers (T = 100: 32 threads x 4), a T just past 2^10, one past
# 2^11, 2^12 and the largest one-launch form (14,528: 1,024 threads x 16); StochVol's metric (off an expanded
# view), HMC's identity mass, a non-contiguous b, a system whose a and c decay through subnormal values and one
# whose couplings never decay (every round, those in registers included, moves x) at (1024, 2000); past the
# shared-memory form, a few chains with the twin on the card.
PCR_SHAPES = ((1024, 2000), (1025, 2000), (3, 1), (3, 2), (3, 3), (64, 7), (64, 100), (64, 1025), (64, 2049),
              (64, 4096), (4, 14528))
PCR_CASES = ("identity", "strided-b", "decay", "unit-root")  # at PCR_TIMED, beside the metric
PCR_TIMED = (1024, 2000)
PCR_LONG = (4, 20000)  # (B, T): past tridiag.PCR_SHARED_MAX_T, one launch a round through device memory
# T at which T2's launch geometry is held against the built library's: every positions-a-thread form, the
# cut-over to one launch a round (tridiag.PCR_SHARED_MAX_T, 14,528) and past it.
PCR_GEOMETRY_T = (1, 2, 3, 7, 31, 33, 257, 1025, 2000, 2049, 8192, 8193, 14528, 14529, 20000, 1 << 20)


# The Gibbs step's two kernels (csrc/gibbs.cu): no Pallas kernel behind either.
GIBBS_SOURCE = "riemannhamiltonianmontecarlo_tpu_torch/ops/csrc/gibbs.cu"
GIBBS_REPLACES = {
    "gibbs_sweep": "riemannhamiltonianmontecarlo_tpu/samplers/gibbs.py:112-124 (the z / B sweep's lax.scan; no pallas_call)",
    "gig_half": "riemannhamiltonianmontecarlo_tpu/ops/gig.py:125-176 (the rejection lax.while_loop, body :143-168, "
                "series :42-115; no pallas_call)",
    "gig_round": "riemannhamiltonianmontecarlo_tpu/ops/gig.py:143-168 (one round of the rejection lax.while_loop, "
                 "series :42-115; no pallas_call)",
}
# (G1's kernels, the register layout's gibbs_sweep_kernel and the wide layout's gibbs_sweep_block_kernel and
# gibbs_sweep_memory_kernel, share "gibbs_sweep")
GIBBS_KERNEL_NAMES = {"gibbs_sweep": "gibbs_sweep", "gig_half": "gig_half_kernel",
                      "gig_round": "gig_round_kernel"}
GIBBS_COUNTED = tuple(GIBBS_KERNEL_NAMES)
# BLR RMHMC's two fixed points K4 and K5 (csrc/logreg_fixed_point.cu): no Pallas kernel behind either.
FIXED_POINT_SOURCE = "riemannhamiltonianmontecarlo_tpu_torch/ops/csrc/logreg_fixed_point.cu"
FIXED_POINT_REPLACES = {
    "position_fixed_point": "riemannhamiltonianmontecarlo_tpu/samplers/rmhmc.py:208-217 (model.metric, "
                            "models/logreg.py:166-183, and ops.solve_psd each round; XLA, no pallas_call)",
    "momentum_fixed_point": "riemannhamiltonianmontecarlo_tpu/samplers/rmhmc.py:193-195 and :220-223 (momentum_force "
                            ":166-185 through models/logreg.py:200-205; XLA, no pallas_call)",
}
FIXED_POINT_KERNEL_NAMES = {"position_fixed_point": "position_fixed_point_kernel",
                            "momentum_fixed_point": "momentum_fixed_point_kernel"}
FIXED_POINT_COUNTED = tuple(FIXED_POINT_KERNEL_NAMES)
# K4 / K5 against their plain versions at (C, N, D): the main path, german's shape, a D-3 and a D-2 batch (run-time
# width 2 on capacity 4), an N past what shared memory holds whole (X and c streamed in tiles, every round), and a
# D-10 batch (run-time width 10 on capacity 16, the widest capacity the kernels serve).
FIXED_POINT_SHAPES = ((NUM_CHAINS, 690, 15), (NUM_CHAINS, 1000, 25), (1024, 250, 3), (4, 32, 2), (256, 20000, 15),
                      (1024, 532, 10))
FIXED_POINT_TIMED = ((NUM_CHAINS, 690, 15), (NUM_CHAINS, 1000, 25))
# The yardstick is the plain version in float64 on the same float32 inputs: a kernel's largest error against it
# must be at most twice the float32 plain version's, plus this absolute floor.
FIXED_POINT_FLOOR = 1e-5
FIXED_POINT_JITTER_NON_PD = -1.001  # x 1/alpha: a chain whose v are all 0 has G = -0.001 I / alpha (not PD)
FIXED_POINT_WIDTHS = (3, 7, 8, 10, 14, 15, 25)  # registers and spill reported (10: capacity 16); none may spill at 15 or 25
FIXED_POINT_NO_SPILL = (15, 25)  # the main path's width and german's
# At (256, 20000, 15), K4's largest error against the yardstick must stay below that of the earlier K4 whose sums
# over the rows ran in sequence, and within a small multiple of the float32 loops' error in the same run (blocked
# sums, as cuBLAS's are; PERF.md: 1.52e-7 against the loops' 1.40e-7).
FIXED_POINT_LARGE_N = (256, 20000, 15)
FIXED_POINT_LARGE_N_K4_BEFORE = 6.2e-6
FIXED_POINT_LARGE_N_LOOPS_MULTIPLE = 4

# Counted kernels that a run's counts list only where they launched (a Gibbs, StochVol or BLR RMHMC run).
SOMETIMES_COUNTED = (*GIBBS_COUNTED, BIDIAG, PCR, *FIXED_POINT_COUNTED)


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


GRAPH_REPLAYS = 3  # replays of a captured step under torch.profiler: the launch counters against the device's events
LAUNCHES_COUNTED_BY = ("each wrapper's device counter (ops.launches), added to beside its launch, so inside the "
                       "step's CUDA graph at every replay; replays held against torch.profiler's device events "
                       "(phases 5 and 13)")


def replay_launches(kernel, state, replays: int = GRAPH_REPLAYS, sessions: int = 3) -> dict:
    """``replays`` replays of the graph the runner captured for ``kernel``'s
    step on states like ``state``, under torch.profiler: the launches of the
    hand-written kernels that their device counters counted, and those
    kernels' device events that the profiler saw.  Each session has a
    warm-up cycle of one replay, whose events are dropped: late in a long
    process, sessions without one saw fewer device events than the counters
    counted (PERF.md, PR 10).  A session whose events still differ from the counters is run
    again, up to ``sessions`` in all (the profiler now and then drops an
    event, as in ``device_us``); every session's events are returned.  Fails
    where no graph was captured."""
    from torch.profiler import ProfilerActivity, profile, schedule

    entry = rt.parallel.graphs.lookup(kernel.step, None, state)
    check(entry is not None, "no captured graph of the step: the run did not take the captured path")
    names = {**KERNEL_NAMES, "fhn_sensitivities": FHN_KERNEL_NAME, **GIBBS_KERNEL_NAMES, BIDIAG: BIDIAG_KERNEL_NAME,
             PCR: PCR_KERNEL_NAME, **FIXED_POINT_KERNEL_NAMES}
    gen = torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED)
    seen = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            entry.scan(gen, state, 1, False)  # the warm-up cycle
            rt.ops.launches.reset()
            torch.cuda.synchronize()
            prof.step()
            entry.scan(gen, state, replays, False)
            torch.cuda.synchronize()
            prof.step()
        counted = {**hl.launch_counts(), "fhn_sensitivities": sum(rt.ops.fhn_sens.launch_counts().values()),
                   **rt.ops.launches.counts(SOMETIMES_COUNTED)}
        device = [e.name for e in prof.events() or () if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append({name: sum(part in event for event in device) for name, part in names.items()})
        if seen[-1] == counted:
            break
    rt.ops.launches.reset()
    return {"replays": replays, "counted": counted, "profiler_seen": seen, "equal": seen[-1] == counted}


# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# bytes per second, and float32 operations per second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_us(name: str, c: int, d: int) -> tuple[float, str]:
    """The least microseconds the card could take for kernel ``name`` on a
    (C, D, D) float32 batch, and which side gives it.  Bytes: each input read
    once, each output written once (K1: G in, L out; K2: G and b in, x and
    log|G| out; K3: G in, L, G^-1 and 1/2 log|G| out).  Operations: ~D^3/3
    for the factor, 2 D^2 more for K2's two substitutions, and for K3 ~D^3/3
    more for L^-1 and ~D^3/3 for L^-T L^-1, per chain."""
    floats = {"cholesky": 2 * c * d * d, "chol_solve_logdet": c * d * d + 2 * c * d + c,
              "chol_inv_logdet": 3 * c * d * d + c}[name]
    ops = c * d**3 / 3 * (3 if name == "chol_inv_logdet" else 1) + (2 * c * d * d if name == "chol_solve_logdet" else 0)
    by_bytes, by_ops = 1e6 * 4 * floats / HBM_BYTES_PER_S, 1e6 * ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def bidiag_bound_us(b: int, t: int) -> tuple[float, str]:
    """T1's least microseconds on (B, T), and which side gives it.  Bytes: diag and off read once, ld and e
    written once (2 B (2 T - 1) floats).  Operations: a division, a multiply-add and a square root a position
    (3 B (T - 1) + B).  Neither sees that each chain's positions are one dependent sequence."""
    by_bytes = 1e6 * 4 * 2 * b * (2 * t - 1) / HBM_BYTES_PER_S
    by_ops = 1e6 * (3 * b * (t - 1) + b) / FP32_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def pcr_bound_us(b: int, t: int) -> tuple[float, str]:
    """T2's least microseconds on (B, T), and which side gives it.  Bytes: diag and b read once, x written
    once, and off StochVol's expanded view, one float a row (3 B T + B floats).  Operations: two divisions,
    six products, four sums and two negations a position and round, ceil(log2 T) rounds, and the last
    division a position.  Neither sees that the rounds depend on each other."""
    rounds = (t - 1).bit_length()
    by_bytes = 1e6 * 4 * (3 * b * t + b) / HBM_BYTES_PER_S
    by_ops = 1e6 * b * t * (14 * rounds + 1) / FP32_OPS_PER_S
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


def phase_build() -> dict:
    """Build the kernels and check the ptxas report; returns T1's and T2's registers and spill stores."""
    t0 = time.perf_counter()
    lib_path = _build.build()
    hl._lib()  # load and bind
    seconds = time.perf_counter() - t0
    log = (lib_path.parent / "ptxas.log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    stack = [int(s) for s in re.findall(r"(\d+) bytes stack frame", log)]
    check(regs, "ptxas report names no kernel")
    for source in (SOURCE, FHN_SOURCE, GIBBS_SOURCE, BIDIAG_SOURCE, FIXED_POINT_SOURCE):  # the kernels line's sources
        check((Path(__file__).resolve().parent / source).is_file(), f"kernel source {source} is not in the checkout")
    # Registers and spill stores per kernel and width, from the mangled names: K1 / K2 / K3, the rows
    # the instantiation is unrolled for, "rt" where the width comes at run time.
    linalg_found = re.findall(r"(cholesky_kernel|chol_solve_logdet_kernel|chol_inv_logdet_kernel)INS_5WidthILi(\d+)"
                              r"ELb([01])E.*?(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
    short = {"cholesky_kernel": "K1", "chol_solve_logdet_kernel": "K2", "chol_inv_logdet_kernel": "K3"}
    per_kernel = {f"{short[name]}<{n}{'' if exact == '1' else ',rt'}>": int(r) for name, n, exact, _, r in linalg_found}
    linalg_spills = {f"{short[name]}<{n}{'' if exact == '1' else ',rt'}>": int(sp)
                     for name, n, exact, sp, _ in linalg_found if int(sp)}
    check(len(per_kernel) == 3 * (len(hl.EXACT_WIDTHS) + len(hl.CAPACITIES)),
          f"ptxas report names {sorted(per_kernel)}: expected K1, K2 and K3 at every width and capacity")
    k3_spills = {name: sp for name, sp in linalg_spills.items() if name.startswith("K3")}
    check(not k3_spills, f"K3 spills at {k3_spills}: expected none at any width or capacity")
    bidiag_found = re.findall(rf"{BIDIAG_KERNEL_NAME}.*?(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
    check(len(bidiag_found) == 1, f"ptxas report names {len(bidiag_found)} {BIDIAG_KERNEL_NAME}, expected one")
    bidiag_regs = {"registers": int(bidiag_found[0][1]), "spill_store_bytes": int(bidiag_found[0][0])}
    # T2: the shared-memory form per positions a thread, the device-memory form per (first, last) round.
    pcr_found = re.findall(r"(pcr_solve_kernel|pcr_solve_global_kernel)I(?:Li(\d+)E|Lb([01])ELb([01])E)E"
                           r".*?(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
    pcr_regs = {(f"{name}<{per}>" if per else f"{name}<{first},{last}>"): {"registers": int(r),
                                                                            "spill_store_bytes": int(sp)}
                for name, per, first, last, sp, r in pcr_found}
    expected = [*(f"pcr_solve_kernel<{per}>" for per in (1, 2, 4, 8, 16)),
                *(f"pcr_solve_global_kernel<{f},{l}>" for f, l in ((1, 0), (0, 0), (0, 1)))]
    check(len(pcr_found) == len(expected) and sorted(pcr_regs) == sorted(expected),
          f"ptxas report names T2 kernels {sorted(pcr_regs)}, expected one each of {expected}")
    for t in PCR_GEOMETRY_T:
        mirror, built = rt.ops.tridiag.pcr_geometry(t), rt.ops.tridiag.built_pcr_geometry(t)
        check(mirror == built, f"T2 launch geometry at T={t}: Python {mirror}, built library {built}")
    # The FHN kernel per order and data path (staged in shared memory, or streamed past STAGED_MAX_OBS):
    # registers and spill stores (none expected), exactly one instantiation of each.
    fhn_found = re.findall(rf"{FHN_KERNEL_NAME}ILi(\d)ELb([01])EE.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                           log, re.S)
    fhn_kinds = sorted((int(order), int(kind)) for order, kind, _, _ in fhn_found)
    check(fhn_kinds == [(order, kind) for order in rt.ops.fhn_sens.ORDERS for kind in (0, 1)],
          f"ptxas report names FHN kernels {fhn_kinds}, expected one each of orders {rt.ops.fhn_sens.ORDERS} "
          "staged and streamed")
    fhn_regs = {f"fhn<{order}{'' if kind == '1' else ',streamed'}>": {"registers": int(r), "spill_store_bytes": int(sp)}
                for order, kind, sp, r in fhn_found}
    # G1 per count of B's entries a lane holds (one instantiation for each of 1..SWEEP_ENT_MAX, with and
    # without the prologue of a chain on a whole warp, and on a block of warps), its wide layout with B in
    # memory (shared or the output buffer), G2 and the single round: registers and spill stores.  G1 spills in
    # none but G1_SPILLS: SWEEP_ENT_MAX is the most entries a lane holds in registers.
    gibbs_found = re.findall(r"(gibbs_sweep_kernel|gibbs_sweep_block_kernel|gibbs_sweep_memory_kernel|gig_half_kernel"
                             r"|gig_round_kernel)(?:I(?:Li(\d+)E)?(?:Lb([01])E)?E)?.*?(\d+) bytes spill stores.*?"
                             r"Used (\d+) registers", log, re.S)
    gibbs_names = {"0": "", "1": ",prologue"}
    gibbs_regs = {
        (f"{name}<{ent}{gibbs_names[flag] if flag else ''}>" if ent else f"{name}<{'shared' if flag == '1' else 'global'}>"
         if flag else name): {"registers": int(r), "spill_store_bytes": int(sp)}
        for name, ent, flag, sp, r in gibbs_found}
    expected = [*(f"gibbs_sweep_kernel<{e}{pro}>" for e in range(1, gibbs.SWEEP_ENT_MAX + 1)
                  for pro in gibbs_names.values()),
                *(f"gibbs_sweep_block_kernel<{e}>" for e in range(1, gibbs.SWEEP_ENT_MAX + 1)),
                "gibbs_sweep_memory_kernel<shared>", "gibbs_sweep_memory_kernel<global>", "gig_half_kernel",
                "gig_round_kernel"]
    check(len(gibbs_found) == len(expected) and sorted(gibbs_regs) == sorted(expected),
          f"ptxas report names Gibbs kernels {sorted(gibbs_regs)}, expected one each of {expected}")
    g1_spills = {name: row["spill_store_bytes"] for name, row in gibbs_regs.items()
                 if name.startswith("gibbs_sweep") and row["spill_store_bytes"]}
    check(g1_spills == G1_SPILLS, f"G1 spills {g1_spills} at SWEEP_ENT_MAX = {gibbs.SWEEP_ENT_MAX}, "
                                  f"expected {G1_SPILLS}")
    built_ent_max = gibbs._lib().rhmc_gibbs_sweep_max_entries()
    check(built_ent_max == gibbs.SWEEP_ENT_MAX,
          f"G1's entries a lane: Python SWEEP_ENT_MAX {gibbs.SWEEP_ENT_MAX}, built {built_ent_max}")
    for c, n in ((1, 1), (1025, 690), (8448, 1000)):
        for lanes in (*gibbs.SWEEP_LANES, *(gibbs.SWEEP_THREADS * w for w in range(2, gibbs.SWEEP_MEMORY_WARPS + 1))):
            mirror = gibbs.sweep_scratch_numel(c, n, lanes)
            built = gibbs._lib().rhmc_gibbs_sweep_scratch_floats(c, n, lanes)
            check(mirror == built, f"G1 scratch at C={c}, N={n}, {lanes} lanes: Python {mirror}, built {built}")
    for d in (1, 1089, 12_288, 58_046, 58_047, 100_000):
        mirror, built = gibbs.sweep_shared_bytes(d), gibbs._lib().rhmc_gibbs_sweep_shared_bytes(d)
        check(mirror == built, f"G1's shared memory a block at D={d}: Python {mirror}, built {built}")
    # K4 / K5 per width (the rows unrolled, "rt" where the width comes at run time): registers and spill
    # stores, none at D 15; their layouts against the built library's at phase 3's shapes and past the cut-overs.
    fp_found = re.findall(r"(position_fixed_point_kernel|momentum_fixed_point_kernel)INS_5WidthILi(\d+)ELb([01])E"
                          r".*?(\d+) bytes spill stores.*?Used (\d+) registers", log, re.S)
    fp_short = {"position_fixed_point_kernel": "K4", "momentum_fixed_point_kernel": "K5"}
    fp_regs = {f"{fp_short[name]}<{n}{'' if exact == '1' else ',rt'}>": {"registers": int(r), "spill_store_bytes": int(sp)}
               for name, n, exact, sp, r in fp_found}
    fp_served = [*hl.EXACT_WIDTHS, *(cap for cap in hl.CAPACITIES if cap <= 16)]  # lfp.kernel_width's
    check(len(fp_found) == len(fp_regs) == 2 * len(fp_served),
          f"ptxas report names K4 / K5 {sorted(fp_regs)}: expected one of each at the widths and capacities "
          f"{fp_served}")
    for k in ("K4", "K5"):
        for w in FIXED_POINT_NO_SPILL:
            check(fp_regs[f"{k}<{w}>"]["spill_store_bytes"] == 0, f"{k} spills at D {w}: {fp_regs[f'{k}<{w}>']}")
    for name in FIXED_POINT_COUNTED:
        for n, d in [(n, d) for _, n, d in FIXED_POINT_SHAPES] + [(1, 1), (690, 7), (532, 8), (20000, 10),
                                                                  (50000, 3), (300, 16), (12000, 25), (2048, 15)]:
            mirror, built = lfp.launch_geometry(name, n, d), lfp.built_launch_geometry(name, n, d)
            check(mirror == built, f"{name} layout at N={n}, D={d}: Python {mirror}, built library {built}")
        for d in (17, 20, 26, 48):  # widths the kernels do not serve: both refuse them
            try:
                lfp.built_launch_geometry(name, 690, d)
                refused = False
            except RuntimeError:
                refused = True
            check(refused and not lfp.kernel_width(d), f"{name} at D={d}: the built library did not refuse it")
    for d in range(1, hl.MAX_DIM + 1):
        mirror, built = hl.launch_geometry(d), hl.built_launch_geometry(d)
        check(mirror == built, f"launch geometry at D={d}: Python mirror {mirror}, built library {built}")
        mirror, built = hl.k3_geometry(d), hl.built_k3_geometry(d)
        check(mirror == built, f"K3 geometry at D={d}: Python mirror {mirror}, built library {built}")
    k3_grids = {}
    for c, d in K3_GRID_SHAPES:
        blocks, resident = hl.built_k3_grid(c, d)
        check(blocks == hl.k3_blocks(c, d, resident),
              f"K3 grid at C={c}, D={d}: built {blocks} blocks of {resident} resident, mirror {hl.k3_blocks(c, d, resident)}")
        k3_grids[f"C{c}_D{d}"] = {"blocks": blocks, "resident_blocks": resident,
                                  "tiles_per_warp_most": max(map(len, hl.k3_schedule(c, d, blocks)))}
    for order in rt.ops.fhn_sens.ORDERS:
        for c in FHN_GEOMETRY_CHAINS:
            mirror = rt.ops.fhn_sens.launch_geometry(order, c, FHN_OBS)
            built = rt.ops.fhn_sens.built_launch_geometry(order, c, FHN_OBS)
            check(mirror == built, f"FHN launch geometry at order {order}, C={c}: Python {mirror}, built {built}")
        mirror, built = rt.ops.fhn_sens.output_owners(order), rt.ops.fhn_sens.built_output_owners(order)
        check(mirror == built, f"FHN output owners at order {order}: Python {mirror}, built {built}")
    say("build", seconds=seconds, library=str(lib_path), kernels=len(regs),
        max_registers=max(regs), max_spill_store_bytes=max(spills, default=0),
        max_stack_frame_bytes=max(stack, default=0), registers=per_kernel, spill_store_bytes=linalg_spills,
        bidiag_kernel=bidiag_regs, pcr_kernels=pcr_regs, fhn_kernel=fhn_regs,
        gibbs_kernels=gibbs_regs, fixed_point_kernels={k: fp_regs[k] for k in sorted(fp_regs)},
        geometry={d: tuple(hl.launch_geometry(d)) for d in (3, 10, 15, 25, 48)},
        k3_geometry={d: tuple(hl.k3_geometry(d)) for d in (3, 10, 15, 25, 48)}, k3_grids=k3_grids,
        fhn_geometry={order: tuple(rt.ops.fhn_sens.launch_geometry(order, FHN_CHAINS, FHN_OBS))
                      for order in rt.ops.fhn_sens.ORDERS})
    return {BIDIAG: bidiag_regs, PCR: pcr_regs, "fixed_point": fp_regs}


# G1's spill stores by instantiation, bytes: 25 entries a lane without the prologue spills 4 B at 168
# registers, as in earlier builds of this loop; every other none.
G1_SPILLS = {"gibbs_sweep_kernel<25>": 4}
# Device kernels by the name torch.profiler shows them under.
KERNEL_NAMES = {"cholesky": "cholesky_kernel", "chol_solve_logdet": "chol_solve_logdet_kernel",
                "chol_inv_logdet": "chol_inv_logdet_kernel"}
# BLR australian, german; StochVol hyper; FHN; joint LGC hyper; australian at the bench's second chain count
TIMED_SHAPES = ((NUM_CHAINS, 15), (NUM_CHAINS, 25), (NUM_CHAINS, 3), (1024, 3), (256, 3), (4, 2), (2 * NUM_CHAINS, 15))
# K3's grid against its mirror: the timed shapes, a partial last tile, and more tiles than the card holds at once
# Widths whose K3 instantiations run its factor's exact path once on scaled metrics: every exact width, and a width
# of each run-time capacity a width reaches (4: D 2; 16: D 10; 32: D 20; 48: D 40; no width reaches capacity 8)
K3_FALLBACK_WIDTHS = (15, 25, 3, 5, 6, 7, 8, 14, 2, 10, 20, 40)
K3_GRID_SHAPES = ((NUM_CHAINS, 15), (NUM_CHAINS, 25), (NUM_CHAINS, 3), (NUM_CHAINS + 3, 3), (8 * NUM_CHAINS + 1, 15),
                  (NUM_CHAINS + 1, 40), (1, 48))


def non_pd_chains(c: int, d: int, k3_blocks: int) -> list[int]:
    """Chains to spoil: K1 / K2's block edges (the first chain of a block,
    the middle of the next, the last of the one after, blocks near C/2), K3's
    tile edges (the first, middle and last chain of a warp's tile, tiles near
    C/3, and the first and last chain of the last tile that the first block's
    last warp walks on K3's grid of ``k3_blocks`` blocks), and the batch's
    last chain; one middle chain where the batch is smaller than 8 blocks."""
    per_block = hl.launch_geometry(d).chains_per_block
    if c < 8 * per_block:
        return [c // 2]
    block = (c // 2) // per_block
    k1 = [block * per_block, (block + 1) * per_block + per_block // 2, (block + 3) * per_block - 1]
    geo = hl.k3_geometry(d)
    per_tile, tile = geo.chains_per_warp, (c // 3) // geo.chains_per_warp
    k3 = [tile * per_tile, (tile + 1) * per_tile + per_tile // 2, (tile + 3) * per_tile - 1]
    last = hl.k3_schedule(c, d, k3_blocks)[geo.warps_per_block - 1][-1]
    k3 += [last * per_tile, min(c, (last + 1) * per_tile) - 1]
    return sorted({*k1, *k3, c - 1})


def check_kernels(c: int, d: int, err: dict) -> None:
    """K1 and K2 against their twins on one seeded batch with non-PD chains in it."""
    g, b = spd_batch(c, d, seed=1000 * d + c)
    bad = non_pd_chains(c, d, hl.built_k3_grid(c, d)[0])
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

    # K3: K1's factor bit for bit (NaN chains too), an exactly symmetric inverse, each output against the twin.
    (l3, inv3, half3), (lp3, invp3, halfp3) = hl.chol_inv_logdet_cuda(g), hl.chol_inv_logdet_plain(g)
    torch.cuda.synchronize()
    check(torch.equal(l3.view(torch.int32), lk.view(torch.int32)), f"K3's factor is not K1's bit for bit {at}")
    check(all(bool(torch.isfinite(x[ok]).all()) for x in (l3, inv3, half3)), f"K3 non-finite on a PD chain {at}")
    check(not any(bool(torch.isfinite(x[bad]).flatten(1).all(1).any()) for x in (l3, inv3, half3[:, None])),
          f"K3 finite on a non-PD chain {at}")
    check(torch.equal(inv3[ok], inv3[ok].mT), f"K3's inverse not exactly symmetric {at}")
    check(torch.equal(inv3[ok], hl.inv_in_kernel_order(l3)[ok]), f"K3's inverse is not its replay's bit for bit {at}")
    errs = [excess(k[ok], p[ok], TOL[name]) for k, p, name in ((l3, lp3, "L"), (inv3, invp3, "inv"),
                                                               (half3, halfp3, "logdet"))]
    check(all(over <= 0 for _, over in errs), f"K3 vs twin beyond tolerance at {at}: max |err| L, inv, "
                                             f"half logdet {[e for e, _ in errs]}")
    err["chol_inv_logdet"] = max(err["chol_inv_logdet"], *(e for e, _ in errs))


def check_operand_forms(c: int, d: int) -> None:
    """An operand off 16-byte alignment (the kernels' 4-byte copy path) and a
    strided one (the wrapper's one copy) give the bits of the plain call."""
    g, b = spd_batch(c, d, seed=77)
    l0, (x0, ld0), k3 = hl.cholesky_cuda(g), hl.chol_solve_logdet_cuda(g, b), hl.chol_inv_logdet_cuda(g)
    flat = torch.empty(g.numel() + 1, device=DEVICE)
    shifted = flat[1:].view_as(g).copy_(g)
    check(shifted.data_ptr() % 16 != 0 and shifted.is_contiguous(), "the shifted operand is 16-byte aligned")
    wide = torch.zeros((c, d + 1, d + 2), device=DEVICE)
    wide[:, :d, :d] = g
    strided = wide[:, :d, :d]
    check(not strided.is_contiguous(), "the strided operand is contiguous")
    for form, gf in (("unaligned", shifted), ("strided", strided)):
        lf, (xf, ldf), k3f = hl.cholesky_cuda(gf), hl.chol_solve_logdet_cuda(gf, b), hl.chol_inv_logdet_cuda(gf)
        torch.cuda.synchronize()
        check(torch.equal(lf, l0) and torch.equal(xf, x0) and torch.equal(ldf, ld0)
              and all(torch.equal(u, v) for u, v in zip(k3f, k3)),
              f"{form} operand at C={c}, D={d}: result differs from the aligned contiguous one")


def check_k3_outside_fast_range(c: int, d: int) -> None:
    """K3 on metrics whose every chain leaves its factor's fast range (entries near 2^-70 or 2^70): the
    factor again with the IEEE square root and division, L bit for bit K1's, the inverse its replay's."""
    g, _ = spd_batch(c, d, seed=7 * d + c)
    for scale in (2.0**-70, 2.0**70):
        gs = g * scale
        lk, (l3, inv3, _) = hl.cholesky_cuda(gs), hl.chol_inv_logdet_cuda(gs)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lk).all()), f"K1 non-finite on G x {scale} at C={c}, D={d}")
        check(torch.equal(l3, lk) and torch.equal(inv3, inv3.mT) and torch.equal(inv3, hl.inv_in_kernel_order(l3)),
              f"K3 on G x {scale} at C={c}, D={d}: factor not K1's, inverse not symmetric or not its replay's")


def library_cholesky(g):
    return torch.linalg.cholesky_ex(g)[0]


def library_solve_logdet_sequence(g, b):
    l = torch.linalg.cholesky_ex(g)[0]
    x = torch.cholesky_solve(b[..., None], l)[..., 0]
    return x, 2.0 * torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)


def library_inv_logdet_sequence(g):
    l = torch.linalg.cholesky_ex(g)[0]
    return l, torch.cholesky_inverse(l), torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)


def time_kernels(c: int, d: int) -> dict:
    """Both kernels' times at one shape, beside twin, bound and library yardstick."""
    g, b = spd_batch(c, d, seed=d)
    l, x, logdet = torch.empty_like(g), torch.empty_like(b), torch.empty(c, device=DEVICE)
    inv, half_logdet = torch.empty_like(g), torch.empty(c, device=DEVICE)
    lib = hl._lib()
    calls = {
        "cholesky": (lambda: hl.cholesky_cuda(g), lambda: hl.cholesky_plain(g),
                     lambda: hl._launch("cholesky", lib.rhmc_cholesky, (g, l), c, d),
                     "library_ms", lambda: library_cholesky(g)),
        "chol_solve_logdet": (lambda: hl.chol_solve_logdet_cuda(g, b), lambda: hl.chol_solve_logdet_plain(g, b),
                              lambda: hl._launch("chol_solve_logdet", lib.rhmc_chol_solve_logdet,
                                                 (g, b, x, logdet), c, d),
                              "library_seq_ms", lambda: library_solve_logdet_sequence(g, b)),
        "chol_inv_logdet": (lambda: hl.chol_inv_logdet_cuda(g), lambda: hl.chol_inv_logdet_plain(g),
                            lambda: hl._launch("chol_inv_logdet", lib.rhmc_chol_inv_logdet,
                                               (g, l, inv, half_logdet), c, d),
                            "library_seq_ms", lambda: library_inv_logdet_sequence(g)),
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
    out["chol_inv_logdet"]["library_seq_note"] = K3_LIBRARY_NOTE
    return out


def phase_kernels(smi: str) -> dict:
    """K1, K2 and K3 against their twins; returns per-kernel max |err| and times."""
    err = dict(NO_LINALG)
    shapes = [(c, d) for d in (3, 7, 10, 15, 25) for c in (NUM_CHAINS, NUM_CHAINS + 1)] + [(SV_CHAINS, 3), (FHN_CHAINS, 3)]
    shapes += [(LGCJ_CHAINS, 2), (NUM_CHAINS + 1, 2)]  # the joint LGC hyper block's width
    # 40: two rows a lane; C + 3 at D = 3: K3's last tile 3 of 8 chains; 8 C + 1 at D = 15: more of K3's tiles
    # than the card holds at once, so its warps walk several, each with the next one's G arriving
    for c, d in shapes + [(NUM_CHAINS + 1, 40), (NUM_CHAINS + 3, 3), (8 * NUM_CHAINS + 1, 15)]:
        check_kernels(c, d, err)
    for c, d in ((NUM_CHAINS + 1, 15), (NUM_CHAINS, 8), (NUM_CHAINS + 1, 40)):
        check_operand_forms(c, d)
    for d in K3_FALLBACK_WIDTHS:
        check_k3_outside_fast_range(NUM_CHAINS + 1, d)
    say("kernels", checked="K1, K2, K3: C in (4096, 4097) x D in (3, 7, 10, 15, 25), C in (1024, 256) x D=3, C in (4, 4097) x D=2, C=4097 x D=40, "
        "C=4099 x D=3 and C=32769 x D=15, non-PD chains in each (first, middle, last of a K1 / K2 block and of a K3 tile; "
        "the last tile K3's first block's last warp walks; last of the batch; one of the 4 at C=4); unaligned and strided operands at D in (15, 8, 40); "
        "K3's factor bit for bit K1's, its inverse exactly symmetric and bit for bit hl.inv_in_kernel_order's replay, "
        f"also on G x 2^-70 and x 2^70 (C=4097, D in {K3_FALLBACK_WIDTHS}: its factor's exact path at every instantiation "
        "a width reaches)",
        max_abs_err={k: err[k] for k in LINALG_COUNTED}, tolerance_rtol_atol=TOL)

    times = {}
    for c, d in TIMED_SHAPES:
        times[c, d] = time_kernels(c, d)
        for name, row in times[c, d].items():
            say("kernel-times", kernel=name, C=c, D=d, card=smi, **row)
    return {"err": err, "times": times}


# -- K4 / K5: BLR RMHMC's two fixed points ----------------------------------------


def fixed_point_bound_us(name: str, c: int, n: int, d: int, rounds: int) -> tuple[float, str]:
    """K4's (``position_fixed_point``) or K5's least microseconds for ``rounds`` rounds on C chains and N rows of
    width D, and which side gives it.  Bytes: each input read once, the output written once (K4: X, w, pm, u0
    and dt in, wf out; K5: X, G^-1, c, p, pm0, base and dt in, pm out).  Operations, a chain and round: K4
    2 N D for the logits and N D (D + 1) for G's lower triangle (G is symmetric: D (D + 1) / 2 multiply-adds
    a row), D^3 / 3 for the factor and 2 D^2 for the two substitutions; K5 2 D^2 for u = G^-1 pm, 2 N D each
    for X u and for the sum of c (x_n u)^2 x_n, and 3 N for the weights."""
    if name == "position_fixed_point":
        floats = n * d + 4 * c * d + c
        ops = c * rounds * (2 * n * d + n * d * (d + 1) + d**3 / 3 + 2 * d * d)
    else:
        floats = n * d + c * d * d + c * n + 4 * c * d + c
        ops = c * rounds * (2 * d * d + 4 * n * d + 3 * n)
    by_bytes, by_ops = 1e6 * 4 * floats / HBM_BYTES_PER_S, 1e6 * ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def fixed_point_inputs(c: int, n: int, d: int, seed: int) -> dict:
    """A BLR model on seeded synthetic data of (N, D), a float64 copy of it, and the fixed points' inputs as the
    sampler makes them at C chains around the MAP: w, G^-1 (K3), the dG weights c, a momentum p ~ N(0, G),
    the force's base, u0 = G^-1 p (and its Student-t scaling), dt = +-0.5 by a coin a chain."""
    ds = rt.models.synthetic_logreg(seed=seed, n=n, d=d)
    model = rt.interop.logreg_from_numpy(ds.X, ds.t, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    w = rt.utils.default_init(model, gen, c)
    ms = model.manifold_state(w)
    chol, inv, _ = hl.chol_inv_logdet_cuda(ms.metric)
    p = rt.ops.mvn_sample(chol, torch.randn((c, d), generator=gen, device=DEVICE))
    dt = torch.where(torch.rand(c, generator=gen, device=DEVICE) < 0.5, 0.5, -0.5)
    u0 = torch.einsum("...ab,...b->...a", inv, p)
    u0_t = (1.0 + d) * u0 / (1.0 + torch.sum(p * u0, dim=-1, keepdim=True))
    return {"model": model, "model64": rt.models.LogisticRegression(model.X.double(), model.t.double(), model.alpha),
            "w": w, "inv": inv, "cache": ms.cache, "p": p, "dt": dt, "u0": u0, "u0_t": u0_t,
            "base": ms.grad - 0.5 * model.dg_trace(w, inv, cache=ms.cache)}


def fixed_point_calls(inp: dict, name: str, st: bool, rounds: int, jitter: float = 0.0, **swap) -> tuple:
    """(kernel, float32 plain, float64 plain) of one K4 or K5 call on ``inp`` (``swap`` replaces inputs): the
    plain versions are the loops the sampler ran before the kernels (float32: the solve by K2; float64: the
    unrolled solve on float64 copies of the same float32 inputs)."""
    a = {**inp, **swap}
    if name == "position_fixed_point":
        args = (a["w"], a["p"], a["u0_t"] if st else a["u0"], a["dt"])
        kw = dict(rounds=rounds, student_t=st, jitter=jitter)
        return (lambda: lfp.position_fixed_point_cuda(a["model"].X, *args, alpha=a["model"].alpha, **kw),
                lambda: lfp.position_fixed_point_plain(a["model"], *args, **kw),
                lambda: lfp.position_fixed_point_plain(a["model64"], *(x.double() for x in args), method="unrolled",
                                                       **kw))
    pm0 = a.get("pm0", a["p"])
    args = (a["inv"], a["cache"], a["p"], pm0, a["base"], a["dt"])
    kw = dict(rounds=rounds, student_t=st)
    return (lambda: lfp.momentum_fixed_point_cuda(a["model"].X, *args, **kw),
            lambda: lfp.momentum_fixed_point_plain(a["model"], a["w"], *args, **kw),
            lambda: lfp.momentum_fixed_point_plain(a["model64"], a["w"].double(), *(x.double() for x in args), **kw))


def held(label: str, kernel: torch.Tensor, plain: torch.Tensor, plain64: torch.Tensor, ok: torch.Tensor) -> dict:
    """The kernel's and the float32 plain version's largest errors against the float64 plain version over the
    chains ``ok``; the kernel's must be finite and at most twice the plain version's plus FIXED_POINT_FLOOR."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(kernel[ok]).all()), f"{label}: non-finite output on a chain that should be finite")
    e_k = float((kernel[ok].double() - plain64[ok]).abs().max())
    e_p = float((plain[ok].double() - plain64[ok]).abs().max())
    check(e_k <= 2 * e_p + FIXED_POINT_FLOOR,
          f"{label}: max |kernel - float64 plain| {e_k} > 2 x max |float32 plain - float64 plain| {e_p} + "
          f"{FIXED_POINT_FLOOR}")
    return {"kernel_err": e_k, "plain_err": e_p}


def check_fixed_point(inp: dict, c: int, n: int, d: int) -> dict:
    """K4, K5 and K5's one-round half-step against the yardstick at (C, N, D), Student-t off and on, dt of both
    signs in each batch; then a chain whose G is not positive definite (K4: its v all 0 under a jitter of
    -1.001 / alpha, so G = -0.001 I / alpha; K5: its G^-1 NaN, as K3 leaves a non-PD G's): non-finite in that chain
    alone, as in the plain version, every other chain bit for bit the batch without it."""
    at, out = f"(C={c}, N={n}, D={d})", {}
    ok = torch.ones(c, dtype=torch.bool, device=DEVICE)
    for st in (False, True):
        for name in FIXED_POINT_COUNTED:
            kern, plain, plain64 = fixed_point_calls(inp, name, st, K)
            out[f"{name}{'/t' if st else ''}"] = held(f"{name} {at} student_t={st}", kern(), plain(), plain64(), ok)
        pm = fixed_point_calls(inp, "momentum_fixed_point", st, K)[1]()
        kern, plain, plain64 = fixed_point_calls(inp, "momentum_fixed_point", st, 1, p=pm, pm0=pm)
        out[f"momentum_half_step{'/t' if st else ''}"] = held(f"momentum half-step {at} student_t={st}", kern(), plain(),
                                                             plain64(), ok)
    bad = c // 2
    ok[bad] = False
    jitter = float(np.float32(FIXED_POINT_JITTER_NON_PD / inp["model"].alpha))
    w_bad = inp["w"].clone()
    w_bad[bad] *= 1e6  # every |x_n . w| past the sigmoid's range: v = 0
    inv_bad = inp["inv"].clone()
    inv_bad[bad] = float("nan")
    for name, swap, kw in (("position_fixed_point", {"w": w_bad}, {"jitter": jitter}),
                           ("momentum_fixed_point", {"inv": inv_bad}, {})):
        clean = fixed_point_calls(inp, name, False, K, **kw)[0]()
        kern, plain, plain64 = fixed_point_calls(inp, name, False, K, **kw, **swap)
        got, want = kern(), plain()
        label = f"{name} {at} non-PD chain {bad}"
        check(not bool(torch.isfinite(got[bad]).all()) and not bool(torch.isfinite(want[bad]).all()),
              f"{label}: finite in the kernel ({bool(torch.isfinite(got[bad]).all())}) or the plain version")
        check(torch.equal(got[ok], clean[ok]), f"{label}: another chain's output changed")
        out[f"{name}/non-pd"] = held(label, got, want, plain64(), ok)
    return out


def graph_of(fn):
    """``fn`` (warmed) captured as one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def time_fixed_point(inp: dict, c: int, n: int, d: int) -> dict:
    """K4, K5 and K5's half-step at (C, N, D): the kernel's own time (torch.profiler), the wrapper's, the plain
    version's eager, and the parent's route (the loops with K2) captured as one graph: its replay's CUDA-event
    time and device time and events (no one PyTorch call computes either function: the parent's route stands
    where a library call would, information only), beside the bound."""
    out = {}
    for label, name, rounds in (("position_fixed_point", "position_fixed_point", K),
                                ("momentum_fixed_point", "momentum_fixed_point", K),
                                ("momentum_half_step", "momentum_fixed_point", 1)):
        kern, plain, _ = fixed_point_calls(inp, name, False, rounds)
        dev = device_us(kern, launches=20, name_part=FIXED_POINT_KERNEL_NAMES[name])
        check(dev["events_per_call"] == 1, f"{label}: {dev['events_per_call']} device kernels per launch")
        graph = graph_of(plain)
        parent = device_us(graph.replay, launches=5)
        bound, bound_by = fixed_point_bound_us(name, c, n, d, rounds)
        out[label] = {
            "rounds": rounds, "ms": median_ms(kern), "burst_ms": burst_ms(kern, launches=50),
            "device_us": dev["us"], "device_us_source": dev["source"], "profiler_sessions": dev["sessions"],
            "plain_ms": median_ms(plain, reps=10), "parent_route_ms": median_ms(graph.replay, reps=10),
            "parent_route_device_us": parent["us"], "parent_route_events": parent["events_per_call"],
            "bound_us": bound, "bound_by": bound_by, "share_of_bound": bound / dev["us"],
        }
        del graph
    return out


def phase_fixed_point_kernels(smi: str, regs: dict) -> dict:
    """K4 and K5 against the yardstick at FIXED_POINT_SHAPES, and their times at FIXED_POINT_TIMED."""
    err, times = dict.fromkeys(FIXED_POINT_COUNTED, 0.0), {}
    for i, (c, n, d) in enumerate(FIXED_POINT_SHAPES):
        inp = fixed_point_inputs(c, n, d, seed=50 + i)
        cases = check_fixed_point(inp, c, n, d)
        for case, row in cases.items():
            name = "position_fixed_point" if case.startswith("position") else "momentum_fixed_point"
            err[name] = max(err[name], row["kernel_err"])
        say("fixed-point-kernels", C=c, N=n, D=d, layout={k: tuple(lfp.launch_geometry(k, n, d))
                                                          for k in FIXED_POINT_COUNTED},
            cases=cases, yardstick="the plain version in float64 on the same float32 inputs",
            tolerance=f"kernel_err <= 2 plain_err + {FIXED_POINT_FLOOR}")
        if (c, n, d) == FIXED_POINT_LARGE_N:  # the blocked sums' accuracy at many rows
            k4 = max(row["kernel_err"] for case, row in cases.items() if case in ("position_fixed_point",
                                                                                  "position_fixed_point/t"))
            loops = max(row["plain_err"] for case, row in cases.items() if case in ("position_fixed_point",
                                                                                    "position_fixed_point/t"))
            say("fixed-point-large-n", C=c, N=n, D=d, k4_err=k4, loops_float32_err=loops,
                k4_err_before=FIXED_POINT_LARGE_N_K4_BEFORE, k4_err_limit_loops_multiple=FIXED_POINT_LARGE_N_LOOPS_MULTIPLE,
                yardstick="the plain version in float64")
            check(k4 < FIXED_POINT_LARGE_N_K4_BEFORE,
                  f"K4 at {FIXED_POINT_LARGE_N}: error {k4} not below {FIXED_POINT_LARGE_N_K4_BEFORE}")
            check(k4 <= FIXED_POINT_LARGE_N_LOOPS_MULTIPLE * loops,
                  f"K4 at {FIXED_POINT_LARGE_N}: error {k4} above {FIXED_POINT_LARGE_N_LOOPS_MULTIPLE} x the float32 "
                  f"loops' {loops}")
        if (c, n, d) in FIXED_POINT_TIMED:
            times[c, n, d] = time_fixed_point(inp, c, n, d)
            for name, row in times[c, n, d].items():
                say("fixed-point-kernel-times", kernel=name, C=c, N=n, D=d, card=smi, **row)
        del inp
    fp_regs = {w: {k: regs["fixed_point"][f"{k}<{w}>" if w in hl.EXACT_WIDTHS else f"{k}<{lfp._unrolled_rows(w)},rt>"]
                   for k in ("K4", "K5")}
               for w in FIXED_POINT_WIDTHS}
    say("fixed-point-registers", widths=fp_regs)
    return {"err": err, "times": times, "registers": fp_regs}


def bidiag_inputs(b: int, t: int, seed: int):
    """A seeded SPD tridiagonal batch shaped as StochVol's latent metric G = iC + I/2 (AR(1) precision at
    sigma in [0.1, 0.5], phi in [0.5, 0.99], one per chain), off an expanded view as the model makes it."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sigma = 0.1 + 0.4 * torch.rand((b, 1), generator=gen, device=DEVICE)
    phi = 0.5 + 0.49 * torch.rand((b, 1), generator=gen, device=DEVICE)
    inv_s2 = 1.0 / sigma**2
    idx = torch.arange(t, device=DEVICE)
    diag = torch.where((idx == 0) | (idx == t - 1), inv_s2, (1.0 + phi**2) * inv_s2) + 0.5
    return diag, (-phi * inv_s2).expand(b, t - 1)


def check_bidiag(b: int, t: int, err: dict, case: str = "metric") -> dict:
    """T1 against its twin at (B, T): ``metric`` (StochVol's), ``non-pd`` (chain B // 2 made indefinite at
    T // 2: NaN from there on in that chain alone) or ``identity`` (HMC's mass: ld 1 and e 0 exactly)."""
    if case == "identity":
        diag, off = torch.ones((b, t), device=DEVICE), torch.zeros((b, t - 1), device=DEVICE)
    else:
        diag, off = bidiag_inputs(b, t, seed=b + t)
    bad = b // 2
    if case == "non-pd":
        diag = diag.clone()
        diag[bad, t // 2] = -1.0
    at = f"T1 at (B={b}, T={t}, {case})"
    kern, plain = rt.ops.tridiag.cholesky_cuda(diag, off), rt.ops.tridiag.cholesky_plain(diag, off)
    torch.cuda.synchronize()
    check(kern.ld.shape == (b, t) and kern.e.shape == (b, t - 1), f"{at}: shapes {kern.ld.shape}, {kern.e.shape}")
    for name, k, p in (("ld", kern.ld, plain.ld), ("e", kern.e, plain.e)):
        check(torch.equal(torch.isnan(k), torch.isnan(p)), f"{at}: {name} has NaN where the twin has not, or not where it has")
    ok = torch.ones(b, dtype=torch.bool, device=DEVICE)
    if case == "non-pd":
        ok[bad] = False
        check(bool(torch.isnan(kern.ld[bad, t // 2:]).all()) and bool(torch.isfinite(kern.ld[bad, : t // 2]).all()),
              f"{at}: the non-PD chain is not NaN from T // 2 on")
    check(bool(torch.isfinite(kern.ld[ok]).all() and torch.isfinite(kern.e[ok]).all()), f"{at}: non-finite on a PD chain")
    if case == "identity":
        check(bool((kern.ld == 1).all() and (kern.e == 0).all()), f"{at}: identity mass not ld 1, e 0 exactly")
    el, over_l = excess(kern.ld[ok], plain.ld[ok], BIDIAG_TOL)
    ee, over_e = excess(kern.e[ok], plain.e[ok], BIDIAG_TOL) if t > 1 else (0.0, 0.0)
    check(over_l <= 0 and over_e <= 0, f"{at}: against the twin beyond {BIDIAG_TOL}: max |err| ld {el}, e {ee}")
    err[BIDIAG] = max(err[BIDIAG], el, ee)
    return {"B": b, "T": t, "case": case, "max_abs_err": max(el, ee),
            "bit_for_bit": torch.equal(kern.ld[ok], plain.ld[ok]) and torch.equal(kern.e[ok], plain.e[ok])}


def phase_bidiag_kernel(smi: str, err: dict, regs: dict) -> dict:
    """T1 against its twin at BIDIAG_SHAPES (and a non-PD chain, the identity mass), then its times at
    BIDIAG_TIMED beside its bound and the twin's."""
    checked = [check_bidiag(b, t, err) for b, t in BIDIAG_SHAPES]
    checked += [check_bidiag(*BIDIAG_TIMED, err, case) for case in ("non-pd", "identity")]
    say("bidiag-kernel", checked=checked, tolerance_rtol_atol=BIDIAG_TOL)
    b, t = BIDIAG_TIMED
    diag, off = bidiag_inputs(b, t, seed=1)  # off StochVol's expanded view, read by the kernel through its strides
    ld, e = torch.empty_like(diag), torch.empty((b, t - 1), device=DEVICE)

    def launch():
        rt.ops.tridiag._launch((diag, off, ld, e), b, t)
    dev = device_us(launch, launches=20, name_part=BIDIAG_KERNEL_NAME)
    check(dev["events_per_call"] == 1, f"T1: {dev['events_per_call']} device kernels per launch")
    wrapper = device_us(lambda: rt.ops.tridiag.cholesky_cuda(diag, off), launches=20)
    bound, bound_by = bidiag_bound_us(b, t)
    times = {
        "ms": median_ms(lambda: rt.ops.tridiag.cholesky_cuda(diag, off), reps=20),
        "burst_ms": burst_ms(lambda: rt.ops.tridiag.cholesky_cuda(diag, off), launches=20, warmup=2),
        "kernel_only_ms": burst_ms(launch, launches=20, warmup=2),
        "device_us": dev["us"], "device_us_source": dev["source"], "profiler_sessions": dev["sessions"],
        "wrapper_device_events": wrapper["events_per_call"],
        "ns_per_position": 1e3 * dev["us"] / t,
        "plain_ms": median_ms(lambda: rt.ops.tridiag.cholesky_plain(diag, off), reps=5, warmup=1),
        "bound_us": bound, "bound_by": bound_by, "share_of_bound": bound / dev["us"], **regs[BIDIAG],
    }
    check(times["wrapper_device_events"] == 1, f"T1's wrapper: {times['wrapper_device_events']} device events a call, "
                                               "expected the kernel alone (no copy of the expanded off)")
    say("bidiag-kernel-times", kernel=BIDIAG, B=b, T=t, card=smi, **times)
    return {"checked": checked, "times": times}


def pcr_meets_subnormals(diag, off, rhs) -> bool:
    """Whether ``solve_plain`` on these inputs shifts a subnormal value (a, c, bb or d) in some round."""
    seen = []
    shift = rt.ops.tridiag._from_before

    def watched(x, s, fill=0.0):
        v = x.abs()
        seen.append((v > 0) & (v < torch.finfo(torch.float32).tiny))
        return shift(x, s, fill)
    rt.ops.tridiag._from_before = watched
    try:
        rt.ops.tridiag.solve_plain(diag, off, rhs)
    finally:
        rt.ops.tridiag._from_before = shift
    return bool(torch.stack([m.any() for m in seen]).any())


def check_pcr(b: int, t: int, case: str = "metric") -> dict:
    """T2 against ``solve_plain`` on the card at (B, T), ``torch.equal`` (the same operations, each rounded
    as PyTorch rounds it): ``metric`` (StochVol's G, off an expanded view), ``identity`` (HMC's mass),
    ``strided-b`` (the metric with b a non-contiguous view, which the wrapper copies), ``decay`` (diag over
    |off| 10 to 1,000 by chain: a and c pass through subnormal values on their way to zero) or ``unit-root``
    (diag 2, off -1: a and c keep their size, so no round leaves x as it was)."""
    gen = torch.Generator(device=DEVICE).manual_seed(7 * b + t)
    if case == "identity":
        diag, off = torch.ones((b, t), device=DEVICE), torch.zeros((b, t - 1), device=DEVICE)
    elif case == "decay":
        scale = 10.0 ** (1.0 + 2.0 * torch.rand((b, 1), generator=gen, device=DEVICE))
        diag = scale * (1.0 + torch.rand((b, t), generator=gen, device=DEVICE))
        off = torch.randn((b, t - 1), generator=gen, device=DEVICE)
    elif case == "unit-root":
        diag, off = torch.full((b, t), 2.0, device=DEVICE), torch.full((b, t - 1), -1.0, device=DEVICE)
    else:
        diag, off = bidiag_inputs(b, t, seed=b + t)
    rhs = torch.randn((b, t), generator=gen, device=DEVICE)
    if case == "strided-b":
        rhs = torch.randn((b, 2 * t), generator=gen, device=DEVICE)[:, ::2]
        check(not rhs.is_contiguous(), "the strided case's b is contiguous")
    x, plain = rt.ops.tridiag.solve_cuda(diag, off, rhs), rt.ops.tridiag.solve_plain(diag, off, rhs)
    torch.cuda.synchronize()
    at = f"T2 at (B={b}, T={t}, {case})"
    check(x.shape == (b, t) and bool(torch.isfinite(x).all()), f"{at}: shape {tuple(x.shape)} or non-finite values")
    if case == "decay":  # the case's point: the rounds meet subnormal values
        check(pcr_meets_subnormals(diag, off, rhs), f"{at}: no subnormal value in the rounds")
    residual = float((rt.ops.tridiag.matvec(diag, off, x) - rhs).abs().max()) if t > 1 else 0.0
    max_err = float((x - plain).abs().max())
    check(torch.equal(x, plain), f"{at}: not bit for bit solve_plain's (max |err| {max_err})")
    return {"B": b, "T": t, "case": case, "bit_for_bit": True, "max_abs_err": max_err,
            "launches_a_call": rt.ops.tridiag.pcr_geometry(t).launches, "max_abs_residual": residual}


def phase_pcr_kernel(smi: str, err: dict, regs: dict) -> dict:
    """T2 against solve_plain at PCR_SHAPES, on PCR_CASES at PCR_TIMED, and past the shared-memory form at
    PCR_LONG; then its times at PCR_TIMED beside its bound and the twin's."""
    checked = [check_pcr(b, t) for b, t in PCR_SHAPES]
    checked += [check_pcr(*PCR_TIMED, case) for case in PCR_CASES]
    checked.append(check_pcr(*PCR_LONG))
    err[PCR] = max(row["max_abs_err"] for row in checked)
    say("pcr-kernel", checked=checked, tolerance="torch.equal")
    b, t = PCR_TIMED
    diag, off = bidiag_inputs(b, t, seed=1)
    rhs = torch.randn((b, t), generator=torch.Generator(device=DEVICE).manual_seed(2), device=DEVICE)
    x = torch.empty_like(rhs)

    def launch():
        rt.ops.tridiag._launch_solve(diag, off, rhs, x, None, b, t)
    dev = device_us(launch, launches=20, name_part=PCR_KERNEL_NAME)
    check(dev["events_per_call"] == 1, f"T2: {dev['events_per_call']} device kernels per launch")
    wrapper = device_us(lambda: rt.ops.tridiag.solve_cuda(diag, off, rhs), launches=20)
    plain = device_us(lambda: rt.ops.tridiag.solve_plain(diag, off, rhs), launches=5)
    bound, bound_by = pcr_bound_us(b, t)
    geometry = rt.ops.tridiag.pcr_geometry(t)
    times = {
        "ms": median_ms(lambda: rt.ops.tridiag.solve_cuda(diag, off, rhs), reps=20),
        "burst_ms": burst_ms(lambda: rt.ops.tridiag.solve_cuda(diag, off, rhs), launches=20, warmup=2),
        "kernel_only_ms": burst_ms(launch, launches=20, warmup=2),
        "device_us": dev["us"], "device_us_source": dev["source"], "profiler_sessions": dev["sessions"],
        "wrapper_device_events": wrapper["events_per_call"],
        "plain_ms": median_ms(lambda: rt.ops.tridiag.solve_plain(diag, off, rhs), reps=5, warmup=1),
        "plain_device_us": plain["us"], "plain_launches": plain["events_per_call"],
        "bound_us": bound, "bound_by": bound_by, "share_of_bound": bound / dev["us"],
        "threads": geometry.threads, "positions_a_thread": geometry.per_thread, "shared_bytes": geometry.shared_bytes,
        **regs[PCR][f"pcr_solve_kernel<{geometry.per_thread}>"],
    }
    check(times["wrapper_device_events"] == 1, f"T2's wrapper: {times['wrapper_device_events']} device events a call")
    long_b, long_t = PCR_LONG
    long_diag, long_off = bidiag_inputs(long_b, long_t, seed=3)
    long_rhs = torch.randn((long_b, long_t), generator=torch.Generator(device=DEVICE).manual_seed(4), device=DEVICE)
    long_dev = device_us(lambda: rt.ops.tridiag.solve_cuda(long_diag, long_off, long_rhs), launches=5,
                         name_part=PCR_KERNEL_NAME)
    times["long"] = {"B": long_b, "T": long_t, "device_us": long_dev["us"], "launches": long_dev["events_per_call"],
                     "bound_us": pcr_bound_us(long_b, long_t)[0]}
    check(long_dev["events_per_call"] == rt.ops.tridiag.pcr_geometry(long_t).launches,
          f"T2 at T={long_t}: {long_dev['events_per_call']} launches a call, expected "
          f"{rt.ops.tridiag.pcr_geometry(long_t).launches}")
    say("pcr-kernel-times", kernel=PCR, B=b, T=t, card=smi, **times)
    return {"checked": checked, "times": times}


def phase_tridiag_kernels(smi: str, regs: dict) -> dict:
    """T1 and T2 against their twins, and their times; returns their max |err|, checks and times."""
    err = {BIDIAG: 0.0, PCR: 0.0}
    return {"err": err, BIDIAG: phase_bidiag_kernel(smi, err, regs), PCR: phase_pcr_kernel(smi, err, regs)}


# -- phase 3, the Gibbs step's kernels: G1 (the sweep) and G2 (a GIG round) ------

# G1 against its plain version at (C, N, D): phase 6's australian shape, german's, an odd C, and
# a width no BLR dataset has (40) on a ragged last block.
SWEEP_SHAPES = ((1024, 690, 15), (1024, 1000, 25), (1025, 690, 15), (257, 200, 40))
# Past K1's 48, each timed: UCI Sonar's shape (208 rows, 60 features and the intercept) and UCI Musk v1's
# (476 rows, 166 features), B in registers; and a width past 32 lanes of SWEEP_ENT_MAX entries, where
# the wide layout runs (SWEEP_DIRECT_MIN_DIM).
SWEEP_WIDE_SHAPES = ((256, 208, 61), (1024, 476, 167), (64, 300, 2049))
# Where both layouts take D, (C, N) and D = 32 lanes of SWEEP_ENT_MAX entries: B in registers on 32 lanes
# (the wrapper's own) against the wide layout on SWEEP_WIDE_WARPS warps with B in registers, in shared memory
# and in the output buffer (SWEEP_BOTH_LAYOUTS: check_sweep's layouts, gibbs_sweep_cuda's keywords); the three
# wide ones bit for bit (the same sums in the same order), each against the plain version and timed.
SWEEP_BOTH_CN = (64, 300)
SWEEP_BOTH_WARPS = 8  # samplers/gibbs.py::SWEEP_WIDE_WARPS (a literal: kernel_ab.py imports this module with an
# earlier checkout's port)
SWEEP_BOTH_LAYOUTS = (None, {"warps": SWEEP_BOTH_WARPS}, {"warps": SWEEP_BOTH_WARPS, "b_memory": "shared"},
                      {"warps": SWEEP_BOTH_WARPS, "b_memory": "global"})
# Past the registers and past the default 48 KB of shared memory a block (B's 4 D bytes), so that the
# wrapper's layout (B in shared memory on SWEEP_MEMORY_WARPS warps) raises the card's opt-in: the wrapper's
# layout against B in the output buffer, bit for bit, each against the plain version.
SWEEP_OPTIN_SHAPE = (4, 64, 12_800)
SWEEP_OPTIN_LAYOUTS = (None, {"b_memory": "global"})
# From this D on, inputs come from the step's conditionals computed here by batched matmuls (V in
# float64, then rounded), not from a BLR model, whose (N, D^2) outer features take N D^2 floats, under a
# prior variance of SWEEP_DIRECT_PRIOR_VARIANCE, a ridge's shrinkage for more features than rows.  Under
# the default 100 with N < D, x_j^T V x_j lies within ~1e-5 of lambda_j, and w_j = h_j / (lambda_j - h_j)
# turns the float32 rounding of the dot into more than the tolerance (at N = 2 D, float32 against float64
# plain sweeps came to 1.01 of it at D = 2049, N = 4096; at 1e-2, N = 300, to 0.056; on the CPU).
SWEEP_DIRECT_MIN_DIM = 1024
SWEEP_DIRECT_PRIOR_VARIANCE = 1e-2
# The tail case: phase 6's shape with the state's z scaled by SWEEP_TAIL_Z_SCALE
# before its conditionals, so that B and the conditional means are that much
# larger and a chain's misfit points sit more than 3 std on the wrong side
# (a > 3: the tail's Rayleigh rounds, which the other shapes' states one
# plain step from init never take).  It must take the tail at some steps,
# and from each of its three rounds.
SWEEP_TAIL_Z_SCALE = 8.0
# |k - p| <= atol + rtol |p| on every z_j and every entry of B.  1e-4 / 1e-4 is
# the CPU tests' tolerance on one truncated normal (tests/test_torch_gibbs.py);
# the sweep carries each step's rounding (the dot's order is cuBLAS's in the
# plain version) into B and every later step, a sum over the 690-1000 steps of
# terms of B's size, ~1e-6 relative.  A step whose value lies within rounding
# of a branch threshold (a = 3, the tail's u <= a / z) can take the other
# branch and change that chain from there on: such a chain may part, and the
# chains that do are counted, at most SWEEP_MAX_PARTED of them.  So can a
# step whose u = ndtr(a) + u' (1 - ndtr(a)) lies within 1e-4 of 1: ndtri's
# slope there, 1 / phi(z) > 7e3, turns one ulp of u into more than the
# tolerance on that one z_j (and B's share of it); ~1% of the chains of a
# sweep at (1024, 690, 15) and (1024, 1000, 25), one z_j each, u between
# 0.99994 and 0.999998 (PERF.md).
SWEEP_TOL = (1e-4, 1e-4)
SWEEP_MAX_PARTED = 0.03  # of the chains
# G2 against its plain version on the same draws at (C, N), r^2 log-uniform
# over [1e-4, 25] (both series), GIG_ZERO_DRAWS exact zeros among the normal
# draws (the y0 = 0 guard).  The accept decisions compare a float32 partial sum
# with a uniform: an element may take the other decision where they lie within
# rounding (at most GIG_MAX_DIFFERING of the elements, counted); every other
# element's lambda and flag equal the plain version's.
GIG_SHAPE = (1024, 690)
GIG_ZERO_DRAWS = 64
GIG_MAX_DIFFERING = 1e-4  # of the elements
GIG_OPS_PER_PENDING = 22  # the proposal (14) and one series body (8), each library call one operation
# The whole GIG draw (kernel gig_half_kernel) against ``sample_gig_half_plain``
# at GIG_SHAPE from one key: every element, then the rows of a chain split
# from GIG_SPLIT_ROW on (global indices from GIG_SPLIT_ROW x N), which must
# also be the whole call's rows bit for bit.  Operations per element and round
# run: the Philox block (10 rounds of 2 multiplies, 2 high halves, 4 xors, 2
# key additions: 100), the four words' maps to uniforms (4 x 4), Box-Muller
# (6), the proposal (14) and one series body (8).
GIG_SPLIT_ROW = 512
GIG_HALF_OPS_PER_ROUND = 100 + 16 + 6 + GIG_OPS_PER_PENDING
GIG_KEY_SEED = 13


class SweepData(NamedTuple):
    """The data G1 reads from a model: X (N, D) and the labels (N,)."""

    X: torch.Tensor
    t: torch.Tensor


def direct_conditionals(data: SweepData, state, prior_variance: float = SWEEP_DIRECT_PRIOR_VARIANCE):
    """``gibbs.conditionals`` without the model's (N, D^2) outer features:
    X^T Lambda^{-1} X by a batched matmul, V by Cholesky in float64."""
    x, d = data.X, data.X.shape[1]
    prec = torch.matmul(x.T[None] / state.lam[:, None, :], x).double()
    prec = prec + torch.eye(d, dtype=prec.dtype, device=DEVICE) / prior_variance
    chol_prec = torch.linalg.cholesky(prec)
    v = torch.cholesky_inverse(chol_prec)
    chol_v = torch.linalg.cholesky(v).float()
    v = v.float()
    s = torch.matmul(v, x.T)
    return gibbs.Conditionals(v, chol_v, s, torch.einsum("cdn,cn->cd", s, state.z / state.lam),
                              torch.einsum("nd,cdn->cn", x, s))


def gibbs_inputs(c: int, n: int, d: int, seed: int, z_scale: float = 1.0):
    """BLR data of (N, D), a Gibbs state one step from init taken through the
    plain versions (so that lambda and z are a step's; z then scaled by
    ``z_scale``), its conditionals and the next sweep's uniforms: (model,
    state, conditionals, noise).  At a shape of SWEEP_DIRECT the data alone
    (``SweepData``) and ``direct_conditionals``, from init at 0."""
    ds = rt.models.synthetic_logreg(seed=seed, n=n, d=d)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    if d >= SWEEP_DIRECT_MIN_DIM:
        model = SweepData(torch.tensor(ds.X, dtype=torch.float32, device=DEVICE),
                          torch.tensor(ds.t, dtype=torch.float32, device=DEVICE))
        half_mean = math.sqrt(2.0 / math.pi)
        z0 = torch.where(model.t == 1.0, half_mean, -half_mean).expand(c, n).clone()
        state = gibbs.GibbsState(torch.zeros((c, d), device=DEVICE), z0, torch.ones((c, n), device=DEVICE))
        conditionals = direct_conditionals
    else:
        model = rt.interop.logreg_from_numpy(ds.X, ds.t, device=DEVICE)
        state = gibbs.build(model).init(rt.utils.default_init(model, gen, c))
        conditionals = gibbs.conditionals
    cond = conditionals(model, state)
    noise = gibbs.draw_noise(gen, state)
    b, z = gibbs.gibbs_sweep_plain(model.X, model.t, state.lam, cond.h, state.z, cond.s, cond.b, noise.sweep)
    beta = b + rt.ops.mvn_sample(cond.chol_v, noise.beta)
    r = torch.sqrt(torch.clamp((z - beta @ model.X.T) ** 2, min=1e-16))
    lam, ok = torch.ones_like(r), torch.zeros(r.shape, dtype=torch.bool, device=DEVICE)
    for _ in range(8):
        gig.gig_round_plain(r, torch.randn(r.shape, generator=gen, device=DEVICE),
                            torch.rand(r.shape, generator=gen, device=DEVICE),
                            torch.rand(r.shape, generator=gen, device=DEVICE), lam, ok)
    state = gibbs.GibbsState(beta, z_scale * z, lam)
    return model, state, conditionals(model, state), truncnorm.draw_noise(gen, (n, c), device=DEVICE)


def sweep_bounds(args, z: torch.Tensor) -> torch.Tensor:
    """Each step's truncation bound a = -sign m / std (C, N), recomputed from
    the plain version's z: B before step j is B_0 plus the updates of the
    steps before it."""
    x, t, lam, h, z_old, s, b0, _ = args
    delta = (z - z_old) / lam
    update = s * delta[:, None, :]  # (C, D, N)
    b_before = b0[:, :, None] + torch.cumsum(update, dim=2) - update
    dot = torch.einsum("cdn,nd->cn", b_before, x)
    w = h / torch.clamp(lam - h, min=1e-12)
    sd = torch.sqrt(lam * (w + 1.0))
    return -((1.0 + w) * dot - w * z_old) / torch.where(t == 1.0, sd, -sd)


def sweep_bound_us(c: int, n: int, d: int, tail_steps: int) -> dict:
    """G1's bounds: bytes once (S, lambda, h, z_old, the central uniform, z out,
    x, the labels, B in and out, and the six tail uniforms of the steps that
    took the tail) at 3.35 TB/s against 4 D + 30 operations a chain and step
    (the dot and the update, the step's scalar arithmetic, each library call
    one) at 67 TFLOP/s; and the latency of the source's dependent chain."""
    nbytes = 4 * (c * d * n + 5 * c * n + 6 * tail_steps + n * d + n + 2 * c * d)
    ops = c * n * (4 * d + 30)
    by_bytes, by_ops = 1e6 * nbytes / HBM_BYTES_PER_S, 1e6 * ops / FP32_OPS_PER_S
    return {"bound_us": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": ops, "tail_steps": tail_steps}


# G1's bound as a sequence (csrc/gibbs.cu): the longest chain of dependent
# operations through one step of a chain, on the central path (a <= 3, u in
# ndtri's central interval), with each library call (erff, an IEEE division)
# counted as one operation, so a lower bound on the source's chain.  From p_j
# to p_{j+1}: the mean (2), a (1), the tail branch's test (1), the clamp (2),
# the ndtr (erf argument, erff, +1, x0.5: 4), u (3), its clamp (2), ndtri's
# central branch (its test, y - 0.5, y^2, 9 Horner FMAs of Q0, the division,
# an FMA, x sqrt(2 pi): 15), the max with a_c (1), z_j (2), delta (2) and
# p_{j+1} = R + delta Q (1).  The dot and B's update are off the chain (the
# look-ahead), so D does not enter (one thread a chain with the dot on the
# chain counted 39 + ceil(D / 4)).
SWEEP_CHAIN_PER_STEP = 36


def sweep_dependent_operations(num_data: int) -> int:
    """Length of a chain's longest sequence of dependent operations through G1's sweep."""
    return num_data * SWEEP_CHAIN_PER_STEP


def sweep_critical_path_us(num_data: int, sm_clock_mhz: float) -> float:
    """G1's latency bound: ``sweep_dependent_operations`` one after another at
    4 cycles each and the given SM clock, whatever the chain count."""
    return sweep_dependent_operations(num_data) * rt.ops.fhn_sens.FP32_DEPENDENT_CYCLES / sm_clock_mhz


def tail_rounds(a: torch.Tensor, noise: truncnorm.TruncNormNoise) -> dict:
    """Which of the tail's three Rayleigh rounds gives z_j at the steps with
    a > 3, by the plain version's formulas on this sweep's uniforms: the
    first or second round's accepted candidate, else the last round's
    candidate, whether it was accepted or not."""
    tail = (a > truncnorm.TAIL_SPLIT).T  # (N, C), as the uniforms
    a_t = torch.clamp(a, min=truncnorm.TAIL_SPLIT).T
    cand = torch.sqrt(torch.addcmul(truncnorm.prepare(noise).neg2_log_e, a_t, a_t))
    acc = noise.u_tail <= a_t / cand
    first, second = acc[0], ~acc[0] & acc[1]
    last = ~acc[0] & ~acc[1]
    return {"tail_steps": int(tail.sum()), "round_1": int((tail & first).sum()), "round_2": int((tail & second).sum()),
            "round_3": int((tail & last).sum()), "round_3_rejected_taken": int((tail & last & ~acc[2]).sum())}


def wrapper_lanes(c: int) -> int:
    """The lanes a chain that G1's wrapper takes for ``c`` chains on this card (B in registers, D <= 32 at
    any C)."""
    return gibbs.sweep_lanes(c, torch.cuda.get_device_properties(0).multi_processor_count)


def layout_kwargs(layout) -> dict:
    """``gibbs_sweep_cuda``'s keywords for a layout of check_sweep: None (the wrapper's own), a lane count
    (B in registers on that many lanes of a warp) or the keywords themselves."""
    if layout is None:
        return {}
    return {"lanes": layout} if isinstance(layout, int) else dict(layout)


def layout_name(c: int, d: int, layout) -> str:
    """A layout of check_sweep by its lanes, or its warps with where B lives."""
    resolved, code = gibbs.launch_layout(c, d, torch.device(DEVICE), **layout_kwargs(layout))
    if code == gibbs.SWEEP_REGISTERS:
        return f"{resolved.lanes} lanes"
    return f"{resolved.warps} warps, B in " + {gibbs.SWEEP_WIDE_REGISTERS: "registers", gibbs.SWEEP_WIDE_SHARED:
                                               "shared memory", gibbs.SWEEP_WIDE_GLOBAL: "the output buffer"}[code]


def sweep_yardstick(label: str, c: int, kernel: tuple, plain: tuple, plain64: tuple, enforce: bool) -> dict:
    """G1's outputs (B, z) and the float32 plain version's against the float64 plain version on the same
    inputs, over the chains where the kernel kept to the float32 plain version and that to the float64 one
    (SWEEP_TOL: a chain parted by a value within rounding of a threshold is left out, counted, and at most
    SWEEP_MAX_PARTED of them).  The error of each output is its root mean square over those chains' entries:
    a z_j whose u lies near 1, where ndtri's slope turns one ulp into 1e-3, sets the largest error of either
    version by chance (both printed).  Where ``enforce`` (the wide layout), the kernel's error in B and in z
    must each be at most twice the float32 plain version's plus FIXED_POINT_FLOOR, as phase 3 holds K4 and
    K5; elsewhere it is printed."""
    rtol, atol = SWEEP_TOL

    def parted(a, ref):
        return ((a[0] - ref[0]).abs() > atol + rtol * ref[0].abs()).any(1) | \
            ((a[1] - ref[1]).abs() > atol + rtol * ref[1].abs()).any(1)

    k64, p64 = [tuple(v.double() for v in out) for out in (kernel, plain)]
    float_parted = parted(p64, plain64)
    ok = ~(parted(k64, p64) | float_parted)
    n_float_parted = int(float_parted.sum())
    check(not enforce or n_float_parted <= SWEEP_MAX_PARTED * c, f"{label}: {n_float_parted} chains of the float32 "
                                                                 f"plain version parted from the float64 one, more "
                                                                 f"than {SWEEP_MAX_PARTED} of {c}")
    out = {"float64_chains_left_out": int((~ok).sum()), "float32_plain_parted_from_float64": n_float_parted}
    for name, i in (("b", 0), ("z", 1)):
        diff_k, diff_p = (k64[i] - plain64[i])[ok], (p64[i] - plain64[i])[ok]
        rms_k = float(diff_k.square().mean().sqrt()) if diff_k.numel() else 0.0
        rms_p = float(diff_p.square().mean().sqrt()) if diff_p.numel() else 0.0
        check(not enforce or rms_k <= 2 * rms_p + FIXED_POINT_FLOOR,
              f"{label}: rms |kernel - float64 plain| of {name} {rms_k} > 2 x rms |float32 plain - float64 plain| "
              f"{rms_p} + {FIXED_POINT_FLOOR}")
        out.update({f"float64_kernel_rms_{name}": rms_k, f"float64_plain_rms_{name}": rms_p,
                    f"float64_kernel_max_{name}": float(diff_k.abs().max()) if diff_k.numel() else 0.0,
                    f"float64_plain_max_{name}": float(diff_p.abs().max()) if diff_p.numel() else 0.0})
    return out


def check_sweep(c: int, n: int, d: int, timed: bool, z_scale: float = 1.0, lanes_checked=(None,),
                same_bits=()) -> dict:
    """G1 against its plain version at one shape, on a state whose z is scaled
    by ``z_scale`` (``gibbs_inputs``), at the wrapper's layout (None) and any
    other of ``lanes_checked`` (``layout_kwargs``), each also against the
    float64 plain version (``sweep_yardstick``); the layouts of ``same_bits``
    (which sum in one order) bit for bit each other; its times where
    ``timed``, every layout's device time there."""
    model, state, cond, noise = gibbs_inputs(c, n, d, seed=c + n + d, z_scale=z_scale)
    args = (model.X, model.t, state.lam, cond.h, state.z, cond.s, cond.b, noise)
    bp, zp = gibbs.gibbs_sweep_plain(*args)
    plain64 = gibbs.gibbs_sweep_plain(*(a.double() for a in args[:7]),
                                      truncnorm.TruncNormNoise(*(u.double() for u in noise)))
    rtol, atol = SWEEP_TOL
    # z_j = m + s max(ndtri(u), a) is 0 up to rounding where ndtri(u) fell below the bound a (u near ndtr(a)):
    # the side of 0 is checked where the plain version's z_j is clear of it.
    sign = torch.where(model.t == 1.0, 1.0, -1.0).expand(c, n)
    clear = zp.abs() > atol
    bound_a = sweep_bounds(args, zp)
    tail = tail_rounds(bound_a, noise)
    by_lanes, outputs = {}, {}
    for checked in lanes_checked:
        bk, zk = gibbs.gibbs_sweep_cuda(*args, **layout_kwargs(checked))
        torch.cuda.synchronize()
        lanes = layout_name(c, d, checked)
        code = gibbs.launch_layout(c, d, torch.device(DEVICE), **layout_kwargs(checked))[1]
        outputs[lanes] = (bk, zk)
        at = f"(C={c}, N={n}, D={d}, z x {z_scale}, {lanes})"
        check(bk.shape == (c, d) and zk.shape == (c, n), f"G1 {at}: shapes {tuple(bk.shape)}, {tuple(zk.shape)}")
        check(bool(torch.isfinite(bk).all() and torch.isfinite(zk).all()), f"G1 {at}: non-finite output")
        wrong = int(((zk * sign <= 0) & clear).sum())
        over_z = (zk - zp).abs() > atol + rtol * zp.abs()
        over_b = (bk - bp).abs() > atol + rtol * bp.abs()
        parted = over_z.any(1) | over_b.any(1)
        kept = ~parted
        n_parted = int(parted.sum())
        err = max(float((zk - zp)[kept].abs().max()), float((bk - bp)[kept].abs().max())) if bool(kept.any()) else 0.0
        ratio = max(float(((zk - zp).abs() / (atol + rtol * zp.abs()))[kept].max()),
                    float(((bk - bp).abs() / (atol + rtol * bp.abs()))[kept].max())) if bool(kept.any()) else 0.0
        # The central path's u = ndtr(a) + u' (1 - ndtr(a)) at the z_j beyond tolerance.
        lo = torch.special.ndtr(torch.clamp(bound_a, -12.0, truncnorm.TAIL_SPLIT))
        u_over = (lo + noise.u_central.T * (1.0 - lo))[over_z]
        by_lanes[lanes] = {
            "lanes": lanes, "layout_code": code, "max_abs_err_kept_chains": err,
            "worst_ratio_to_tolerance_kept_chains": ratio,
            "u_at_z_beyond_tolerance_min_max": [float(u_over.min()), float(u_over.max())] if u_over.numel() else None,
            "chains_parted": n_parted, "z_wrong_side": wrong,
            "elements_beyond_tolerance": int(over_z.sum()) + int(over_b.sum()),
            "first_parted_chains": parted.nonzero().flatten()[:5].tolist(),
            **sweep_yardstick(f"G1 {at}", c, (bk, zk), (bp, zp), plain64, code != gibbs.SWEEP_REGISTERS)}
        say("gibbs-sweep-check", C=c, N=n, D=d, z_scale=z_scale, **tail, **by_lanes[lanes],
            z_at_zero_within_rounding=int((~clear).sum()))
        check(wrong == 0, f"G1 {at}: {wrong} z_j clear of 0 on the wrong side")
        check(n_parted <= SWEEP_MAX_PARTED * c, f"G1 vs plain {at}: {n_parted} chains beyond rtol / atol {SWEEP_TOL}, "
                                                f"more than {SWEEP_MAX_PARTED} of {c}")
    own = layout_name(c, d, None)
    out = {"C": c, "N": n, "D": d, "z_scale": z_scale, **tail, **by_lanes[own],
           "z_at_zero_within_rounding": int((~clear).sum()),
           "other_lanes": {k: v for k, v in by_lanes.items() if k != own},
           "layout_codes": sorted({row["layout_code"] for row in by_lanes.values()})}
    if same_bits:
        names = [layout_name(c, d, layout) for layout in same_bits]
        first = outputs[names[0]]
        differ = [name for name in names[1:] if not (torch.equal(bits(outputs[name][0]), bits(first[0]))
                                                     and torch.equal(bits(outputs[name][1]), bits(first[1])))]
        check(not differ, f"G1 (C={c}, N={n}, D={d}): {differ} differ from {names[0]} in some bit")
        out["layouts_bit_for_bit"] = names
    if z_scale == SWEEP_TAIL_Z_SCALE:
        check(min(tail["round_1"], tail["round_2"], tail["round_3"]) > 0,
              f"G1 (C={c}, N={n}, D={d}, z x {z_scale}): the tail case did not take each of the tail's rounds: {tail}")
    if timed:
        ins = [a.contiguous() for a in (*args[:7], *noise)]
        b_out, z_out = torch.empty_like(bp), torch.empty_like(zp)
        lib = gibbs._lib()
        layout_us = {}
        for checked in lanes_checked:
            layout, code = gibbs.launch_layout(c, d, torch.device(DEVICE), **layout_kwargs(checked))
            scratch = torch.empty(gibbs.sweep_scratch_numel(c, n, layout.lanes), device=DEVICE)

            def launch():
                lib.rhmc_gibbs_sweep(*(a.data_ptr() for a in ins), c, n, d, layout.lanes, code, scratch.data_ptr(),
                                     b_out.data_ptr(), z_out.data_ptr(), torch.cuda.current_stream().cuda_stream)

            dev = device_us(launch, launches=20, name_part=GIBBS_KERNEL_NAMES["gibbs_sweep"])
            check(dev["events_per_call"] == 1, f"G1: {dev['events_per_call']} device kernels per launch")
            layout_us[layout_name(c, d, checked)] = dev["us"]
            if checked is None:
                own_dev, own_layout = dev, layout
        bound = sweep_bound_us(c, n, d, tail["tail_steps"])
        clock = sm_clock_max_mhz()
        critical = sweep_critical_path_us(n, clock)
        out.update(ms=median_ms(lambda: gibbs.gibbs_sweep_cuda(*args), reps=20),
                   plain_ms=median_ms(lambda: gibbs.gibbs_sweep_plain(*args), reps=3, warmup=1),
                   device_us=own_dev["us"], device_us_source=own_dev["source"], profiler_sessions=own_dev["sessions"],
                   **bound, share_of_bound=bound["bound_us"] / own_dev["us"], critical_path_us=critical,
                   share_of_critical_path=critical / own_dev["us"], sm_clock_max_mhz=clock,
                   dependent_operations=sweep_dependent_operations(n), lanes=own_layout.lanes,
                   entries_a_lane=own_layout.entries, wide=own_layout.wide, device_us_by_layout=layout_us)
    return out


def gig_inputs(seed: int):
    """(r, y0 normal draws with GIG_ZERO_DRAWS exact zeros, u_side, u) at GIG_SHAPE."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shape = GIG_SHAPE
    r2 = torch.exp(torch.empty(shape, device=DEVICE).uniform_(math.log(1e-4), math.log(25.0), generator=gen))
    y0 = torch.randn(shape, generator=gen, device=DEVICE)
    y0.view(-1)[:: y0.numel() // GIG_ZERO_DRAWS][:GIG_ZERO_DRAWS] = 0.0
    return (torch.sqrt(torch.clamp(r2, min=1e-16)), y0, torch.rand(shape, generator=gen, device=DEVICE),
            torch.rand(shape, generator=gen, device=DEVICE))


def compare_gig_round(draws, lam0, ok0, label: str) -> dict:
    """One round of G2 and of its plain version from the same (lam, ok)."""
    (lk, okk), (lp, okp) = (lam0.clone(), ok0.clone()), (lam0.clone(), ok0.clone())
    gig.gig_round_cuda(*draws, lk, okk)
    gig.gig_round_plain(*draws, lp, okp)
    torch.cuda.synchronize()
    differ = (okk != okp) | (lk != lp)
    n_differ = int(differ.sum())
    check(n_differ <= GIG_MAX_DIFFERING * lk.numel(),
          f"G2 vs plain, {label}: {n_differ} elements differ, more than {GIG_MAX_DIFFERING} of {lk.numel()}")
    check(bool(torch.equal(lk[ok0], lam0[ok0]) and okk[ok0].all()), f"G2, {label}: an accepted element changed")
    check(bool(torch.isfinite(lk).all() and (lk > 0).all()), f"G2, {label}: lambda not finite and positive")
    same = ~differ
    err = float((lk - lp)[same].abs().max()) if bool(same.any()) else 0.0
    return {"round": label, "accepted": int(okk.sum()), "elements_differing": n_differ, "max_abs_err_same": err,
            "lam": lk, "ok": okk}


def check_gig_round() -> dict:
    """G2 against its plain version on two rounds of the same draws, then its times."""
    c, n = GIG_SHAPE
    draws = gig_inputs(seed=5)
    lam0, ok0 = torch.ones(GIG_SHAPE, device=DEVICE), torch.zeros(GIG_SHAPE, dtype=torch.bool, device=DEVICE)
    first = compare_gig_round(draws, lam0, ok0, "first (no element accepted)")
    zero = draws[1] == 0.0
    check(int(zero.sum()) == GIG_ZERO_DRAWS and not bool(first["ok"][zero].any()),
          "G2: a candidate from a zero normal draw (lambda = inf) was accepted")
    second = compare_gig_round(gig_inputs(seed=6), first["lam"], first["ok"], "second (from the first's flags)")
    right = float((first["lam"][first["ok"]] > 4.0 / 3.0).float().mean())  # accepted by the rightmost series
    check(0.0 < right < 1.0, f"G2: the first round's acceptances came from one series only (right share {right})")
    lib = gig._lib()

    def launch(lam, ok):
        lib.rhmc_gig_round(*(a.data_ptr() for a in (*draws, lam, ok)), c * n, 32, torch.cuda.current_stream().cuda_stream)

    fresh = lambda: launch(lam0.clone(), ok0.clone())  # noqa: E731 -- every element pending, as a step's first round
    done = torch.ones(GIG_SHAPE, dtype=torch.bool, device=DEVICE)
    dev = device_us(fresh, launches=20, name_part=GIBBS_KERNEL_NAMES["gig_round"])
    late = device_us(lambda: launch(lam0.clone(), done), launches=20, name_part=GIBBS_KERNEL_NAMES["gig_round"])
    check(dev["events_per_call"] == 1, f"G2: {dev['events_per_call']} device kernels per launch")
    pending, accepted = c * n, first["accepted"]
    nbytes = c * n + 16 * pending + 5 * accepted
    ops = GIG_OPS_PER_PENDING * pending
    by_bytes, by_ops = 1e6 * nbytes / HBM_BYTES_PER_S, 1e6 * ops / FP32_OPS_PER_S
    bound = max(by_bytes, by_ops)
    times = {"C": c, "N": n, "ms": median_ms(lambda: gig.gig_round_cuda(*draws, lam0.clone(), ok0.clone()), reps=20),
             "plain_ms": median_ms(lambda: gig.gig_round_plain(*draws, lam0.clone(), ok0.clone()), reps=5),
             "device_us": dev["us"], "device_us_source": dev["source"], "profiler_sessions": dev["sessions"],
             "bound_us": bound, "bound_by": "bytes" if by_bytes >= by_ops else "operations", "bytes": nbytes,
             "operations": ops, "share_of_bound": bound / dev["us"],
             "all_accepted_round_device_us": late["us"], "all_accepted_round_bound_us": 1e6 * c * n / HBM_BYTES_PER_S}
    rounds = [{k: v for k, v in r.items() if k not in ("lam", "ok")} for r in (first, second)]
    return {"rounds": rounds, "rightmost_share_of_first_round_accepts": right,
            "zero_normal_draws": GIG_ZERO_DRAWS, "times": times,
            "err": max(r["max_abs_err_same"] for r in rounds),
            "elements_differing": sum(r["elements_differing"] for r in rounds)}


def compare_gig_half(r: torch.Tensor, key: torch.Tensor, first: int, label: str) -> dict:
    """The fused kernel against its plain version on ``r`` from global index ``first``."""
    lk = gig.sample_gig_half_cuda(r, key, first)
    lp, ran = gig.gig_half_plain_rounds(r, key, first)
    torch.cuda.synchronize()
    differ = lk != lp
    n_differ = int(differ.sum())
    check(bool(torch.isfinite(lk).all() and (lk > 0).all()), f"G2, {label}: lambda not finite and positive")
    check(n_differ <= GIG_MAX_DIFFERING * lk.numel(),
          f"G2 vs plain, {label}: {n_differ} elements differ, more than {GIG_MAX_DIFFERING} of {lk.numel()}")
    same = ~differ
    ran = ran.double()
    return {"part": label, "elements": lk.numel(), "elements_differing": n_differ,
            "max_abs_err_same": float((lk - lp)[same].abs().max()) if bool(same.any()) else 0.0,
            "rounds_mean": float(ran.mean()), "rounds_max": int(ran.max()),
            "never_accepted": int((lp == 1.0).sum()), "element_rounds": int(ran.sum()), "lam": lk}


def check_gig_half() -> dict:
    """The whole GIG draw (G2) against its plain version, whole and at a chain
    split's row offset, then its times."""
    c, n = GIG_SHAPE
    r = gig_inputs(seed=7)[0]
    key = torch.randint(*gig.KEY_RANGE, (1,), generator=torch.Generator(device=DEVICE).manual_seed(GIG_KEY_SEED),
                        dtype=torch.int64, device=DEVICE)
    whole = compare_gig_half(r, key, 0, "whole")
    split = compare_gig_half(r[GIG_SPLIT_ROW:].contiguous(), key, GIG_SPLIT_ROW * n, f"rows {GIG_SPLIT_ROW}:{c}")
    check(bool(torch.equal(split["lam"], whole["lam"][GIG_SPLIT_ROW:])),
          "G2: a chain split's rows differ from the whole call's rows")
    lam = torch.empty_like(r)
    lib = gig._lib()

    def launch():
        lib.rhmc_gig_half(r.data_ptr(), key.data_ptr(), 0, c * n, gibbs.GibbsConfig().max_rejection_rounds, 32,
                          lam.data_ptr(), torch.cuda.current_stream().cuda_stream)

    dev = device_us(launch, launches=20, name_part=GIBBS_KERNEL_NAMES["gig_half"])
    check(dev["events_per_call"] == 1, f"G2: {dev['events_per_call']} device kernels per launch")
    nbytes = 8 * c * n + 8  # r in, lambda out, the key
    ops = GIG_HALF_OPS_PER_ROUND * whole["element_rounds"]
    by_bytes, by_ops = 1e6 * nbytes / HBM_BYTES_PER_S, 1e6 * ops / FP32_OPS_PER_S
    bound = max(by_bytes, by_ops)
    times = {"C": c, "N": n, "ms": median_ms(lambda: gig.sample_gig_half_cuda(r, key), reps=20),
             "plain_ms": median_ms(lambda: gig.sample_gig_half_plain(r, key), reps=3, warmup=1),
             "device_us": dev["us"], "device_us_source": dev["source"], "profiler_sessions": dev["sessions"],
             "bound_us": bound, "bound_by": "bytes" if by_bytes >= by_ops else "operations", "bytes": nbytes,
             "operations": ops, "share_of_bound": bound / dev["us"],
             "rounds_mean": whole["rounds_mean"], "rounds_max": whole["rounds_max"]}
    parts = [{k: v for k, v in part.items() if k != "lam"} for part in (whole, split)]
    return {"parts": parts, "times": times, "err": max(part["max_abs_err_same"] for part in parts),
            "elements_differing": sum(part["elements_differing"] for part in parts)}


def phase_gibbs_kernels(smi: str) -> dict:
    """G1 and G2 against their plain versions on the card, and their times."""
    sweeps = [check_sweep(c, n, d, timed=(c, n, d) == SWEEP_SHAPES[0],
                          lanes_checked=(None, *gibbs.SWEEP_LANES) if (c, n, d) == SWEEP_SHAPES[0] else (None,))
              for c, n, d in SWEEP_SHAPES]
    sweeps.append(check_sweep(*SWEEP_SHAPES[0], timed=False, z_scale=SWEEP_TAIL_Z_SCALE))
    wide = [check_sweep(c, n, d, timed=True) for c, n, d in SWEEP_WIDE_SHAPES]
    wide.append(check_sweep(*SWEEP_BOTH_CN, gibbs.SWEEP_THREADS * gibbs.SWEEP_ENT_MAX, timed=True,
                            lanes_checked=SWEEP_BOTH_LAYOUTS, same_bits=SWEEP_BOTH_LAYOUTS[1:]))
    c, n, d = SWEEP_OPTIN_SHAPE
    optin = check_sweep(c, n, d, timed=True, lanes_checked=SWEEP_OPTIN_LAYOUTS, same_bits=SWEEP_OPTIN_LAYOUTS)
    check(optin["layout_code"] == gibbs.SWEEP_WIDE_SHARED and gibbs.sweep_shared_bytes(d) > 48 * 1024,
          f"G1 at {SWEEP_OPTIN_SHAPE}: the wrapper's layout did not take B in shared memory past 48 KB a block")
    wide.append(optin)
    codes = {code for row in wide for code in row["layout_codes"]}
    check(codes == {gibbs.SWEEP_REGISTERS, gibbs.SWEEP_WIDE_REGISTERS, gibbs.SWEEP_WIDE_SHARED, gibbs.SWEEP_WIDE_GLOBAL},
          f"G1's layouts run in phase 3: {sorted(codes)}, expected every one")
    for row in wide:
        say("gibbs-sweep-kernel-times", card=smi,
            **{k: v for k, v in row.items() if k not in ("first_parted_chains", "other_lanes")},
            library="none: no PyTorch call runs a sequential truncated-normal sweep")
    sweeps += wide
    say("gibbs-sweep-kernel", checked=[{k: v for k, v in row.items() if k in (
        "C", "N", "D", "z_scale", "lanes", "max_abs_err_kept_chains", "chains_parted", "elements_beyond_tolerance",
        "first_parted_chains", "z_at_zero_within_rounding", "tail_steps", "round_1", "round_2", "round_3",
        "round_3_rejected_taken")}
        for row in sweeps], tolerance_rtol_atol=SWEEP_TOL, max_parted_share=SWEEP_MAX_PARTED)
    top = sweeps[0]
    say("gibbs-sweep-kernel-times", card=smi,
        **{k: v for k, v in top.items() if k not in ("first_parted_chains", "other_lanes")},
        library="none: no PyTorch call runs a sequential truncated-normal sweep")
    rounds = check_gig_round()
    say("gig-round-kernel", rounds=rounds["rounds"],
        rightmost_share_of_first_round_accepts=rounds["rightmost_share_of_first_round_accepts"],
        zero_normal_draws=GIG_ZERO_DRAWS, max_differing_share=GIG_MAX_DIFFERING)
    say("gig-round-kernel-times", card=smi, **rounds["times"], library="none: no PyTorch call samples the GIG")
    half = check_gig_half()
    say("gig-half-kernel", parts=half["parts"], max_differing_share=GIG_MAX_DIFFERING, split_row=GIG_SPLIT_ROW)
    say("gig-half-kernel-times", card=smi, **half["times"], library="none: no PyTorch call samples the GIG")
    return {"sweep": sweeps, "gig": rounds, "gig_half": half}


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
        "kernel": kern, "final_state": res.final_state,
    }


def blr_expected_launches(steps: int, loops: bool = False) -> dict:
    """K1 / K2 / K3 (and K4 / K5) launches of a BLR RMHMC run of ``steps`` steps:
    one geometry (K3) at init and after each leapfrog step, no K1; on a whole
    model one position fixed point (K4) a leapfrog step and two momentum
    launches (K5: the fixed point and the explicit half-step), no K2; with
    ``loops`` (a data-sharded model, or the parent's route) the sampler's
    loops instead, one solve (K2) a position fixed-point round."""
    if loops:
        return {"cholesky": 0, "chol_solve_logdet": L * K * steps, "chol_inv_logdet": 1 + L * steps}
    return {"cholesky": 0, "chol_solve_logdet": 0, "chol_inv_logdet": 1 + L * steps,
            "position_fixed_point": L * steps, "momentum_fixed_point": 2 * L * steps}



def blr_launches() -> dict:
    """K1 / K2 / K3 launches since the last reset, and G1 / G2's and T1's where
    they launched (a Gibbs or StochVol run): a run of another sampler that
    launched one shows the key."""
    others = {name: n for name, n in rt.ops.launches.counts(SOMETIMES_COUNTED).items() if n}
    return {**hl.launch_counts(), **others}


def reset_blr_launches() -> None:
    hl.reset_launch_counts()
    rt.ops.launches.reset(SOMETIMES_COUNTED)


def phase_main_path(model, smi: str) -> dict:
    steps = BURN_IN + NUM_SAMPLES
    reset_blr_launches()
    kern = sample(model, None, seed=1)
    launches = blr_launches()
    expected = blr_expected_launches(steps)
    check(launches == expected, f"launch counts {launches}, expected {expected}")
    lo, hi = ACCEPT_WINDOW
    check(lo <= kern["accept"] <= hi, f"acceptance {kern['accept']} outside {ACCEPT_WINDOW}")
    max_div = MAX_DIVERGENT_FRACTION * NUM_CHAINS * steps
    check(kern["divergent"] <= max_div, f"{kern['divergent']} divergences > {max_div}")
    check(kern["rhat"] < MAX_RHAT, f"max split R-hat {kern['rhat']} >= {MAX_RHAT}")

    plain = sample(model, "unrolled", seed=2, burn_in=PLAIN_BURN_IN, num_samples=PLAIN_SAMPLES)
    check(blr_launches() == launches, "the plain-linalg run launched a kernel")
    # The counts came from the kernels' device counters, which the step's graph adds to at each replay;
    # a few more replays of that graph under torch.profiler hold them against the device's own events.
    replays = replay_launches(kern["kernel"], kern["final_state"])
    per_replay = {name: n - blr_expected_launches(0)[name] for name, n in blr_expected_launches(1).items()}
    check(replays["counted"] == {"fhn_sensitivities": 0, **dict.fromkeys(SOMETIMES_COUNTED, 0),
                                 **{k: n * GRAPH_REPLAYS for k, n in per_replay.items()}},
          f"main path: {GRAPH_REPLAYS} replays counted {replays['counted']}, expected {per_replay} each")
    check(replays["equal"], f"main path: the counters and torch.profiler's device events differ: {replays}")
    for run in (kern, plain):
        s = run["samples"].reshape(-1, DIM)
        run["mean"], run["var"] = s.mean(0), s.var(0)
    se = np.sqrt(kern["var"] / kern["ess_exact"] + plain["var"] / plain["ess_exact"])
    z = np.abs(kern["mean"] - plain["mean"]) / se
    check(float(z.max()) < Z_BOUND, f"posterior means differ: max z {float(z.max())}")

    min_ess = float(kern["ess"].min())
    SEEN_ACCEPT["rmhmc-main-path"] = kern["accept"]
    say("main-path", chains=NUM_CHAINS, burn_in=BURN_IN, samples=NUM_SAMPLES,
        launches=launches, replays_under_profiler=replays, accept_rate=kern["accept"], divergent=kern["divergent"],
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
        """K1 / K2 / K3 launches (and Gibbs's G1 / G2), read from the samplers' code (init + per step)."""
        if self.sampler in ("mmala", "mmala_simplified", "iwls"):  # one factorization in init, one per proposal
            return {**NO_LINALG, "cholesky": 1 + self.steps}
        if self.sampler == "gibbs":  # ops.inv_psd and chol(V), no factorization in init; G1 and G2 once a step
            return {**NO_LINALG, "cholesky": 2 * self.steps, "gibbs_sweep": self.steps, "gig_half": self.steps}
        if self.sampler in ("rmhmc", "rmhmc_studentt"):
            return blr_expected_launches(self.steps)  # as phase 5
        return dict(NO_LINALG)


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
        reset_blr_launches()
        res = experiments.run_experiment(
            run.sampler, run.dataset, device=DEVICE, num_chains=run.chains, num_samples=run.samples,
            burn_in=run.burn_in, seed=7, adapt=run.adapt, keep_samples=True,
        )
        launches = blr_launches()
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
    launches_by_path[MUSK_LABEL] = gibbs_musk(smi)
    launches_by_path[GIBBS_WIDE_LABEL] = gibbs_wide(smi)
    return launches_by_path


# Gibbs at UCI Musk v1's shape (476 rows, 166 features and the intercept: D = 167, past K1's 48, so that
# ops.inv_psd and ops.cholesky take torch.linalg, as the JAX package's take jnp.linalg; G1 on 32 lanes of
# 6 entries), 1024 chains, GRAPH_SMALL_RUN eager against captured.
MUSK_SHAPE = (476, 167, 0)  # (N, D, synthetic seed)
MUSK_CHAINS = 1024
MUSK_LABEL = "gibbs-musk/captured"


def captured_pair_checked(label: str, kernel, init, expected: dict, counted) -> dict:
    """``graph_pair`` at GRAPH_SMALL_RUN: eager and captured bit for bit, one capture, the captured run's
    launch counts (``counted`` of the pair's counts) equal to ``expected`` and to the eager run's, and three
    replays of the step's graph under torch.profiler, the device counters against its kernel events."""
    pair = graph_pair(label, kernel, init, *GRAPH_SMALL_RUN)
    replays = replay_launches(kernel, pair["result"]["captured"].final_state)
    samples = []
    rt.samplers.base.tree_map(samples.append, pair["result"]["captured"].samples)
    check(not pair["differs"], f"{label}: eager and captured differ in {pair['differs']}")
    check(pair["launches_equal"] and counted(pair["captured"]) == expected,
          f"{label}: captured launches {counted(pair['captured'])}, eager {counted(pair['eager'])}, expected {expected}")
    check(pair["captured"]["captures"] == 1, f"{label}: {pair['captured']['captures']} captures, expected one")
    check(pair["host_sync_in_step"] is None, f"{label}: a host sync inside the step: {pair['host_sync_in_step']}")
    check(replays["equal"] and any(replays["counted"].values()),
          f"{label}: the counters and torch.profiler's device events differ: {replays}")
    check(samples and all(bool(torch.isfinite(leaf).all()) for leaf in samples), f"{label}: samples not finite")
    pair["replays_under_profiler"] = replays
    return pair


def gibbs_musk(smi: str) -> dict:
    """Gibbs on Musk-shaped data, captured against eager; returns the captured run's launch counts."""
    n, d, seed = MUSK_SHAPE
    ds = rt.models.synthetic_logreg(seed=seed, n=n, d=d)
    model = rt.interop.logreg_from_numpy(ds.X, ds.t, device=DEVICE)
    init = rt.utils.default_init(model, torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED), MUSK_CHAINS)
    steps = sum(GRAPH_SMALL_RUN)
    expected = {**NO_LINALG, "gibbs_sweep": steps, "gig_half": steps}
    pair = captured_pair_checked(MUSK_LABEL, gibbs.build(model), init, expected, lambda counts: counts["k1_k2"])
    layout = gibbs.sweep_layout(MUSK_CHAINS, d, torch.cuda.get_device_properties(0).multi_processor_count)
    say("blr-samplers", run=MUSK_LABEL, N=n, D=d, chains=MUSK_CHAINS, burn_in=GRAPH_SMALL_RUN[0],
        samples=GRAPH_SMALL_RUN[1], g1_layout=layout._asdict(), launches=pair["captured"]["k1_k2"],
        eager_and_captured_equal=True, replays_under_profiler=pair["replays_under_profiler"],
        capture_s=pair["capture_s"], graph_pool_bytes=pair["graph_pool_bytes"])
    say("blr-samplers-times", run=MUSK_LABEL, card=smi,
        s_per_transition={path: pair[path]["seconds"] / steps for path in ("eager", "captured")})
    return pair["captured"]["k1_k2"]


# Gibbs past 32 lanes of SWEEP_ENT_MAX entries, where G1 takes its wide layout (64 chains: a block of
# SWEEP_WIDE_WARPS warps a chain, B in registers): more features than rows under a ridge prior of variance
# SWEEP_DIRECT_PRIOR_VARIANCE (see there), GRAPH_SMALL_RUN eager against captured.  The model's (N, D^2)
# outer features take ~5.0 GB.
GIBBS_WIDE_SHAPE = (300, 2049, 0)  # (N, D, synthetic seed)
GIBBS_WIDE_CHAINS = 64
GIBBS_WIDE_LABEL = "gibbs-wide/captured"


def gibbs_wide(smi: str) -> dict:
    """Gibbs at GIBBS_WIDE_SHAPE, captured against eager; returns the captured run's launch counts."""
    n, d, seed = GIBBS_WIDE_SHAPE
    ds = rt.models.synthetic_logreg(seed=seed, n=n, d=d)
    torch.cuda.reset_peak_memory_stats()
    model = rt.interop.logreg_from_numpy(ds.X, ds.t, device=DEVICE)
    init = rt.utils.default_init(model, torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED), GIBBS_WIDE_CHAINS)
    steps = sum(GRAPH_SMALL_RUN)
    expected = {**NO_LINALG, "gibbs_sweep": steps, "gig_half": steps}
    kernel = gibbs.build(model, gibbs.GibbsConfig(prior_variance=SWEEP_DIRECT_PRIOR_VARIANCE))
    pair = captured_pair_checked(GIBBS_WIDE_LABEL, kernel, init, expected, lambda counts: counts["k1_k2"])
    layout, code = gibbs.launch_layout(GIBBS_WIDE_CHAINS, d, torch.device(DEVICE))
    check(code == gibbs.SWEEP_WIDE_REGISTERS, f"{GIBBS_WIDE_LABEL}: G1 took layout {code}, not the wide one in registers")
    say("blr-samplers", run=GIBBS_WIDE_LABEL, N=n, D=d, chains=GIBBS_WIDE_CHAINS, burn_in=GRAPH_SMALL_RUN[0],
        samples=GRAPH_SMALL_RUN[1], prior_variance=SWEEP_DIRECT_PRIOR_VARIANCE,
        g1_layout={**layout._asdict(), "warps": layout.warps, "code": code}, launches=pair["captured"]["k1_k2"],
        eager_and_captured_equal=True, replays_under_profiler=pair["replays_under_profiler"],
        capture_s=pair["capture_s"], graph_pool_bytes=pair["graph_pool_bytes"],
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    say("blr-samplers-times", run=GIBBS_WIDE_LABEL, card=smi,
        s_per_transition={path: pair[path]["seconds"] / steps for path in ("eager", "captured")})
    counts = pair["captured"]["k1_k2"]
    del model, kernel, pair
    return counts


# -- phase 7: stochastic volatility through the workload entry point -----------

SV_CHAINS, SV_OBS, SV_SEED = 1024, 2000, 0
# (burn-in, samples) per method: the reference's 20000 samples cut to a smoke run.
# hmc's sweep is ~1-1.8 s (100 hyper leapfrog steps, each a torch.func
# gradient).  rmhmc, hmc and mmala ran 100 + 100, 30 + 30 and 200 + 200, then
# rmhmc 60 + 60 and mmala 120 + 120, until the joint LGC and FHN phases needed
# their seconds, and hmc 20 + 20 until the results tools' phase did: the
# whole script keeps its time.
SV_RUNS = {"rmhmc": (40, 40), "hmc": (10, 10), "mmala": (80, 80), "mala": (500, 200)}
# The JAX package at the same constants, depth, seed and data, on the CPU with
# 64 chains (tests/reference_workload_jax.py --workload stochvol --chains 64
# at each depth; mala as first measured, PERF.md): acceptance, and the mean and
# sd over chains of the per-chain hyper means (beta, sigma, phi).
SV_JAX_CHAINS = 64
SV_JAX = {
    "rmhmc": {"accept": 0.97919, "mean": [0.57688, 0.39101, 0.90810], "sd": [0.022739, 0.076522, 0.033959]},
    "hmc": {"accept": 0.73724, "mean": [0.54693, 0.71303, 0.71246], "sd": [0.040468, 0.26184, 0.14775]},
    "mmala": {"accept": 0.87643, "mean": [0.61066, 0.60137, 0.28221], "sd": [0.0071586, 0.026313, 0.083836]},
    "mala": {"accept": 0.81891, "mean": [0.63407, 0.54942, 0.11832], "sd": [0.0061821, 0.016158, 0.049598]},
}
ACCEPT_TOL = 0.05  # |accept - JAX accept|
SV_BOXES = ((0.4, 0.95), (0.03, 0.45), (0.55, 1.0))  # (beta, sigma, phi), tests/test_stochvol.py:77-79
HYPER_L = rt.samplers.stochvol.StochVolConfig().hyper_num_leapfrog  # 6, the rmhmc preset's
HYPER_FP = rt.samplers.stochvol.StochVolConfig().hyper_num_fixed_point  # 5


def sv_config(method: str) -> "rt.samplers.stochvol.StochVolConfig":
    """The StochVolConfig that ``experiments.build_workload`` gives ``method``'s sampling kernel (its
    preset), recorded as the kernel is built."""
    seen, inner = [], rt.samplers.stochvol.build

    def build(model, config):
        seen.append(config)
        return inner(model, config)
    with unittest.mock.patch.object(rt.samplers.stochvol, "build", build):
        experiments.build_workload("stochvol", method, device=DEVICE, seed=SV_SEED, stochvol_obs=8)
    return seen[0]  # MALA's burn-in kernel is built after its sampling kernel


def sv_expected_launches(method: str, sweeps: int, t: int = SV_OBS) -> dict:
    """K1 / K2 / K3, T1 and T2 launches of a stochvol run, read from the code: the
    hyper kernel is rebuilt every sweep; RMHMC builds the geometry at the start
    and after each leapfrog step (K3) and solves once per position fixed-point
    round (K2); mMALA factors in ``init`` and at the proposal (K1).  The latent
    update of rmhmc, hmc and mmala factors its tridiagonal metric once a sweep
    (T1) and solves with it (T2) once a latent leapfrog step and twice for the
    kinetic energies (rmhmc, hmc: L + 2 with the run's own latent L) or three
    times (mmala: two drifts and the proposal's noise), each solve
    ``tridiag.pcr_geometry(t).launches`` launches (one at t <= PCR_SHARED_MAX_T);
    MALA's has no metric."""
    solves = {"rmhmc": sv_config("rmhmc").latent_num_leapfrog + 2, "hmc": sv_config("hmc").latent_num_leapfrog + 2,
              "mmala": 3, "mala": 0}[method]
    launches = solves * rt.ops.tridiag.pcr_geometry(t).launches * sweeps
    latent = {} if method == "mala" else {BIDIAG: sweeps, PCR: launches}
    if method == "rmhmc":
        return {**NO_LINALG, "chol_solve_logdet": HYPER_L * HYPER_FP * sweeps,
                "chol_inv_logdet": (1 + HYPER_L) * sweeps, **latent}
    if method == "mmala":
        return {**NO_LINALG, "cholesky": 2 * sweeps, **latent}
    return {**NO_LINALG, **latent}


def sv_sweep_routes(method: str) -> dict:
    """One captured StochVol sweep from one state and one noise, through T2 and again with
    ``tridiag.solve_plain`` patched in for ``tridiag.solve`` (T1 factors in both): the two must be
    ``torch.equal`` leaf for leaf, and each graph's replay counts its own T1 and T2 launches."""
    kernel, init_fn, *_ = experiments.build_workload("stochvol", method, device=DEVICE, seed=SV_SEED,
                                                     stochvol_obs=SV_OBS)
    gen = torch.Generator(device=DEVICE).manual_seed(SV_SEED + 1)
    with rt.ops.launches.paused():
        state = kernel.init(init_fn(SV_CHAINS))
        for _ in range(2):  # a state off the initial x = y
            state, _ = kernel.step(gen, state)
        noise = kernel.draw_noise(gen, state)
    out, counts = {}, {}
    for route in ("T2", "solve_plain"):
        patch = (unittest.mock.patch.object(rt.ops.tridiag, "solve", rt.ops.tridiag.solve_plain)
                 if route == "solve_plain" else contextlib.nullcontext())
        with patch:
            with rt.ops.launches.paused():
                kernel.transition(state, noise)  # warm: allocations outside the capture
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out[route] = kernel.transition(state, noise)
        rt.ops.launches.reset((BIDIAG, PCR))
        graph.replay()
        counts[route] = rt.ops.launches.counts((BIDIAG, PCR))
        del graph
    differs = differing_leaves(out["T2"], out["solve_plain"])
    expected = sv_expected_launches(method, 1)
    check(not differs, f"stochvol/{method}: a captured sweep through T2 and one through solve_plain differ in "
                       f"leaves {differs}")
    check(counts["T2"] == {BIDIAG: 1, PCR: expected[PCR]} and counts["solve_plain"] == {BIDIAG: 1, PCR: 0},
          f"stochvol/{method}: one captured sweep's T1 / T2 launches {counts}, expected T1 1 on both routes and "
          f"T2 {expected[PCR]} through T2")
    return {"run": f"stochvol/{method}", "equal": True, "launches": counts}


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
    for method in ("rmhmc", "hmc", "mmala"):
        say("stochvol-sweep-routes", chains=SV_CHAINS, T=SV_OBS, **sv_sweep_routes(method))
    launches_by_path, rm = {}, None
    for method, (burn, samples) in SV_RUNS.items():
        label = f"stochvol/{method}"
        reset_blr_launches()
        res = experiments.run_workload("stochvol", method, device=DEVICE, num_chains=SV_CHAINS, num_samples=samples,
                                       burn_in=burn, seed=SV_SEED, keep_samples=True, stochvol_obs=SV_OBS)
        launches = blr_launches()
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
            SEEN_ACCEPT[label] = res.accept_rate
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
        check(launches_by_path[label] == NO_LINALG, f"{label}: a kernel launched at D={d}")
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
    """K1 / K2 / K3 launches of a joint LGC run, read from the code: the hyper
    kernel is rebuilt and ``init``-ed every sweep.  RMHMC builds the (C, 2, 2)
    geometry in ``init`` and after each of its L leapfrog steps (K3) and solves
    once per position fixed-point round (K2); mMALA factors in ``init`` and at
    the proposal (K1).  The latent block and the GP algebra are at D = n^2: library calls."""
    if sampler == "rmhmc_joint":
        return {**NO_LINALG, "chol_inv_logdet": (1 + JOINT_CFG.hyper_num_leapfrog) * sweeps,
                "chol_solve_logdet": JOINT_CFG.hyper_num_leapfrog * JOINT_CFG.hyper_num_fixed_point * sweeps}
    return {**NO_LINALG, "cholesky": 2 * sweeps}


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
FHN_GEOMETRY_CHAINS = (1, 31, 256, 257, 4224)  # a lone chain, ragged groups and blocks, phase 3's, one warp per SM
# Kernel against twin: |k - p| <= 1e-4 x the output's largest finite |entry|.  Both
# are float32 with another order of operations (FMAs, another summation
# order); the JAX package's own float32 / float64 spread on this model is
# <= 1.9e-5 of each output's scale.
FHN_TOL = 1e-4
FHN_SPECIAL = ((-0.1, 0.2, 3.0), (0.2, 0.2, 100.0))  # outside the support; a trajectory that overflows
# Past the 6,144 observations that the kernel's first form staged in 48 KB of shared memory: the kernel
# against its twin at (num_obs, orders) on FHN_LONG_CHAINS chains and FHN_LONG_SUBSTEPS substeps, the twin
# on the card's host CPU (its Python loop of ~30-300 operations a step: 1.9, 4.1 and 8.7 s for orders 0-2
# at 8,192 observations, 9.2 s for order 0 at 50,000 on an H100 machine's host, where the card takes a
# launch an operation), at FHN_TOL (float32 against float64 twins on a CPU: at most 1e-5 of each output's
# scale).  Timed at 256 chains: FHN_LONG_TIMED (num_obs, substeps), phase 10's long run and the longest
# grid, every order.  The data: fhn_long_data.
FHN_LONG = ((8192, (0, 1, 2)), (50000, (0,)))
FHN_LONG_CHAINS, FHN_LONG_SUBSTEPS = 16, 1
FHN_LONG_TIMED = ((8192, 5), (50000, 1))
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


def fhn_data(num_obs: int = FHN_OBS):
    data, _ = rt.models.fhn.generate_data(seed=FHN_SEED if FHN_SEED > 0 else 1, num_obs=num_obs)
    return torch.tensor(data, dtype=torch.float32, device=DEVICE)


@functools.cache
def fhn_long_data(num_obs: int):
    """``generate_data``'s recipe at one RK4 step an observation interval in place of its 20: from ~4,000
    observations on that step, 20 / (num_obs - 1), is finer than the recipe's at 200 observations, and
    its Python loop of 20 steps an interval took ~150 s at 50,000 observations on the card's host."""
    with torch.inference_mode():
        clean = rt.models.fhn.integrate_rk4(torch.tensor(rt.models.fhn.THETA_TRUE), num_obs=num_obs,
                                            substeps=1).numpy()
    noisy = clean + np.random.default_rng(FHN_SEED if FHN_SEED > 0 else 1).normal(size=clean.shape) * 0.5
    return torch.tensor(noisy, dtype=torch.float32, device=DEVICE)


def fhn_thetas(c: int) -> tuple[torch.Tensor, list[int]]:
    """Seeded theta around the truth, with the special chains in the middle
    of a block and as the batch's last chain."""
    gen = torch.Generator(device=DEVICE).manual_seed(c)
    truth = torch.tensor(rt.models.fhn.THETA_TRUE, device=DEVICE)
    theta = truth * (1.0 + 0.1 * torch.randn((c, 3), generator=gen, device=DEVICE))
    special = [c // 2 + 5, c - 1]
    theta[special] = torch.tensor(FHN_SPECIAL, device=DEVICE)
    return theta, special


def check_fhn_kernel(c: int, order: int, data, err: dict, substeps: int = FHN_SUBSTEPS,
                     twin_device: str = DEVICE) -> float:
    """The kernel against its twin at one (C, order), the twin run on ``twin_device``; returns the twin's ms.
    The chain outside the support is masked at any grid; the chain with c = 100 overflows on the 200 x 5
    grid (h = 0.02), and on a finer one, whose RK4 step is stable there, is held like any other."""
    theta, special = fhn_thetas(c)
    consts = {**fhn_constants(), "substeps": substeps}
    at = f"(C={c}, order {order}, {data.shape[0]} x {substeps})"
    k = rt.ops.fhn_sens.fhn_sensitivities_cuda(theta, data, order, **consts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = rt.ops.fhn_sens.fhn_sensitivities_plain(theta.to(twin_device), data.to(twin_device), order, **consts)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    keep = torch.ones(c, dtype=torch.bool, device=DEVICE)
    keep[special] = False
    alone = rt.ops.fhn_sens.fhn_sensitivities_cuda(theta[keep].contiguous(), data, order, **consts)
    torch.cuda.synchronize()
    for name, kt, pt, at_ in zip(k._fields, k, p, alone):
        if kt is None:
            continue
        pt = pt.to(DEVICE)
        fin = torch.isfinite(pt)
        check(torch.equal(torch.isfinite(kt), fin), f"fhn {name} {at}: non-finite entries differ from the twin's")
        scale = float(pt[fin].abs().max())
        e = float((kt - pt)[fin].abs().max())
        check(e <= FHN_TOL * scale, f"fhn {name} vs twin {at}: max |err| {e} > {FHN_TOL} x {scale}")
        err[name] = max(err.get(name, 0.0), e / scale)
        same = (kt[keep] == at_) | (torch.isnan(kt[keep]) & torch.isnan(at_))
        check(bool(same.all()), f"fhn {name} {at}: other chains' outputs change with the special chains")
    masked = special if (data.shape[0], substeps) == (FHN_OBS, FHN_SUBSTEPS) else special[:1]
    check(bool((k.logp[masked] == -torch.inf).all() and (p.logp[masked] == -torch.inf).all()),
          f"fhn logp {at}: not -inf at the chains {masked}")
    if order >= 1:
        check(bool((k.grad[masked] == 0).all() and (p.grad[masked] == 0).all()),
              f"fhn grad {at}: not 0 at the chains {masked}")
    return plain_ms


def fhn_bound_us(order: int, c: int, num_obs: int = FHN_OBS, substeps: int = FHN_SUBSTEPS) -> tuple[float, str, float]:
    """(bound_us, bound_by, operations): bytes once (theta, data in; the
    order's outputs out) at 3.35 TB/s against the operations counted from the
    source at 67 TFLOP/s."""
    outputs = {0: 1, 1: 1 + 3 + 9, 2: 1 + 3 + 9 + 27}[order]
    nbytes = 4 * (3 * c + 2 * num_obs + outputs * c)
    ops = rt.ops.fhn_sens.operations(order, c, num_obs, substeps)
    by_bytes, by_ops = 1e6 * nbytes / HBM_BYTES_PER_S, 1e6 * ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", ops


def sm_clock_max_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.splitlines()[0])


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
    (l3, inv3, half3), (_, invp, halfp) = hl.chol_inv_logdet_cuda(g), hl.chol_inv_logdet_plain(g)
    torch.cuda.synchronize()
    errs = {"L": excess(lk, lp, TOL["L"]), "x": excess(xk, xp, TOL["x"]), "logdet": excess(ldk, ldp, TOL["logdet"]),
            "K3 half logdet": excess(half3, halfp, TOL["logdet"])}
    check(all(over <= 0 for _, over in errs.values()), f"K1 / K2 / K3 vs twins on FHN metrics beyond tolerance: {errs}")
    check(torch.equal(l3, lk) and torch.equal(inv3, inv3.mT), "K3 on FHN metrics: factor not K1's, or inverse not symmetric")
    check(torch.equal(inv3, hl.inv_in_kernel_order(l3)), "K3 on FHN metrics: inverse not its replay's bit for bit")
    # These metrics are ill-conditioned: each chain's inverse against the twin's within INV_COND_TOL x its
    # condition number, relative to its largest entry (two float32 inverses part by ~cond x eps).
    cond = torch.linalg.cond(g.double())
    inv_rel = ((inv3 - invp).abs().flatten(1).max(1).values / invp.abs().flatten(1).max(1).values).double()
    check(bool((inv_rel <= INV_COND_TOL * cond).all()), f"K3's inverse vs twin on FHN metrics: relative "
                                                         f"{float(inv_rel.max())} beyond {INV_COND_TOL} x cond")
    k_err["cholesky"] = max(k_err["cholesky"], errs["L"][0])
    k_err["chol_solve_logdet"] = max(k_err["chol_solve_logdet"], errs["x"][0], errs["logdet"][0])
    k_err["chol_inv_logdet"] = max(k_err["chol_inv_logdet"], errs["K3 half logdet"][0])
    return {"max_abs_err": {name: e for name, (e, _) in errs.items()}, "max_entry": float(g.abs().max()),
            "condition_min_max": [float(cond.min()), float(cond.max())],
            "k3_inverse_relative_err_over_cond_max": float((inv_rel / cond).max())}


def phase_fhn_kernel(smi: str, k_err: dict) -> dict:
    """The FHN kernel against its twin and its times, then K1 / K2 / K3 on its
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
    clock_mhz = sm_clock_max_mhz()
    critical_path = rt.ops.fhn_sens.critical_path_us(FHN_OBS, FHN_SUBSTEPS, clock_mhz)
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
            **times[order], critical_path_us=critical_path, share_of_critical_path=critical_path / dev["us"],
            sm_clock_max_mhz=clock_mhz, geometry=rt.ops.fhn_sens.launch_geometry(order, FHN_CHAINS, FHN_OBS)._asdict(),
            library="none: no single PyTorch call integrates an ODE with its sensitivities")
    say("fhn-kernel-scaling", card=smi, **fhn_scaling(data))
    long = fhn_long_series(smi, clock_mhz, err)
    return {"err": max(err.values()), "err_by_output": err, "times": times, "long": long}


def fhn_long_series(smi: str, clock_mhz: float, err: dict) -> dict:
    """The kernel past 6,144 observations: against its twin (FHN_LONG, the twin on the host's CPU), then
    its times at 256 chains (FHN_LONG_TIMED) beside the bound and the critical path: CUDA events around
    5 launches back to back (milliseconds each, so the host's share is noise), since torch.profiler saw
    no device event in four sessions of these launches late in the script."""
    long_err, plain_ms = {}, {}
    for num_obs, orders in FHN_LONG:
        data = fhn_long_data(num_obs)
        for order in orders:
            plain_ms[f"{num_obs}x{FHN_LONG_SUBSTEPS}/order{order}"] = check_fhn_kernel(
                FHN_LONG_CHAINS, order, data, long_err, substeps=FHN_LONG_SUBSTEPS, twin_device="cpu")
    for name, e in long_err.items():
        err[name] = max(err[name], e)
    say("fhn-kernel-long", checked={str(num_obs): list(orders) for num_obs, orders in FHN_LONG}, C=FHN_LONG_CHAINS,
        substeps=FHN_LONG_SUBSTEPS, twin="float32 on the host's CPU", max_err_of_scale=long_err,
        tolerance_of_scale=FHN_TOL, twin_ms_cpu=plain_ms)
    theta, _ = fhn_thetas(FHN_CHAINS)
    times = {}
    for num_obs, substeps in FHN_LONG_TIMED:
        data = fhn_long_data(num_obs)
        critical_path = rt.ops.fhn_sens.critical_path_us(num_obs, substeps, clock_mhz)
        for order in rt.ops.fhn_sens.ORDERS:
            def launch():
                return rt.ops.fhn_sens.fhn_sensitivities_cuda(theta, data, order,
                                                             **{**fhn_constants(), "substeps": substeps})
            event_us = 1e3 * burst_ms(launch, launches=5, warmup=1)
            bound, bound_by, ops = fhn_bound_us(order, FHN_CHAINS, num_obs, substeps)
            row = {"ms": median_ms(launch, reps=5, warmup=1), "event_us": event_us,
                   "event_us_source": "CUDA events, 5 launches back to back", "bound_us": bound, "bound_by": bound_by,
                   "operations": ops, "share_of_bound": bound / event_us, "critical_path_us": critical_path,
                   "share_of_critical_path": critical_path / event_us,
                   "shared_bytes": rt.ops.fhn_sens.launch_geometry(order, FHN_CHAINS, num_obs).shared_bytes}
            times[f"{num_obs}x{substeps}/order{order}"] = row
            say("fhn-kernel-times", order=order, C=FHN_CHAINS, num_obs=num_obs, substeps=substeps, card=smi, **row,
                sm_clock_max_mhz=clock_mhz)
    return {"err_by_output": long_err, "twin_ms_cpu": plain_ms, "times": times}


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
    """(FHN-kernel launches by order, K1 / K2 / K3 launches) of a run, read from the
    code: RMHMC calls ``manifold_state`` (order 2, then K3) in ``init`` and
    after each leapfrog step and ``metric`` (order 1, then K2) in each round of
    the position fixed point; mMALA ``manifold_state`` and K1 in ``init`` and
    at the proposal; HMC ``logp`` in ``init`` and at the trajectory's end and
    ``grad`` at its start and after each of the L steps; MALA
    ``logp_and_grad`` in ``init`` and at the proposal; Metropolis ``logp``
    in ``init`` and once per coordinate."""
    fhn, k1, k2, k3 = {0: 0, 1: 0, 2: 0}, 0, 0, 0
    if sampler == "rmhmc":
        fhn[2] = k3 = 1 + FHN_RMHMC_L * sweeps
        fhn[1] = k2 = FHN_RMHMC_L * FHN_RMHMC_FP * sweeps
    elif sampler in ("mmala", "mmala_simplified"):
        fhn[2] = k1 = 1 + sweeps
    elif sampler == "hmc":
        fhn[1], fhn[0] = (1 + FHN_HMC_L) * sweeps, 1 + sweeps
    elif sampler == "mala":
        fhn[1] = 1 + sweeps
    else:  # metropolis
        fhn[0] = 1 + 3 * sweeps
    return fhn, {"cholesky": k1, "chol_solve_logdet": k2, "chol_inv_logdet": k3}


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
        check(k_launches == k_expected, f"{label}: K1 / K2 / K3 launches {k_launches}, expected {k_expected}")
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
    fhn_by_path[FHN_LONG_LABEL], k_by_path[FHN_LONG_LABEL] = fhn_long_rmhmc(smi)
    return {"kernel": kernel, "fhn_by_path": fhn_by_path, "k_by_path": k_by_path}


# FHN RMHMC on a grid of 8,192 observations (past the 6,144 of the kernel's first form) at 5 substeps,
# 256 chains, GRAPH_SMALL_RUN eager against captured.
FHN_LONG_RUN = (8192, 5)  # (num_obs, substeps)
FHN_LONG_LABEL = "fhn/rmhmc-8192x5-captured"


def fhn_long_rmhmc(smi: str) -> tuple[dict, dict]:
    """RMHMC at FHN_LONG_RUN, captured against eager; returns the captured run's FHN-kernel and K1 / K2 / K3
    launch counts."""
    num_obs, substeps = FHN_LONG_RUN
    kernel, init_fn, *_ = experiments.build_workload("fhn", "rmhmc", device=DEVICE, seed=FHN_SEED, fhn_obs=num_obs,
                                                     fhn_substeps=substeps)
    fhn_expected, k_expected = fhn_expected_launches("rmhmc", sum(GRAPH_SMALL_RUN))
    pair = captured_pair_checked(FHN_LONG_LABEL, kernel, init_fn(FHN_CHAINS), {"fhn": fhn_expected, **k_expected},
                                 lambda counts: {"fhn": counts["fhn"], **counts["k1_k2"]})
    say("fhn", run=FHN_LONG_LABEL, num_obs=num_obs, substeps=substeps, chains=FHN_CHAINS,
        burn_in=GRAPH_SMALL_RUN[0], samples=GRAPH_SMALL_RUN[1], fhn_launches=pair["captured"]["fhn"],
        launches=pair["captured"]["k1_k2"], eager_and_captured_equal=True,
        accept_rate=pair["accept_rate"], replays_under_profiler=pair["replays_under_profiler"],
        capture_s=pair["capture_s"], graph_pool_bytes=pair["graph_pool_bytes"])
    steps = sum(GRAPH_SMALL_RUN)
    say("fhn-times", run=FHN_LONG_LABEL, card=smi,
        s_per_transition={path: pair[path]["seconds"] / steps for path in ("eager", "captured")})
    return pair["captured"]["fhn"], pair["captured"]["k1_k2"]


def fhn_summary(fhn: dict, smi: str) -> dict:
    """The FHN kernel's entry of the kernels line: order 2 at (256, 200, 5) at
    the top (RMHMC's and mMALA's geometry), every order under "orders"."""
    times = fhn["kernel"]["times"]
    top = times[2]
    total = sum(sum(counts.values()) for counts in fhn["fhn_by_path"].values())
    return {
        "name": "fhn_sensitivities", "route": "cuda", "source": FHN_SOURCE, "replaces": FHN_REPLACES,
        "launches": total, "launches_counted_by": LAUNCHES_COUNTED_BY, "max_abs_err": fhn["kernel"]["err"],
        "max_abs_err_is": "of each output's scale",
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
DIST_ADAPT_RUN = dict(num_chains=NUM_CHAINS, burn_in=3, num_samples=6)  # adaptive RMHMC, captured against eager
DIST_DIR = SMOKE_DATA.parent / "smoke_dist"
# The samplers the chain split took last (AMH's and the Gibbs sweep's noise
# coordinate-major, Gibbs's GIG counters indexed by the global element, the two-block
# samplers' noise drawn from the state), two ranks, 5 + 5 each.
DIST_SPLIT_RUN = (5, 5)
DIST_GIBBS_CHAINS, DIST_SV_CHAINS, DIST_LGCJ_CHAINS = 256, 64, 4
# These samplers expose no |log a - log u| per decision (AMH's are per
# coordinate, the two-block samplers' per block, Gibbs's inside the GIG's
# rounds), so the one-process run finds the chains near a decision boundary
# by probing: before each step every entry of the state is moved by a
# relative PROBE_SCALE of random sign (and then of the opposite signs), ~100x
# the float32 rounding a transition leaves, and the step rerun on the same
# draws; a chain whose next state then moves by more than PROBE_JUMP (rtol,
# atol) took a decision within reach of rounding, and may part.  Random
# signs, not one scale for the whole state: Gibbs's GIG draw depends on
# r = z - x beta, which a common scale only scales, while rounding can
# change it by far more than its own relative error where it cancels.
PROBE_SCALE = 1e-4
PROBE_JUMP = (1e-3, 1e-3)
# DIST_TOL is BLR RMHMC's rounding scale.  Two of these samplers carry the
# batch-size rounding (another GEMM / batched-factorization M per rank)
# through ill-conditioned algebra with no decision on the way, so their
# chains part from one process's continuously by more than it: Gibbs through
# the inverse of X^T Lambda^-1 X (a sum over the 690 rows), the 690-step
# sequential z / B sweep and r = z - x beta into lambda; joint LGC through
# K(beta)^-1 and its log-determinant at D = n^2 = 1024 and the hyper
# metric's traces over D.  Their gates, with the ratio to DIST_TOL and the
# chains beyond it printed beside (PERF.md):
DIST_SPLIT_TOL = {"gibbs-blr": (1e-4, 1e-4), f"lgc-joint-mmala-n{LGCJ_SMALL_N}": (1e-3, 1e-3)}


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

    return rt.samplers.Kernel(init, step, transition, kernel.draw_noise, capturable=kernel.capturable)


class ProbeState(NamedTuple):
    inner: object
    near: torch.Tensor  # (C,) bool: a step of the run so far was within reach of rounding of a decision

    @property
    def position(self) -> torch.Tensor:
        return self.inner.position


def with_discontinuity_probe(kernel):
    """``kernel`` that also marks, per chain, the steps whose outcome a change
    of PROBE_SCALE in the state moves by more than PROBE_JUMP: each step runs
    three times on the same draws (the generator rewound), on the state and
    on it with every entry x moved to x (1 + PROBE_SCALE s) and x (1 -
    PROBE_SCALE s), s a random sign per entry, and every per-chain leaf of
    the next state is compared (a decision may show only there first: a GIG
    draw changes lambda, and the position a step later).  One process, no
    mesh."""
    rtol, atol = PROBE_JUMP
    tree_map = rt.samplers.base.tree_map
    signs = torch.Generator(device=DEVICE).manual_seed(DIST_SEED + 1)

    def moved(x: torch.Tensor, s: torch.Tensor, scale: float) -> torch.Tensor:
        return x * (1.0 + scale * s) if x.is_floating_point() else x

    def init(position):
        return ProbeState(kernel.init(position), torch.zeros(position.shape[:1], dtype=torch.bool, device=position.device))

    def step(generator, state):
        before = generator.get_state()
        inner, info = kernel.step(generator, state.inner)
        after = generator.get_state()
        c, near = inner.position.shape[0], [state.near]

        def jump(a, b):
            if a.ndim > 0 and a.is_floating_point():
                moved = ~torch.isfinite(a) | ((a - b).abs() > atol + rtol * b.abs())
                near.append(moved.reshape(c, -1).any(-1))

        s = tree_map(lambda x: 2.0 * torch.randint(0, 2, x.shape, generator=signs, device=x.device) - 1.0, state.inner)
        for scale in (PROBE_SCALE, -PROBE_SCALE):
            generator.set_state(before)
            probe, _ = kernel.step(generator, tree_map(lambda x, sx: moved(x, sx, scale), state.inner, s))
            tree_map(jump, probe, inner)
        generator.set_state(after)
        return ProbeState(inner, torch.stack(near).any(0)), info

    return rt.samplers.Kernel(init, step)


@contextlib.contextmanager
def min_all_reduces(record: list):
    """Each MIN all-reduce the port makes inside (an exit test agreed over the
    ranks) appended to ``record``.  None is expected: Gibbs's GIG, the one
    such test once, exits per element inside its kernel."""
    real = collectives.all_reduce

    def all_reduce(x, group, op=dist.ReduceOp.SUM):
        if op == dist.ReduceOp.MIN:
            record.append(1)
        return real(x, group, op)

    with unittest.mock.patch.object(collectives, "all_reduce", all_reduce):
        yield


def split_runs(model) -> dict:
    """label -> (kernel, global initial position, expected K1 / K2 / K3 launches
    of a run of ``steps`` transitions) of the four samplers."""
    steps = sum(DIST_SPLIT_RUN)
    init = rt.utils.default_init(model, torch.Generator(device=DEVICE).manual_seed(DIST_SEED), NUM_CHAINS)
    sv_kernel, sv_init, *_ = experiments.build_workload("stochvol", "rmhmc", device=DEVICE, seed=SV_SEED,
                                                        stochvol_obs=SV_OBS)
    lgcj_kernel, lgcj_init, *_ = experiments.build_workload("lgc", "mmala_joint", device=DEVICE, seed=LGCJ_SEED,
                                                            lgc_n=LGCJ_SMALL_N)
    return {
        "metropolis-blr": (experiments.build_kernel("metropolis", model, "australian")[0], init,
                           dict(NO_LINALG)),
        "gibbs-blr": (experiments.build_kernel("gibbs", model, "australian")[0], init[:DIST_GIBBS_CHAINS].clone(),
                      BlrRun("gibbs", burn_in=steps, samples=0).expected_launches()),
        "stochvol-rmhmc": (sv_kernel, sv_init(DIST_SV_CHAINS), sv_expected_launches("rmhmc", steps)),
        f"lgc-joint-mmala-n{LGCJ_SMALL_N}": (lgcj_kernel, lgcj_init(DIST_LGCJ_CHAINS),
                                              lgcj_expected_launches("mmala_joint", steps)),
    }


@contextlib.contextmanager
def issued_all_reduces(record: list):
    """Each ``dist.all_reduce`` the port issues inside appended to ``record``:
    the host's count, against which the device counter is held."""
    real = dist.all_reduce

    def all_reduce(*args, **kwargs):
        record.append(1)
        return real(*args, **kwargs)

    with unittest.mock.patch.object(dist, "all_reduce", all_reduce):
        yield


def dist_run(kernel, init, mesh, burn: int, samples: int, capture: bool | None = None) -> dict:
    """Burn-in and a timed sampling run through ``parallel.run(..., mesh=)``,
    with the K1 / K2 / K3 launches, the all-reduces it made (device-counted, and
    issued on the host: the warm-up before a capture issues uncounted ones),
    the graphs captured in the burn-in and in the timed run (none)."""
    gen = torch.Generator(device=DEVICE).manual_seed(DIST_SEED)
    reset_blr_launches()
    collectives.reset_call_counts()
    issued, captures = [], rt.parallel.graphs.capture_count()
    with issued_all_reduces(issued):
        warm = rt.parallel.run(kernel, gen, init, num_samples=burn, collect=False, mesh=mesh, capture=capture)
        torch.cuda.synchronize()
        timed_captures = rt.parallel.graphs.capture_count()
        t0 = time.perf_counter()
        res = rt.parallel.run(kernel, gen, None, num_samples=samples, init_state=warm.final_state, mesh=mesh,
                              capture=capture)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return {"samples": res.samples, "accept": res.accept_rate, "div": res.divergences + warm.divergences,
            "seconds": seconds, "launches": blr_launches(),
            "all_reduce": collectives.call_counts()["all_reduce"], "all_reduce_issued": len(issued),
            "captures": timed_captures - captures,
            "timed_captures": rt.parallel.graphs.capture_count() - timed_captures, "state": res.final_state}


def same_run(a: dict, b: dict) -> dict:
    return {k: torch.equal(a[k], b[k]) for k in ("samples", "accept", "div")}


def replay_all_reduces(kernel, state, group, replays: int = GRAPH_REPLAYS) -> dict:
    """The all-reduces of ``kernel``'s step: issued by one eager step (the
    host's count), counted on the device over ``replays`` replays of the
    graph the runner captured, and the NCCL kernels torch.profiler sees in
    those replays, against those it sees for as many eager all-reduces on
    ``group`` (NCCL's one-rank in-place sum launches none)."""
    from torch.profiler import ProfilerActivity, profile

    def nccl_events(fn) -> int:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum("nccl" in e.name.lower() for e in prof.events() or ()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    entry = rt.parallel.graphs.lookup(kernel.step, None, state)
    check(entry is not None, "no captured graph of the step: the run with the mesh did not take the captured path")
    gen = torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED)
    issued = []
    with issued_all_reduces(issued), rt.ops.launches.paused():
        kernel.step(gen, rt.samplers.base.tree_map(torch.clone, state))
    entry.scan(gen, state, 1, False)  # warm
    collectives.reset_call_counts()
    replayed = nccl_events(lambda: entry.scan(gen, state, replays, False))
    counted = collectives.call_counts()["all_reduce"]
    probe = torch.zeros(8, device=DEVICE)
    with rt.ops.launches.paused():
        eager = nccl_events(lambda: [dist.all_reduce(probe, group=group) for _ in range(counted)])
    return {"replays": replays, "issued_per_eager_step": len(issued), "counted_on_device": counted,
            "profiler_nccl_kernels_replayed": replayed, "profiler_nccl_kernels_eager_same_count": eager,
            "equal": counted == replays * len(issued) and replayed == eager}


def captured_and_eager(label: str, kernel, init, mesh, burn: int, samples: int) -> tuple[dict, dict]:
    """``dist_run`` captured (the default on a card) and eager: whether the
    two are bit for bit the same, and the captures each made."""
    run = dist_run(kernel, init, mesh, burn, samples)
    eager = dist_run(kernel, init, mesh, burn, samples, capture=False)
    same = same_run(run, eager)
    return run, {f"{label}_capturable": kernel.capturable, f"{label}_eager_equal": all(same.values()),
                 f"{label}_captures": [run["captures"], run["timed_captures"], eager["captures"] + eager["timed_captures"]],
                 f"{label}_eager_s_per_transition": eager["seconds"] / samples}


def distributed_rank(out: str) -> None:
    """One of two ranks sharing the card over Gloo (run by ``parallel.launch``):
    BLR RMHMC at full width with the chains split (captured, and eager), then
    with the rows split (eager: its all-reduces are Gloo's; ``capture=True``
    refused), and checkpoint shards; writes ``two_rank.r<rank>.npz`` under
    ``out``."""
    rank, out = dist.get_rank(), Path(out)
    model = blr_model()
    init = torch.from_numpy(np.load(out / "init.npy")).to(DEVICE)
    burn, samples = DIST_TWO_RANK_RUN
    arrays = {}
    with torch.inference_mode():
        for label, shape in (("chains", (2, 1)), ("data", (1, 2))):
            mesh = rt.parallel.make_mesh(2, (CHAIN_AXIS, "data"), shape)
            # The chain split on the whole model (a step with no collective); the row split on the sharded one.
            kernel = with_margins(rmhmc.build(model if label == "chains" else model.with_sharding(mesh)))
            if label == "chains":
                run, fields = captured_and_eager(label, kernel, init, mesh, burn, samples)
                arrays.update(fields)
            else:
                run = dist_run(kernel, init, mesh, burn, samples)
                arrays.update({f"{label}_capturable": kernel.capturable, f"{label}_captures": [run["captures"],
                                                                                              run["timed_captures"]]})
                try:
                    rt.parallel.run(kernel, torch.Generator(device=DEVICE).manual_seed(DIST_SEED), init,
                                    num_samples=1, mesh=mesh, capture=True)
                    arrays["data_refused"] = ""
                except ValueError as err:
                    arrays["data_refused"] = str(err)
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
    # The four samplers the chain split took last, and the MIN all-reduces each made (none).
    mesh = rt.parallel.make_mesh(2, (CHAIN_AXIS, "data"), (2, 1))
    with torch.inference_mode():
        for label, (kernel, init, _) in split_runs(model).items():
            tests = []
            with min_all_reduces(tests):
                run, fields = captured_and_eager(label, kernel, init, mesh, *DIST_SPLIT_RUN)
            arrays.update(fields)
            arrays.update({f"{label}_samples": run["samples"], f"{label}_accept": run["accept"],
                           f"{label}_div": run["div"], f"{label}_min_all_reduces": len(tests),
                           f"{label}_s_per_transition": run["seconds"] / DIST_SPLIT_RUN[1],
                           **{f"{label}_{k}": v for k, v in run["launches"].items()}})
    np.savez(out / f"two_rank.r{rank}.npz",
             **{k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in arrays.items()})


def compare_to_one_process(label: str, samples: np.ndarray, margin: np.ndarray | None, ref: dict,
                           tol: tuple[float, float] = DIST_TOL) -> dict:
    """Every chain against the one-process run: the same accept decisions and
    positions within ``tol``, unless its decisions came within DIST_MARGIN
    of the boundary in either run (``margin``), or, where the sampler gives
    no margin (None), the probe of the one-process run marked it
    (``ref["near"]``): then it may part, and is counted.  Prints the largest
    ratio of a difference to its tolerance, atol + rtol |ref|, over the
    chains that did not part (and to DIST_TOL where ``tol`` is another)."""
    rtol, atol = tol
    moved = lambda smp: (smp[:, 1:] != smp[:, :-1]).any(-1)  # noqa: E731
    diff = np.abs(samples - ref["samples"])
    ratio = (diff / (atol + rtol * np.abs(ref["samples"]))).max(axis=(1, 2))
    kept = (moved(samples) == moved(ref["samples"])).all(axis=1) & (ratio <= 1.0)
    near = ref["near"] if margin is None else np.minimum(margin, ref["margin"]) <= DIST_MARGIN
    stray = ~kept & ~near
    check(not stray.any(), f"{label}: {int(stray.sum())} chains away from the accept boundary part from the "
                           f"one-process run (worst ratio to the tolerance {float(ratio.max())}; "
                           f"{int((~kept).sum())} parted, {int(near.sum())} near a boundary)")
    parted = ~kept
    out = {"chains": int(samples.shape[0]), "parted_near_boundary": int(parted.sum()),
           "near_boundary": int(near.sum()),
           "max_abs_diff": float(diff[kept].max()) if kept.any() else None,
           "worst_ratio_to_tolerance": float(ratio[kept].max()) if kept.any() else None,
           "tolerance": {"rtol": rtol, "atol": atol}}
    if margin is not None:
        out["largest_margin_of_parted"] = (float(np.minimum(margin, ref["margin"])[parted].max())
                                           if parted.any() else None)
    if tol != DIST_TOL and kept.any():
        to_dist = (diff / (DIST_TOL[1] + DIST_TOL[0] * np.abs(ref["samples"]))).max(axis=(1, 2))
        out["worst_ratio_to_dist_tol"] = float(to_dist[kept].max())
        out["kept_beyond_dist_tol"] = int((to_dist[kept] > 1.0).sum())
    return out


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
        "K4 position_fixed_point": (lambda w, pm, dt: model.position_fixed_point(w, pm, pm, dt, rounds=K),
                                    (init, u, noise.u_dir)),
        "K5 momentum_fixed_point": (lambda w, inv, c, p, dt: model.momentum_fixed_point(w, inv, c, p, p, p, dt, rounds=K),
                                    (init, torch.linalg.inv(g), model.dg_cache(init), u, noise.u_dir)),
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
    """The host's time by op over one eager transition (torch.profiler, CPU
    activity only): the eight ops of largest self time."""
    gen = torch.Generator(device=DEVICE).manual_seed(DIST_SEED)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        rt.parallel.run(kernel, gen, None, num_samples=1, init_state=state, collect=False, mesh=mesh, capture=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {"s_per_transition_profiled": wall,
            "top_self_cpu": [{"op": e.key, "calls": e.count, "self_us": e.self_cpu_time_total} for e in rows]}


def phase_distributed(smi: str) -> dict:
    """Phase 11: the parallel layer: world 1 over NCCL in this process, then
    two ranks sharing the card over Gloo; captured wherever declared."""
    from riemannhamiltonianmontecarlo_tpu_torch import step_profile

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
        # BLR RMHMC at full width: a ("chains", "data") mesh of shape (1, 1), captured (its all-reduces are
        # NCCL's), against the same run eager and the captured run without a mesh.
        mesh = rt.parallel.make_mesh(1, (CHAIN_AXIS, "data"), (1, 1))
        burn, samples = DIST_BLR_RUN
        plain_kernel, world1_kernel = rmhmc.build(model), rmhmc.build(model.with_sharding(mesh))
        check(world1_kernel.capturable, "distributed: the model sharded over NCCL does not declare itself capturable")
        with step_profile.parent_routes():  # the sharded model's route: the loops, K2 (not K4 / K5)
            plain = dist_run(plain_kernel, init, None, burn, samples)
        world1 = dist_run(world1_kernel, init, mesh, burn, samples)
        world1_eager = dist_run(world1_kernel, init, mesh, burn, samples, capture=False)
        same, same_eager = same_run(plain, world1), same_run(world1_eager, world1)
        check(all(same.values()), f"distributed: world 1 captured differs from the run without a mesh: {same}")
        check(all(same_eager.values()), f"distributed: world 1 captured differs from world 1 eager: {same_eager}")
        expected = blr_expected_launches(burn + samples, loops=True)
        for run in (plain, world1, world1_eager):
            check(run["launches"] == expected, f"distributed: launch counts {run['launches']}, expected {expected}")
        captures = {"no_mesh": (plain["captures"], plain["timed_captures"]),
                    "world1": (world1["captures"], world1["timed_captures"]),
                    "world1_eager": (world1_eager["captures"], world1_eager["timed_captures"])}
        check(captures == {"no_mesh": (1, 0), "world1": (1, 0), "world1_eager": (0, 0)},
              f"distributed: (captures in the burn-in, in the timed run) {captures}")
        check(world1["all_reduce"] == world1_eager["all_reduce"] == world1_eager["all_reduce_issued"] > 0,
              f"distributed: all-reduces counted captured {world1['all_reduce']}, eager {world1_eager['all_reduce']}, "
              f"issued eager {world1_eager['all_reduce_issued']}")
        replayed = replay_all_reduces(world1_kernel, world1["state"], mesh.group("data"))
        check(replayed["equal"], f"distributed: the step's all-reduces replayed {replayed}")
        launches_by_path["distributed/world1-blr"] = world1["launches"]
        steps = burn + samples
        say("distributed", run="world1-blr", backend="nccl", mesh={CHAIN_AXIS: 1, "data": 1}, chains=NUM_CHAINS,
            burn_in=burn, samples=samples, captured=True, bit_identical_to_no_mesh=same,
            bit_identical_to_eager=same_eager, captures=captures, launches=world1["launches"],
            all_reduce_counted=world1["all_reduce"], all_reduce_issued_captured=world1["all_reduce_issued"],
            all_reduce_replays=replayed, accept_rate=float(world1["accept"]), divergent=int(world1["div"]))
        say("distributed-times", run="world1-blr", card=smi, captured_s_per_transition=world1["seconds"] / samples,
            eager_s_per_transition=world1_eager["seconds"] / samples,
            no_mesh_captured_s_per_transition=plain["seconds"] / samples,
            all_reduce_per_transition=world1["all_reduce"] / steps,
            in_step_all_reduce_per_transition=replayed["issued_per_eager_step"],
            no_mesh_all_reduce=plain["all_reduce"])
        # Where the host's time goes in the eager step with and without the mesh (what the all-reduces cost).
        say("distributed-host-profile", run="world1-blr", card=smi, path="eager",
            world1=host_profile(world1_kernel, world1["state"], mesh), no_mesh=host_profile(plain_kernel, plain["state"], None),
            no_mesh_route="K4 / K5")

        # LGC phmc at D = 4096: the operators' rows over a ("chains", "latent") mesh of shape (1, 1).
        y, _ = rt.models.lgc.generate_data(seed=LGC_SEED, n=LGC_N)
        lgc_model = rt.interop.lgc_from_numpy(y, LGC_N, device=DEVICE)
        latent = rt.parallel.make_mesh(1, (CHAIN_AXIS, "latent"), (1, 1))
        sharded = lgc_model.with_sharding(latent)
        cfg = rt.samplers.phmc.PHMCConfig(step_size=0.1, num_leapfrog=30)  # the lgc "rmhmc" preset
        lgc_init = lgc_model.prior_mean().expand(DIST_LGC_CHAINS, -1).clone()
        burn, samples = DIST_LGC_RUN
        lgc_kernel = rt.samplers.phmc.build(sharded, sharded.metric_chol, sharded.metric_inv, cfg)
        check(lgc_kernel.capturable, "distributed: LGC sharded over NCCL does not declare itself capturable")
        lgc_plain = dist_run(rt.samplers.phmc.build(lgc_model, lgc_model.metric_chol, lgc_model.metric_inv, cfg),
                             lgc_init, None, burn, samples)
        lgc_world1 = dist_run(lgc_kernel, lgc_init, latent, burn, samples)
        lgc_eager = dist_run(lgc_kernel, lgc_init, latent, burn, samples, capture=False)
        same, same_eager = same_run(lgc_plain, lgc_world1), same_run(lgc_eager, lgc_world1)
        check(all(same.values()), f"distributed: LGC world 1 captured differs from the run without a mesh: {same}")
        check(all(same_eager.values()), f"distributed: LGC world 1 captured differs from eager: {same_eager}")
        check(lgc_world1["launches"] == NO_LINALG, "distributed: a kernel launched at D=4096")
        check(float(lgc_world1["accept"]) > 0.5, f"distributed: LGC acceptance {float(lgc_world1['accept'])}")
        captures = {"world1": (lgc_world1["captures"], lgc_world1["timed_captures"]),
                    "world1_eager": (lgc_eager["captures"], lgc_eager["timed_captures"])}
        check(captures == {"world1": (1, 0), "world1_eager": (0, 0)}, f"distributed: LGC captures {captures}")
        check(lgc_world1["all_reduce"] == lgc_eager["all_reduce"] == lgc_eager["all_reduce_issued"] > 0,
              f"distributed: LGC all-reduces counted captured {lgc_world1['all_reduce']}, eager "
              f"{lgc_eager['all_reduce']}, issued eager {lgc_eager['all_reduce_issued']}")
        replayed = replay_all_reduces(lgc_kernel, lgc_world1["state"], latent.group("latent"))
        check(replayed["equal"], f"distributed: the LGC step's all-reduces replayed {replayed}")
        say("distributed", run="world1-lgc-phmc", backend="nccl", mesh={CHAIN_AXIS: 1, "latent": 1},
            D=LGC_N * LGC_N, chains=DIST_LGC_CHAINS, burn_in=burn, samples=samples, captured=True,
            bit_identical_to_no_mesh=same, bit_identical_to_eager=same_eager, captures=captures,
            all_reduce_counted=lgc_world1["all_reduce"], all_reduce_replays=replayed,
            accept_rate=float(lgc_world1["accept"]), divergent=int(lgc_world1["div"]))
        say("distributed-times", run="world1-lgc-phmc", card=smi,
            captured_s_per_transition=lgc_world1["seconds"] / samples,
            eager_s_per_transition=lgc_eager["seconds"] / samples,
            no_mesh_captured_s_per_transition=lgc_plain["seconds"] / samples,
            all_reduce_per_transition=lgc_world1["all_reduce"] / (burn + samples),
            in_step_all_reduce_per_transition=replayed["issued_per_eager_step"])

        # run_checkpointed with the mesh, captured: stopped after one segment and resumed, bit for bit the run not
        # stopped and the eager one; one capture for all three captured runs; no .p suffix at world 1.
        kernel = rmhmc.build(model.with_sharding(mesh))
        kw = dict(mesh=mesh, **DIST_CKPT)
        captures = rt.parallel.graphs.capture_count()
        full = rt.parallel.run_checkpointed(kernel, DIST_SEED, init, checkpoint_path=DIST_DIR / "full.npz", **kw)
        rt.parallel.run_checkpointed(kernel, DIST_SEED, init, checkpoint_path=DIST_DIR / "cut.npz",
                                     _stop_after_segments=1, **kw)
        resumed = rt.parallel.run_checkpointed(kernel, DIST_SEED, init, checkpoint_path=DIST_DIR / "cut.npz", **kw)
        captures = rt.parallel.graphs.capture_count() - captures
        eager = rt.parallel.run_checkpointed(kernel, DIST_SEED, init, checkpoint_path=DIST_DIR / "eager.npz",
                                             capture=False, **kw)
        same = {"samples": torch.equal(full.samples, resumed.samples),
                "position": torch.equal(full.final_state.position, resumed.final_state.position),
                "eager_samples": torch.equal(full.samples, eager.samples),
                "eager_position": torch.equal(full.final_state.position, eager.final_state.position)}
        check(all(same.values()), f"distributed: the resumed or eager run differs from the run not stopped: {same}")
        check(captures == 1, f"distributed: the checkpointed runs captured {captures} graphs, expected one")
        files = sorted(f.name for f in DIST_DIR.iterdir())
        check("cut.npz" in files and not any(".p" in f for f in files), f"distributed: checkpoint files {files}")
        say("distributed", run="world1-resume", **DIST_CKPT, captured=True, captures=captures,
            stopped_after_segments=1, bit_identical=same, files=files)

        # The pooled adaptive kernel through the experiment entry point, captured against eager.
        kw = dict(device=DEVICE, adapt=True, keep_samples=True, ess_mode="exact", mesh=mesh, **DIST_ADAPT_RUN)
        captures = rt.parallel.graphs.capture_count()
        adapted = experiments.run_experiment("rmhmc", "australian", **kw)
        captures = rt.parallel.graphs.capture_count() - captures
        with unittest.mock.patch.object(rt.parallel.graphs, "wants_capture", lambda kernel, device, capture: False):
            adapted_eager = experiments.run_experiment("rmhmc", "australian", **kw)
        same = {"samples": np.array_equal(adapted.samples, adapted_eager.samples),
                "step_size": adapted.adapted_step_size == adapted_eager.adapted_step_size,
                "accept": adapted.accept_rate == adapted_eager.accept_rate}
        check(all(same.values()), f"distributed: adaptive run_experiment captured differs from eager: {same}")
        check(captures == 2, f"distributed: adaptive run_experiment captured {captures} graphs, expected two "
                             "(the pooled adaptive kernel's and the frozen kernel's)")
        say("distributed", run="world1-adaptive-experiment", **DIST_ADAPT_RUN, captured=True, captures=captures,
            bit_identical_to_eager=same, adapted_step_size=adapted.adapted_step_size, accept_rate=adapted.accept_rate)

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
    # the chain split on the whole model (K4 / K5), the row split on the sharded one (the loops, K2)
    expected_by = {"chains": blr_expected_launches(burn + samples), "data": blr_expected_launches(burn + samples, True)}
    fields = {}
    for r in (r0, r1):  # the chain split captured, bit for bit eager; the row split eager, capture=True refused
        check(bool(r["chains_capturable"]) and bool(r["chains_eager_equal"]) and list(r["chains_captures"]) == [1, 0, 0],
              f"chain split: capturable {r['chains_capturable']}, equal to eager {r['chains_eager_equal']}, "
              f"captures (burn-in, timed, eager) {r['chains_captures']}")
        refused = str(r["data_refused"])
        check(not bool(r["data_capturable"]) and list(r["data_captures"]) == [0, 0]
              and "gloo" in refused and "over NCCL only" in refused,
              f"row split over Gloo: capturable {r['data_capturable']}, captures {r['data_captures']}, "
              f"capture=True gave {refused!r}")
    for label in ("chains", "data"):
        expected = expected_by[label]
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
        chain_split_captured=True, chain_split_bit_identical_to_eager=True, row_split_captured=False,
        row_split_capture_true_refused=str(r0["data_refused"]),
        boundary_margin=DIST_MARGIN, launches_per_rank=expected_by, checkpoint_shards=shards,
        **{f"split_{label}": {k: v for k, v in f.items() if k != "s_per_transition"} for label, f in fields.items()})
    say("distributed-times", run="2rank-gloo-blr", card=smi, launch_s=launch_s,
        **{f"split_{label}_s_per_transition": f["s_per_transition"] for label, f in fields.items()},
        split_chains_eager_s_per_transition=[float(r["chains_eager_s_per_transition"]) for r in (r0, r1)])

    # The four samplers the chain split took last: each rank bit for bit one
    # process running its half, with no exit test agreed over the ranks, both
    # against one process running all chains.
    burn, samples = DIST_SPLIT_RUN
    with torch.inference_mode():
        for label, (kernel, init, expected) in split_runs(model).items():
            for r in (r0, r1):
                got = {k: int(r[f"{label}_{k}"]) for k in expected}
                check(got == expected, f"distributed 2-rank {label}: launch counts {got} on a rank, expected {expected}")
                check(float(r[f"{label}_accept"]) == float(r0[f"{label}_accept"]), f"{label}: the ranks' acceptance differs")
                check(int(r[f"{label}_min_all_reduces"]) == 0, f"{label}: a rank agreed an exit test over the ranks")
                check(bool(r[f"{label}_capturable"]) and bool(r[f"{label}_eager_equal"])
                      and list(r[f"{label}_captures"]) == [1, 0, 0],
                      f"{label}: capturable {r[f'{label}_capturable']}, captured equal to eager "
                      f"{r[f'{label}_eager_equal']}, captures (burn-in, timed, eager) {r[f'{label}_captures']}")
            halves = [dist_run(kernel, init, local_mesh(i, 2), burn, samples)["samples"].cpu().numpy() for i in range(2)]
            same = all(np.array_equal(r[f"{label}_samples"], h) for r, h in zip((r0, r1), halves))
            check(same, f"{label}: a rank differs from one process running its half of the chains")
            whole = dist_run(with_discontinuity_probe(kernel), init, None, burn, samples)
            ref = {"samples": whole["samples"].cpu().numpy(), "near": whole["state"].near.cpu().numpy()}
            got = np.concatenate([r0[f"{label}_samples"], r1[f"{label}_samples"]])
            check(np.isfinite(got).all(), f"{label}: non-finite samples")
            split = compare_to_one_process(f"2-rank {label}", got, None, ref, DIST_SPLIT_TOL.get(label, DIST_TOL))
            launches_by_path[f"distributed/2rank-{label}-per-rank"] = expected
            say("distributed", run=f"2rank-gloo-{label}", backend="gloo", chains=int(init.shape[0]), burn_in=burn,
                samples=samples, captured=True, bit_identical_to_eager=True,
                bit_identical_to_one_process_by_half=same, launches_per_rank=expected,
                min_all_reduces_per_rank=int(r0[f"{label}_min_all_reduces"]), accept_rate=float(r0[f"{label}_accept"]),
                one_process_accept_rate=float(whole["accept"]), divergent=int(r0[f"{label}_div"]),
                probe={"scale_random_sign": PROBE_SCALE, "jump": PROBE_JUMP}, split_chains=split)
            say("distributed-times", run=f"2rank-gloo-{label}", card=smi,
                s_per_transition=[float(r[f"{label}_s_per_transition"]) for r in (r0, r1)],
                eager_s_per_transition=[float(r[f"{label}_eager_s_per_transition"]) for r in (r0, r1)])
    return launches_by_path


# -- phase 12: the results tools at smoke depth ------------------------------------

TOOLS_BLR = BlrRun("rmhmc", chains=256, burn_in=50, samples=50)  # make_results' rows: rmhmc, gibbs
TOOLS_SV = dict(chains=64, samples=20, burn_in=20)  # make_results_all's StochVol rmhmc row
TOOLS_ESS = BlrRun("rmhmc", dataset="german", chains=256, burn_in=50, samples=50)  # ess_engine_bench
TOOLS_PROBE = dict(chains=(64, 256), steps=2)  # probe_scaling fhn (HMC, L 150 on the FHN kernel)
TOOLS_SCALING = dict(ranks=(1, 2), chains_per_rank=64, samples=5, burn_in=5)
RESULTS_MD = Path(__file__).resolve().parent / "RESULTS.md"
NUMBER = re.compile(r"-?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?")


def table_rows(section: str) -> list[list[str]]:
    """The cells of every table row of a section (header rows left out)."""
    lines = section.splitlines()
    heads = {i - 1 for i, line in enumerate(lines) if line.startswith("|---")}
    return [[c.strip() for c in line.strip().strip("|").split("|")]
            for i, line in enumerate(lines) if line.startswith("| ") and i not in heads]


def check_section(label: str, section: str, smi: str, n_rows: int) -> list[list[str]]:
    """A results tool's section: headed with the card, ``n_rows`` table rows whose
    every cell after the first holds finite numbers."""
    check(smi in section.splitlines()[0], f"{label}: the section is not headed with the card: {section.splitlines()[0]}")
    rows = table_rows(section)
    check(len(rows) == n_rows, f"{label}: {len(rows)} table rows, expected {n_rows}")
    for row in rows:
        numbers = [float(x) for cell in row[1:] for x in NUMBER.findall(cell.replace(",", ""))]
        bad = any(w in cell.lower() for cell in row for w in ("nan", "inf", "failed"))
        check(numbers and not bad and np.isfinite(numbers).all(), f"{label}: a row with other than finite numbers: {row}")
    return rows


def phase_tools(smi: str) -> dict:
    """Phase 12: each results tool's run function at smoke depth, through
    the kernels where its rows run them; RESULTS.md untouched."""
    from riemannhamiltonianmontecarlo_tpu_torch.tools import (
        ess_engine_bench,
        make_results,
        make_results_all,
        probe_scaling,
        scaling_table,
    )

    digest = hashlib.sha256(RESULTS_MD.read_bytes()).hexdigest()
    write_smoke_csvs()
    launches_by_path, seconds, accepts = {}, {}, {}

    def timed(name: str, fn):
        reset_blr_launches()
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out, blr_launches()

    main_accept = SEEN_ACCEPT.get("rmhmc-main-path")
    for sampler in ("rmhmc", "gibbs"):
        run = dataclasses.replace(TOOLS_BLR, sampler=sampler)
        section, launches = timed(f"make_results-{sampler}", lambda: make_results.run_dataset(
            "australian", device=DEVICE, chains=run.chains, samples=run.samples, burn_in=run.burn_in,
            samplers=(sampler,)))
        check(launches == run.expected_launches(),
              f"tools/make_results {sampler}: launch counts {launches}, expected {run.expected_launches()}")
        launches_by_path[f"tools/make_results-{sampler}"] = launches
        (row,) = check_section(f"make_results {sampler}", section, smi, 1)
        check(row[:3] == [sampler, str(run.chains), str(run.samples)], f"make_results {sampler}: row {row}")
        accepts[sampler] = float(row[3])
    if main_accept is None:
        check(ACCEPT_WINDOW[0] <= accepts["rmhmc"] <= ACCEPT_WINDOW[1], f"make_results rmhmc: acceptance {accepts}")
    else:
        check(abs(accepts["rmhmc"] - main_accept) <= ACCEPT_TOL,
              f"make_results rmhmc: acceptance {accepts['rmhmc']} vs phase 5's {main_accept} +- {ACCEPT_TOL}")
    check(accepts["gibbs"] == 1.0, f"make_results gibbs: acceptance {accepts['gibbs']}")

    sv_ref = SEEN_ACCEPT.get("stochvol/rmhmc", SV_JAX["rmhmc"]["accept"])
    ((got, expected_rows), section), launches = timed("make_results_all-stochvol-rmhmc", lambda: (
        make_results_all.run_stochvol(1, device=DEVICE, samplers=("rmhmc",), keep="host", **TOOLS_SV)))
    sweeps = TOOLS_SV["burn_in"] + 2 * (TOOLS_SV["samples"] // 2)
    check(launches == sv_expected_launches("rmhmc", sweeps),
          f"tools/stochvol rmhmc: launch counts {launches}, expected {sv_expected_launches('rmhmc', sweeps)}")
    launches_by_path["tools/make_results_all-stochvol-rmhmc-host"] = launches
    rows = check_section("make_results_all stochvol", section, smi, 2)
    check((got, expected_rows) == (2, 8), f"make_results_all stochvol: {got}/{expected_rows} rows recorded")
    accepts["stochvol-rmhmc"] = float(rows[0][3])
    check(abs(accepts["stochvol-rmhmc"] - sv_ref) <= ACCEPT_TOL,
          f"make_results_all stochvol rmhmc: acceptance {accepts['stochvol-rmhmc']} vs {sv_ref} +- {ACCEPT_TOL}")

    section, launches = timed("ess_engine_bench", lambda: ess_engine_bench.run_bench(
        TOOLS_ESS.dataset, device=DEVICE, chains=TOOLS_ESS.chains, samples=TOOLS_ESS.samples,
        burn_in=TOOLS_ESS.burn_in))
    check(launches == TOOLS_ESS.expected_launches(),
          f"tools/ess_engine_bench: launch counts {launches}, expected {TOOLS_ESS.expected_launches()}")
    launches_by_path["tools/ess_engine_bench-rmhmc"] = launches
    check_section("ess_engine_bench", section, smi, 2)

    section, _ = timed("probe_scaling-fhn", lambda: probe_scaling.run_probe("fhn", device=DEVICE, **TOOLS_PROBE))
    check_section("probe_scaling", section, smi, len(TOOLS_PROBE["chains"]))
    section, _ = timed("scaling_table", lambda: scaling_table.run_scaling(device=DEVICE, **TOOLS_SCALING))
    rows = check_section("scaling_table", section, smi, len(TOOLS_SCALING["ranks"]))
    for row in rows:  # every world size's ranks replay their chain-split step's graph
        check(row[2].startswith("captured"), f"scaling_table: the ranks' step ran {row[2]}")
        check(abs(float(row[5]) - accepts["rmhmc"]) <= 0.1, f"scaling_table: acceptance {row[5]}")
    check(hashlib.sha256(RESULTS_MD.read_bytes()).hexdigest() == digest, "a results tool changed RESULTS.md")
    say("tools", accept_rates=accepts, main_path_accept=main_accept, stochvol_accept_ref=sv_ref,
        accept_tol=ACCEPT_TOL, launches=launches_by_path, results_md_unchanged=True)
    say("tools-times", card=smi, seconds=seconds)
    return launches_by_path


# -- phase 13: the runner's CUDA graphs ----------------------------------------------

GRAPH_SEED = 31
GRAPH_RUN = (20, 20)  # BLR RMHMC at the main path's width, eager against captured: (burn-in, samples)
GRAPH_SMALL_RUN = (3, 3)  # every other capturable sampler, eager against captured, at its phase's width
GRAPH_NOISE_STEPS = 8  # draw_noise alone: replays against eager calls
GRAPH_CKPT = dict(num_samples=6, burn_in=2, checkpoint_every=2)  # three segments, stopped after one
GRAPH_TIMED = dict(burn_in=4, num_samples=8)  # timed_sampling: its timed half captures nothing
# The walls and idle shares of PERF.md section 5, eager (E) and captured (C) in turns E C C E:
# (workload, sampler, chains); step_profile.profile_run at these depths.
# StochVol's and the joint pair's rows are step_profile's own (its main): profiling their eager
# sweeps (30,000-65,000 launches each) took most of ten minutes, too long for this script.
GRAPH_PROFILES = (("blr", "rmhmc", NUM_CHAINS), ("blr", "gibbs", 1024), ("fhn", "rmhmc", 256), ("fhn", "hmc", 256),
                  ("lgc", "rmhmc", 64))
GRAPH_PROFILE_DEPTH = dict(warm=3, steps=10, profiled=3)
GRAPH_MONITOR = dict(every=2, label="smoke-monitor")  # BLR HMC at 4096 chains, GRAPH_SMALL_RUN, eager against captured
GRAPH_GIBBS_CHAINS = 1024  # phase 6's Gibbs width
GRAPH_TOOL = dict(burn_in=2, num_samples=4, seg=2)  # tools/run_lgc_joint's segmented run, n = 32, 4 chains
INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns: a NaN equals a NaN of the same bits."""
    return x.contiguous().view(INT_OF[x.dtype]) if x.dtype in INT_OF else x


def differing_leaves(a, b) -> list[int]:
    """Indices of the leaves of two trees that are not equal bit for bit."""
    la, lb = [], []
    rt.samplers.base.tree_map(la.append, a)
    rt.samplers.base.tree_map(lb.append, b)
    check(len(la) == len(lb), f"trees of {len(la)} and {len(lb)} leaves")
    return [i for i, (x, y) in enumerate(zip(la, lb)) if x.dtype != y.dtype or not torch.equal(bits(x), bits(y))]


def run_differences(eager, captured) -> dict:
    """What differs between two RunResults (empty: bit for bit the same)."""
    out = {}
    for field in ("samples", "final_state", "accept_rate", "divergences", "warmup_accept_rate"):
        leaves = differing_leaves(getattr(eager, field), getattr(captured, field))
        if leaves:
            out[field] = leaves
    return out


class NoiseState(NamedTuple):
    """RMHMC's five draws of one step, the first under the name the runner reads."""

    position: torch.Tensor
    chi_normal: torch.Tensor
    u_len: torch.Tensor
    u_dir: torch.Tensor
    u_acc: torch.Tensor


def noise_step(gen, state):
    noise = NoiseState(*rmhmc.draw_noise(gen, state.position))
    c = state.position.shape[0]
    no = torch.zeros((c,), dtype=torch.bool, device=state.position.device)
    return noise, rt.samplers.base.Info(noise.u_acc, no, no)


def check_graph_noise(init: torch.Tensor) -> dict:
    """The first check on the card: RMHMC's draw_noise alone, replayed
    GRAPH_NOISE_STEPS times against as many eager calls from one seed."""
    state = NoiseState(init, *(init[:, 0] for _ in range(4)))
    fn = tuple  # every draw is collected
    eager = rt.parallel.runner._scan_phase(noise_step, torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED), state,
                                           GRAPH_NOISE_STEPS, True, fn)
    entry = rt.parallel.graphs.StepGraph(noise_step, fn, state)
    entry.capture()
    captured = entry.scan(torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED), state, GRAPH_NOISE_STEPS, True)
    first = None
    for step in range(GRAPH_NOISE_STEPS):
        for k, name in enumerate(NoiseState._fields):
            if first is None and not torch.equal(bits(eager[1][k][step]), bits(captured[1][k][step])):
                first = {"step": step, "draw": name}
    return {"steps": GRAPH_NOISE_STEPS, "equal": first is None, "first_difference": first}


def graph_pair(label: str, kernel, init, burn: int, samples: int, warmup_kernel=None) -> dict:
    """One run eager and one captured from the same seed, their launch counts
    and what differs; one eager step first under the sync debug mode."""
    gen = torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED)
    state = (warmup_kernel or kernel).init(init)
    torch.cuda.synchronize()
    sync = {}
    for name, k in (("warmup_kernel", warmup_kernel), ("kernel", kernel)):
        if k is None:
            continue
        torch.cuda.set_sync_debug_mode("error")
        try:
            k.step(gen, state)
        except RuntimeError as err:  # a host sync inside the step: the capture would refuse it
            sync[name] = str(err).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    out, counts = {}, {}
    for path, capture in (("eager", False), ("captured", True)):
        rt.ops.launches.reset()
        captures = rt.parallel.graphs.capture_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[path] = rt.parallel.run(kernel, torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED), init,
                                    num_samples=samples, burn_in=burn, warmup_kernel=warmup_kernel, capture=capture)
        torch.cuda.synchronize()
        counts[path] = {"seconds": time.perf_counter() - t0, "k1_k2": blr_launches(),
                        "fhn": rt.ops.fhn_sens.launch_counts(),
                        "captures": rt.parallel.graphs.capture_count() - captures}
    # The entries the captured run made (looked up: a miss captures nothing, and fails the pair).
    entries = [rt.parallel.graphs.lookup(k.step, None, state)
               for k in dict.fromkeys([warmup_kernel or kernel, kernel]) if burn or k is kernel]
    check(all(e is not None for e in entries), f"{label}: the captured run left no graph of a step")
    return {
        "run": label, "burn_in": burn, "samples": samples, "host_sync_in_step": sync or None,
        "differs": run_differences(out["eager"], out["captured"]),
        "launches_equal": counts["eager"]["k1_k2"] == counts["captured"]["k1_k2"]
        and counts["eager"]["fhn"] == counts["captured"]["fhn"],
        "eager": counts["eager"], "captured": counts["captured"],
        "capture_s": [e.capture_s for e in entries], "graph_pool_bytes": [e.pool_bytes for e in entries],
        "accept_rate": float(out["captured"].accept_rate), "result": out,
    }


def graph_small_runs() -> list[tuple]:
    """(label, kernel, init, warmup_kernel, expected K1 / K2 / K3 launches or None)
    of every capturable sampler but the main path's."""
    model = blr_model()
    init = rt.utils.default_init(model, torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED), NUM_CHAINS)
    runs = []
    for sampler in ("rmhmc_studentt", "hmc", "mala", "mmala", "mmala_simplified", "metropolis", "iwls"):
        kernel, warm = experiments.build_kernel(sampler, model, "australian")
        runs.append((f"blr/{sampler}", kernel, init, warm, None))
    cfg = rmhmc.RMHMCConfig()
    runs.append(("blr/rmhmc-adapt", rt.parallel.adaptive(rmhmc.build, model, cfg), init, None, None))
    gibbs_run = BlrRun("gibbs", burn_in=sum(GRAPH_SMALL_RUN), samples=0)  # its launches over the run's steps
    runs.append((f"blr/gibbs-{GRAPH_GIBBS_CHAINS}", experiments.build_kernel("gibbs", model, "australian")[0],
                 init[:GRAPH_GIBBS_CHAINS].clone(), None, gibbs_run.expected_launches()))
    for sampler, chains, _, _ in LGC_RUNS:
        kernel, init_fn, *_ = experiments.build_workload("lgc", sampler, device=DEVICE, seed=LGC_SEED, lgc_n=LGC_N)
        runs.append((f"lgc/{sampler}", kernel, init_fn(chains), None, None))
    y, _ = rt.models.lgc.generate_data(seed=LGC_SEED, n=LGC_N)
    lgc = rt.interop.lgc_from_numpy(y, LGC_N, device=DEVICE)
    runs.append(("lgc/pmala", pmala.build(lgc, lgc.metric_chol, lgc.metric_inv), lgc.prior_mean().expand(64, -1).clone(),
                 None, None))
    for sampler in FHN_RUNS:
        kernel, init_fn, *_ = experiments.build_workload("fhn", sampler, device=DEVICE, seed=FHN_SEED,
                                                         fhn_obs=FHN_OBS, fhn_substeps=FHN_SUBSTEPS)
        runs.append((f"fhn/{sampler}", kernel, init_fn(FHN_CHAINS), None, None))
    sweeps = sum(GRAPH_SMALL_RUN)
    # StochVol at phase 7's width (MALA with its transient burn-in kernel) and the joint pair at phase 9's n = 32.
    for method in SV_RUNS:
        kernel, init_fn, _, _, warm = experiments.build_workload("stochvol", method, device=DEVICE, seed=SV_SEED,
                                                                 stochvol_obs=SV_OBS)
        runs.append((f"stochvol/{method}", kernel, init_fn(SV_CHAINS), warm, sv_expected_launches(method, sweeps)))
    for sampler in LGCJ_JAX:
        kernel, init_fn, *_ = experiments.build_workload("lgc", sampler, device=DEVICE, seed=LGCJ_SEED,
                                                         lgc_n=LGCJ_SMALL_N)
        runs.append((f"lgc/{sampler}-n{LGCJ_SMALL_N}", kernel, init_fn(LGCJ_SMALL_CHAINS), None,
                     lgcj_expected_launches(sampler, sweeps)))
    return runs


def graph_monitor(model, init, sampler: str) -> dict:
    """A monitored BLR ``sampler`` eager and captured from one seed: the same
    window lines (printed by the host after the replays), the same chains."""
    kernel = rt.parallel.monitor(experiments.build_kernel(sampler, model, "australian")[0], **GRAPH_MONITOR)
    out, lines, captures = {}, {}, {}
    for path, capture in (("eager", False), ("captured", True)):
        buf, before = io.StringIO(), rt.parallel.graphs.capture_count()
        with contextlib.redirect_stdout(buf):
            out[path] = rt.parallel.run(kernel, torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED), init,
                                        num_samples=GRAPH_SMALL_RUN[1], burn_in=GRAPH_SMALL_RUN[0], capture=capture)
        lines[path] = buf.getvalue().splitlines()
        captures[path] = rt.parallel.graphs.capture_count() - before
    expected = [f"[{GRAPH_MONITOR['label']}] step {s}" for s in range(GRAPH_MONITOR["every"], sum(GRAPH_SMALL_RUN) + 1,
                                                                       GRAPH_MONITOR["every"])]
    return {"run": f"blr/{sampler}-monitor", "chains": int(init.shape[0]), "capturable": kernel.capturable,
            "lines": lines, "captures": captures,
            "windows_expected": [line.split(":")[0] for line in lines["eager"]] == expected,
            "same_lines": lines["eager"] == lines["captured"],
            "differs": run_differences(out["eager"], out["captured"])}


def graph_lgc_joint_tool() -> dict:
    """tools/run_lgc_joint's segmented run, captured by default on the card:
    stopped after one segment and resumed, against the run not stopped."""
    from riemannhamiltonianmontecarlo_tpu_torch.tools import run_lgc_joint

    ckpt_dir = SMOKE_DATA.parent / "smoke_graph_tool"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    model = rt.interop.lgc_joint_from_numpy(rt.models.lgc.generate_data(seed=LGCJ_SEED, n=LGCJ_SMALL_N)[0],
                                            LGCJ_SMALL_N, device=DEVICE)
    kernel = rt.samplers.lgc_joint.build(model)
    init = torch.tensor([model.init_sigma_sq, model.init_beta], device=DEVICE).expand(LGCJ_CHAINS, -1).clone()
    kw = dict(seed=GRAPH_SEED, ckpt_dir=ckpt_dir, **GRAPH_TOOL)
    before = rt.parallel.graphs.capture_count()
    with contextlib.redirect_stdout(io.StringIO()):
        whole = run_lgc_joint.run_segmented(kernel, init, tag="whole", **kw)
        captures = rt.parallel.graphs.capture_count() - before
        stopped = run_lgc_joint.run_segmented(kernel, init, tag="cut", _stop_after_segments=1, **kw)
        resumed = run_lgc_joint.run_segmented(kernel, init, tag="cut", **kw)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    same = {name: bool(np.array_equal(a, b)) for name, a, b in (("theta", whole[0], resumed[0]),
                                                               ("x", whole[1], resumed[1]))}
    return {"run": f"tools/run_lgc_joint-rmhmc-n{LGCJ_SMALL_N}", "chains": LGCJ_CHAINS, **GRAPH_TOOL,
            "captures": captures, "stopped_returned": stopped, "bit_identical": same,
            "accept": [whole[2], resumed[2]], "divergences": [whole[3], resumed[3]]}


def phase_graphs(smi: str) -> dict:
    """Eager against captured on the card, launch counts, what stays eager, and the walls."""
    from riemannhamiltonianmontecarlo_tpu_torch import step_profile

    failures = []
    model = blr_model()
    init = rt.utils.default_init(model, torch.Generator(device=DEVICE).manual_seed(GRAPH_SEED), NUM_CHAINS)
    noise = check_graph_noise(init)
    say("graphs-noise", **noise)
    if not noise["equal"]:
        failures.append(f"draw_noise: {noise['first_difference']}")

    # The main path's configuration: K1 / K2 / K3 counts exact on the captured run.
    burn, samples = GRAPH_RUN
    main_kernel = rmhmc.build(model)
    try:
        main = graph_pair("blr/rmhmc", main_kernel, init, burn, samples)
        main["replays_under_profiler"] = replay_launches(main_kernel, main["result"]["captured"].final_state)
    except Exception as err:  # noqa: BLE001 -- the other samplers are still tried; the phase fails below
        failures.append(f"blr/rmhmc: {type(err).__name__}: {err}")
        say("graphs", run="blr/rmhmc", error=failures[-1])
        main = {"captured": {"k1_k2": None, "captures": 1}, "differs": {}, "replays_under_profiler": {"equal": True}}
    if not main["replays_under_profiler"]["equal"]:
        failures.append(f"blr/rmhmc: the counters and torch.profiler's device events differ: "
                        f"{main['replays_under_profiler']}")
    expected = blr_expected_launches(burn + samples)
    if main["captured"]["k1_k2"] != expected:
        failures.append(f"blr/rmhmc: captured launch counts {main['captured']['k1_k2']}, expected {expected}")
    if main["differs"]:
        failures.append(f"blr/rmhmc: eager and captured differ in {main['differs']}")
    if main["captured"]["captures"] != 1:
        failures.append(f"blr/rmhmc: {main['captured']['captures']} captures, expected one for both phases")
    if "run" in main:
        say("graphs", **{k: v for k, v in main.items() if k != "result"})
    launches_by_path = {"graphs/blr-rmhmc-captured": main["captured"]["k1_k2"]}

    for label, kernel, run_init, warm, expected in graph_small_runs():
        check(kernel.capturable, f"{label}: the kernel does not declare itself capturable")
        try:
            pair = graph_pair(label, kernel, run_init, *GRAPH_SMALL_RUN, warmup_kernel=warm)
            if any(pair["captured"]["k1_k2"].values()) or any(pair["captured"]["fhn"].values()):
                pair["replays_under_profiler"] = replay_launches(kernel, pair["result"]["captured"].final_state)
        except Exception as err:  # noqa: BLE001 -- every sampler is tried; the phase fails below, naming each
            failures.append(f"{label}: {type(err).__name__}: {str(err).splitlines()[0] if str(err) else ''}")
            say("graphs", run=label, error=failures[-1])
            continue
        replays = pair.get("replays_under_profiler", {"equal": True, "counted": {"any": 1}})
        # one capture per kernel of the run: the sampling kernel's, and the burn-in kernel's where it has its own
        pair["captures_expected"] = len({id(k) for k in (warm or kernel, kernel)})
        pair["k1_k2_expected"] = expected
        if (pair["differs"] or not pair["launches_equal"] or pair["host_sync_in_step"] or not replays["equal"]
                or not any(replays["counted"].values()) or pair["captured"]["captures"] != pair["captures_expected"]
                or (expected is not None and pair["captured"]["k1_k2"] != expected)):
            failures.append(f"{label}: differs {pair['differs']}, launches equal {pair['launches_equal']}, "
                            f"host sync {pair['host_sync_in_step']}, replays under the profiler {replays}, "
                            f"captures {pair['captured']['captures']} of {pair['captures_expected']}, "
                            f"K1 / K2 / K3 {pair['captured']['k1_k2']} against {expected}")
        if expected is not None:
            launches_by_path[f"graphs/{label}-captured"] = pair["captured"]["k1_k2"]
        say("graphs", **{k: v for k, v in pair.items() if k != "result"})

    # The monitor over a capturable kernel: the same window lines and chains eager and captured.
    for sampler, chains in (("hmc", NUM_CHAINS), ("gibbs", GRAPH_GIBBS_CHAINS)):
        try:
            mon = graph_monitor(model, init[:chains].clone(), sampler)
            if (not mon["capturable"] or not mon["windows_expected"] or not mon["same_lines"] or mon["differs"]
                    or mon["captures"] != {"eager": 0, "captured": 1}):
                failures.append(f"monitor of {sampler}: {mon}")
            say("graphs-monitor", **mon)
        except Exception as err:  # noqa: BLE001 -- the phase fails below
            failures.append(f"monitor of {sampler}: {type(err).__name__}: {err}")

    # tools/run_lgc_joint, captured by default, resumed bit for bit.
    try:
        tool = graph_lgc_joint_tool()
        if tool["stopped_returned"] is not None or not all(tool["bit_identical"].values()) or tool["captures"] < 1:
            failures.append(f"tools/run_lgc_joint: {tool}")
        tool.pop("stopped_returned")
        say("graphs-lgc-joint-tool", **tool)
    except Exception as err:  # noqa: BLE001 -- the phase fails below
        failures.append(f"tools/run_lgc_joint: {type(err).__name__}: {err}")

    # What stays eager: a FunctionModel, whose user's logp may read the device.
    fm = rt.models.FunctionModel(2, lambda w: -0.5 * torch.sum(w * w))
    try:
        rt.parallel.run(rt.samplers.hmc.build(fm), torch.Generator(device=DEVICE).manual_seed(0),
                        torch.zeros((8, 2), device=DEVICE), num_samples=1, capture=True)
        failures.append("FunctionModel: capture=True was not refused")
    except ValueError as err:
        say("graphs-refused", run="hmc-on-FunctionModel", error=str(err))

    # timed_sampling: the first half captures, the timed half replays (it raises on a capture).
    captures = rt.parallel.graphs.capture_count()
    experiments.timed_sampling(rmhmc.build(model), init, device=torch.device(DEVICE), seed=GRAPH_SEED, **GRAPH_TIMED)
    untimed = rt.parallel.graphs.capture_count() - captures
    if untimed != 1:
        failures.append(f"timed_sampling captured {untimed} graphs, expected one, before its timed half")
    say("graphs-timed-sampling", captures_before_timed_half=untimed, captures_in_timed_half=0)

    # run_checkpointed, captured: stopped after one segment and resumed, bit for bit the run not stopped.
    ckpt_dir = SMOKE_DATA.parent / "smoke_graph_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    kernel = rmhmc.build(model)
    whole = rt.parallel.run_checkpointed(kernel, GRAPH_SEED, init, checkpoint_path=ckpt_dir / "whole", capture=True,
                                         **GRAPH_CKPT)
    rt.parallel.run_checkpointed(kernel, GRAPH_SEED, init, checkpoint_path=ckpt_dir / "cut", capture=True,
                                 _stop_after_segments=1, **GRAPH_CKPT)
    resumed = rt.parallel.run_checkpointed(kernel, GRAPH_SEED, init, checkpoint_path=ckpt_dir / "cut", capture=True,
                                           **GRAPH_CKPT)
    eager = rt.parallel.run_checkpointed(kernel, GRAPH_SEED, init, checkpoint_path=ckpt_dir / "eager", capture=False,
                                         **GRAPH_CKPT)
    # A resumed run's rates cover the segments it ran: its samples and state are compared.
    resumed_differs = {f: leaves for f, leaves in run_differences(whole, resumed).items()
                       if f in ("samples", "final_state")}
    eager_differs = run_differences(whole, eager)
    for name, differs in (("resumed", resumed_differs), ("eager", eager_differs)):
        if differs:
            failures.append(f"run_checkpointed: the captured run and the {name} one differ in {differs}")
    say("graphs-checkpoint", **GRAPH_CKPT, resumed_equal=not resumed_differs, eager_equal=not eager_differs)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # Walls and idle shares, E C C E.
    for workload, sampler, chains in GRAPH_PROFILES:
        rows = [step_profile.profile_run(workload, sampler, chains, captured=captured, **GRAPH_PROFILE_DEPTH)
                for captured in (False, True, True, False)]
        keys = ("wall_ms_per_step", "device_busy_ms_per_step", "idle_share", "kernel_launches_per_step",
                *(k for k in rows[0] if k in ("gibbs_sweep_kernel_share_of_device", "gig_half_kernel_share_of_device",
                                              "draws_share_of_device")))
        say("graphs-times", run=f"{workload}/{sampler}", chains=chains, card=smi, order="E C C E",
            **{f"{path}_{key}": [row[key] for row in rows if row["path"] == path]
               for path in ("eager", "captured") for key in keys},
            capture_s=[rows[1]["capture_s"], rows[2]["capture_s"]],
            graph_pool_bytes=[rows[1]["graph_pool_bytes"], rows[2]["graph_pool_bytes"]])
    check(not failures, "graphs: " + "; ".join(failures))
    return launches_by_path


# The path whose count each linalg kernel's entry of the kernels line gives (K2 left the main path for K4 in
# PR 20: its count is StochVol RMHMC's hyper block's).
LAUNCHES_FROM = {"cholesky": "mmala/australian", "chol_solve_logdet": "stochvol/rmhmc",
                 "chol_inv_logdet": "rmhmc-main-path"}


def fixed_point_summary(fixed_point: dict, by_path: dict, smi: str) -> list[dict]:
    """K4's and K5's entries of the kernels line: their times at the main path's (4096, 690, 15) (K5 at 4 rounds,
    its one-round half-step beside), ``launches`` phase 5's main path, every path's count under
    ``launches_by_path``."""
    rows = []
    for name in FIXED_POINT_COUNTED:
        shapes = {f"C{c}_N{n}_D{d}": row for (c, n, d), row in fixed_point["times"].items()}
        times = fixed_point["times"][FIXED_POINT_TIMED[0]][name]
        paths = {label: counts[name] for label, counts in by_path.items() if name in counts}
        check(paths.get("rmhmc-main-path", 0) > 0, f"{name}: no launch on rmhmc-main-path ({paths})")
        rows.append({
            "name": name, "route": "cuda", "source": FIXED_POINT_SOURCE, "replaces": FIXED_POINT_REPLACES[name],
            "kernel": FIXED_POINT_KERNEL_NAMES[name], "launches": paths["rmhmc-main-path"],
            "launches_from": "rmhmc-main-path", "launches_counted_by": LAUNCHES_COUNTED_BY,
            "max_abs_err": fixed_point["err"][name], "max_abs_err_is": "against the plain version in float64",
            "ms": times["ms"], "plain_ms": times["plain_ms"], "bound_ms": times["bound_us"] / 1e3,
            "bound_by": times["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes it; parent_route_ms: the loops with K2 captured",
            "parent_route_ms": times["parent_route_ms"], "parent_route_device_us": times["parent_route_device_us"],
            "device_us": times["device_us"], "share_of_bound": times["share_of_bound"], "rounds": times["rounds"],
            "registers": {w: row[{"position_fixed_point": "K4", "momentum_fixed_point": "K5"}[name]]
                          for w, row in fixed_point["registers"].items()},
            "card": smi, "shape": {"C": FIXED_POINT_TIMED[0][0], "N": FIXED_POINT_TIMED[0][1], "D": FIXED_POINT_TIMED[0][2]},
            "shapes": {label: {k: v for k, v in row.items() if k.startswith(name.split("_")[0])} for label, row in shapes.items()},
            "launches_by_path": paths,
        })
    rows[1]["half_step"] = fixed_point["times"][FIXED_POINT_TIMED[0]]["momentum_half_step"]
    return rows


def tridiag_summary(tridiag: dict, by_path: dict, smi: str) -> list[dict]:
    """T1's and T2's entries of the kernels line: their times at (1024, 2000), ``launches`` phase 7's StochVol
    RMHMC run (T1 one a sweep, T2 L + 2), every path's count under ``launches_by_path``."""
    rows = []
    for name, source_name, replaces, shape in ((BIDIAG, BIDIAG_KERNEL_NAME, BIDIAG_REPLACES, BIDIAG_TIMED),
                                               (PCR, PCR_KERNEL_NAME, PCR_REPLACES, PCR_TIMED)):
        times = tridiag[name]["times"]
        paths = {label: counts[name] for label, counts in by_path.items() if name in counts}
        check(paths.get("stochvol/rmhmc", 0) > 0, f"{name}: no launch on stochvol/rmhmc ({paths})")
        rows.append({
            "name": name, "route": "cuda", "source": BIDIAG_SOURCE, "replaces": replaces, "kernel": source_name,
            "launches": paths["stochvol/rmhmc"], "launches_from": "stochvol/rmhmc",
            "launches_counted_by": LAUNCHES_COUNTED_BY, "max_abs_err": tridiag["err"][name],
            "ms": times["ms"], "plain_ms": times["plain_ms"], "bound_ms": times["bound_us"] / 1e3,
            "bound_by": times["bound_by"], "library_ms": None, "library_note": "no single PyTorch call computes it",
            "device_us": times["device_us"], "share_of_bound": times["share_of_bound"],
            "registers": times["registers"], "spill_store_bytes": times["spill_store_bytes"],
            "card": smi, "shape": {"B": shape[0], "T": shape[1]},
            "checked": tridiag[name]["checked"], "launches_by_path": paths,
        })
    rows[0]["ns_per_position"] = tridiag[BIDIAG]["times"]["ns_per_position"]
    rows[1]["past_shared_memory"] = tridiag[PCR]["times"]["long"]
    return rows


def gibbs_summary(kernels: dict, by_path: dict, smi: str) -> list[dict]:
    """G1's, G2's and the single round's entries of the kernels line: times at
    phase 6's shapes ((1024, 690, 15), the whole GIG draw at (1024, 690) and
    one round there with every element pending; the single round is off the
    Gibbs path since G2 draws its own numbers, so its launches there are 0),
    ``launches`` phase 6's Gibbs run, every path's count under
    ``launches_by_path``."""
    sweep, rounds, half = kernels["sweep"][0], kernels["gig"], kernels["gig_half"]
    rows = {"gibbs_sweep": (sweep, max(row["max_abs_err_kept_chains"] for row in kernels["sweep"]),
                            {"chains_parted": [row["chains_parted"] for row in kernels["sweep"]],
                             "elements_beyond_tolerance": [row["elements_beyond_tolerance"] for row in kernels["sweep"]],
                             "shapes_CND_zscale": [[row["C"], row["N"], row["D"], row["z_scale"]]
                                                   for row in kernels["sweep"]],
                             "tail_steps": [row["tail_steps"] for row in kernels["sweep"]],
                             "critical_path_us": sweep["critical_path_us"],
                             "share_of_critical_path": sweep["share_of_critical_path"],
                             "shapes": {f"C{row['C']}_N{row['N']}_D{row['D']}": {
                                 key: row[key] for key in ("device_us", "bound_us", "bound_by", "share_of_bound",
                                                           "critical_path_us", "ms", "plain_ms", "lanes",
                                                           "entries_a_lane", "wide", "device_us_by_layout",
                                                           "float64_kernel_rms_b", "float64_plain_rms_b",
                                                           "float64_kernel_rms_z", "float64_plain_rms_z")}
                                 for row in kernels["sweep"] if "device_us" in row}}),
            "gig_half": (half["times"], half["err"],
                         {"elements_differing": half["elements_differing"], "shape_CN": list(GIG_SHAPE),
                          "rounds_mean": half["times"]["rounds_mean"], "rounds_max": half["times"]["rounds_max"]}),
            "gig_round": (rounds["times"], rounds["err"],
                          {"elements_differing": rounds["elements_differing"], "shape_CN": list(GIG_SHAPE),
                           "all_accepted_round_device_us": rounds["times"]["all_accepted_round_device_us"],
                           "on_the_main_path": False})}
    out = []
    for name, (row, err, extra) in rows.items():
        paths = {label: counts[name] for label, counts in by_path.items() if name in counts}
        out.append({
            "name": name, "route": "cuda", "source": GIBBS_SOURCE, "replaces": GIBBS_REPLACES[name],
            "launches": paths.get("gibbs/australian", 0) if name == "gig_round" else paths["gibbs/australian"],
            "launches_counted_by": LAUNCHES_COUNTED_BY, "max_abs_err": err,
            "max_abs_err_is": "over the elements that took the plain version's branches (the others counted)",
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
            "library_ms": None, "library_note": "no single PyTorch call computes it",
            "device_us": row["device_us"], "share_of_bound": row["share_of_bound"], "card": smi,
            **extra, "launches_by_path": paths,
        })
    return out


PHASES = ("kernels", "transition", "main-path", "blr-samplers", "stochvol", "lgc", "lgc-joint", "fhn", "distributed",
          "tools", "graphs")


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
        regs = phase_build()
        lap("device+build")
        k_err = dict(NO_LINALG)
        with rt.ops.launches.paused():  # launches that compare and time a kernel are not the run's
            if "kernels" in phases:
                kernels = phase_kernels(smi)
                k_err = kernels["err"]
                gibbs_kernels = phase_gibbs_kernels(smi)
            if "kernels" in phases or "stochvol" in phases:  # T1's and T2's checks and times; phase 7 drives them
                tridiag = phase_tridiag_kernels(smi, regs)
            if "kernels" in phases or "fhn" in phases:  # the FHN kernel's checks and times; phase 10 reports them
                fhn_kernel = phase_fhn_kernel(smi, k_err)
            if "kernels" in phases or "main-path" in phases:  # K4 / K5's checks and times; phase 5 drives them
                fixed_point = phase_fixed_point_kernels(smi, regs)
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
        if "tools" in phases:
            by_path.update(phase_tools(smi))
            lap("tools")
        if "graphs" in phases:
            by_path.update(phase_graphs(smi))
            lap("graphs")
    say("phase-seconds", **seconds)
    if set(phases) != set(PHASES):
        print((_build.build().parent / "ptxas.log").read_text(), flush=True)
        return

    # Top-level times: the main path's shape (C 4096, D 15); every timed shape under "shapes".  Launches: on
    # the path each kernel serves (K1 left RMHMC's geometry for K3: its count is phase 6's mMALA run's).
    by_path["rmhmc-main-path"] = launches
    summary = []
    for name in LINALG_COUNTED:
        main_shape = kernels["times"][NUM_CHAINS, DIM][name]
        check(by_path[LAUNCHES_FROM[name]][name] > 0, f"{name}: no launch on {LAUNCHES_FROM[name]}")
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": by_path[LAUNCHES_FROM[name]][name], "launches_from": LAUNCHES_FROM[name],
            "launches_counted_by": LAUNCHES_COUNTED_BY, "max_abs_err": kernels["err"][name],
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_us"] / 1e3, "bound_by": main_shape["bound_by"],
            "library_ms": main_shape.get("library_ms"),
            **{key: main_shape[key] for key in ("device_us", "bound_us", "share_of_bound", "library_seq_ms")
               if key in main_shape},
            "card": smi,
            "shapes": {f"C{c}_D{d}": row[name] for (c, d), row in kernels["times"].items()},
            "launches_by_path": {label: counts[name] for label, counts in by_path.items() if name in counts},
        })
    summary += fixed_point_summary(fixed_point, by_path, smi)
    summary += tridiag_summary(tridiag, by_path, smi)
    summary.append(fhn_summary(fhn, smi))
    summary += gibbs_summary(gibbs_kernels, by_path, smi)
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
