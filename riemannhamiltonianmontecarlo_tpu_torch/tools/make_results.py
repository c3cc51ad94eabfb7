"""The BLR tables: the nine samplers on each dataset (paper Tables 3-7).

Port of ``tools/make_results.py``.  Protocol: reference hyperparameters and
iteration counts (``utils/config.py`` presets: 5000 kept samples for every
sampler, the reference burn-in), MAP + jitter init, the steady-state
sampling phase timed (``experiments.run_experiment``'s two halves), Geyer
ESS on the device (alias-free ACF) summed over chains.  Paper columns:
main_article.pdf Tables 3-7, single-chain MATLAB s/minESS (BASELINE.md).
The ``rmhmc``, ``rmhmc_studentt``, ``mmala``, ``mmala_simplified``,
``iwls`` and ``gibbs`` rows factor their metrics with the hand-written
Cholesky (K1) and fused solve (K2) kernels on a card; the ``gibbs`` row's
sweep and GIG rounds run as the kernels G1 and G2 (``ops/csrc/gibbs.cu``),
and like every other row it replays a captured CUDA graph of the step.

Usage::

    RHMC_DATA_DIR=<dir with australian.csv ...> python -m \\
        riemannhamiltonianmontecarlo_tpu_torch.tools.make_results \\
        [--dataset australian|german|pima|heart|ripley|all] [--samplers rmhmc ...] \\
        [--device cuda] [--out FILE]

Differences from the JAX package's tool: it never writes ``RESULTS.md``
(the section is printed, or spliced into ``--out`` under the same
``blr-NAME`` markers); the section is headed with the device (on a card its
name and power limit as ``nvidia-smi`` gives them) and the data's source;
there is no ``max_steps_per_call`` segmenting; a row that raises is a
``FAILED`` row, as there, and also makes the exit code non-zero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from riemannhamiltonianmontecarlo_tpu_torch.experiments import ExperimentResult, run_experiment
from riemannhamiltonianmontecarlo_tpu_torch.tools.common import (
    add_io_args,
    blr_data_source,
    device_line,
    device_or_exit,
    emit,
    fmt,
    splice,
)

__all__ = ["CHAINS", "PAPER", "TABLE_NO", "HEADER", "fmt", "splice", "result_row", "run_dataset", "main"]

# Chain counts sized per sampler cost; samples / burn-in come from the
# reference presets (5000 kept for every BLR sampler).
CHAINS = {
    "metropolis": 1024,
    "hmc": 1024,
    "mala": 2048,
    "mmala": 2048,
    "mmala_simplified": 2048,
    "iwls": 2048,
    "gibbs": 1024,
    "rmhmc": 2048,
    "rmhmc_studentt": 2048,
}

# Paper s/minESS per dataset: Tables 3 (australian), 4 (german), 5 (pima),
# 6 (heart), 7 (ripley) of main_article.pdf -- see BASELINE.md.
PAPER = {
    "australian": {"metropolis": 0.034, "gibbs": 10.9, "mala": 0.12, "hmc": 0.027,
                   "iwls": 1.3, "mmala": 0.016, "mmala_simplified": 0.006,
                   "rmhmc": 0.016, "rmhmc_studentt": 0.081},
    "german": {"metropolis": 0.140, "gibbs": 0.61, "mala": 0.037, "hmc": 0.037,
               "iwls": 1.86, "mmala": 0.070, "mmala_simplified": 0.012,
               "rmhmc": 0.052, "rmhmc_studentt": 0.065},
    "pima": {"metropolis": 0.011, "gibbs": 0.21, "mala": 0.005, "hmc": 0.014,
             "iwls": 0.386, "mmala": 0.0037, "mmala_simplified": 0.0018,
             "rmhmc": 0.0069, "rmhmc_studentt": 0.0098},
    "heart": {"metropolis": 0.010, "gibbs": 0.21, "mala": 0.0038, "hmc": 0.0085,
              "iwls": 0.85, "mmala": 0.0085, "mmala_simplified": 0.0043,
              "rmhmc": 0.0087, "rmhmc_studentt": 0.018},
    "ripley": {"metropolis": 0.035, "gibbs": 7.0, "mala": 0.029, "hmc": 0.0076,
               "iwls": 0.39, "mmala": 0.0075, "mmala_simplified": 0.0045,
               "rmhmc": 0.0065, "rmhmc_studentt": 0.011},
}

TABLE_NO = {"australian": 3, "german": 4, "pima": 5, "heart": 6, "ripley": 7}

HEADER = ("| sampler | chains | samples | accept | divergent | max R-hat "
          "| total ESS (min, med, max) "
          "| time (s) | s/minESS | paper s/minESS | speedup |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def result_row(sampler: str, res: ExperimentResult, paper: float) -> str:
    spm = res.time_per_min_ess
    rhat = f"{res.rhat_max:.3f}" if np.isfinite(res.rhat_max) else "--"
    return (
        f"| {sampler} | {res.num_chains} | {res.num_samples} | "
        f"{res.accept_rate:.3f} | {res.divergences} | {rhat} | "
        f"({fmt(res.ess_min)}, {fmt(res.ess_median)}, "
        f"{fmt(res.ess_max)}) | {res.sampling_time_s:.3f} | {spm:.2e} | "
        f"{paper} | {paper / spm:,.0f}x |"
    )


def run_dataset(dataset: str, *, device: str | torch.device = "cuda", chains: int | None = None,
                samples: int | None = None, burn_in: int | None = None, samplers=None, seed: int = 0) -> str:
    """The section of one dataset.  ``chains`` (default: ``CHAINS`` per
    sampler), ``samples`` / ``burn_in`` (default: the reference presets) and
    ``samplers`` (default: all nine, in ``CHAINS`` order) cut the run."""
    device = torch.device(device)
    rows = []
    for sampler in samplers or CHAINS:
        n_chains = CHAINS[sampler] if chains is None else chains
        paper = PAPER[dataset][sampler]
        print(f"--- {dataset}/{sampler} ({n_chains} chains)", flush=True)
        try:
            res = run_experiment(sampler, dataset, device=device, num_chains=n_chains, num_samples=samples,
                                 burn_in=burn_in, seed=seed, ess_mode="device")
        except Exception as e:  # keep the table going
            print(f"    FAILED: {e}", flush=True)
            rows.append(f"| {sampler} | -- | -- | FAILED | | | | | | {paper} | |")
            continue
        print("   ", res.summary().splitlines()[2].strip(), flush=True)
        rows.append(result_row(sampler, res, paper))
    return (
        f"## BLR {dataset} (paper Table {TABLE_NO[dataset]}), {device_line(device)}\n\n"
        "All samplers at reference hyperparameters and iteration counts\n"
        "(utils/config.py presets, 5000 kept samples), MAP+jitter init, Geyer ESS\n"
        "(device, alias-free ACF) summed over chains, timing = steady-state sampling\n"
        f"phase only.  speedup = paper s/minESS / ours.  Data: {blr_data_source(dataset)}.\n\n"
        + HEADER + "\n" + "\n".join(rows)
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="all", choices=[*PAPER, "all"])
    ap.add_argument("--samplers", nargs="+", choices=list(CHAINS), default=None,
                    help="the rows to run (default: all nine)")
    add_io_args(ap)
    args = ap.parse_args(argv)
    device = device_or_exit(ap, args.device)
    failed = 0
    for name in list(PAPER) if args.dataset == "all" else [args.dataset]:
        section = run_dataset(name, device=device, samplers=args.samplers)
        failed += section.count(" | FAILED | ")
        emit(f"blr-{name}", section, args.out)
    if failed:
        sys.exit(f"{failed} row(s) FAILED")


if __name__ == "__main__":
    main()
