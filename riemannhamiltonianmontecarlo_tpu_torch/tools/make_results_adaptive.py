"""Dual-averaged step sizes against the hand-tuned presets.

Port of ``tools/make_results_adaptive.py``.  The reference hand-tunes every
step size per (sampler, dataset) -- the paper's Table 2 (BASELINE.md) shows
how sensitive RMHMC is to that choice on german credit.  This table runs
each sampler twice:

* preset: the reference constant (``utils/config.py``);
* adapted: a dual-averaging warmup on the pooled cross-chain acceptance
  (``parallel/adaptation.py``), from a dimension-blind default -- no
  per-dataset tuning.

Usage::

    RHMC_DATA_DIR=<dir with german.csv> python -m \\
        riemannhamiltonianmontecarlo_tpu_torch.tools.make_results_adaptive \\
        [--dataset german] [--device cuda] [--out FILE]

As ``make_results``: never ``RESULTS.md`` (printed, or spliced into
``--out`` under the ``adaptive-NAME`` markers), headed with the device and
the data's source; a sampler that raises gives a ``FAILED`` row (the JAX
tool leaves it out) and makes the exit code non-zero.
"""

from __future__ import annotations

import argparse
import sys

import torch

from riemannhamiltonianmontecarlo_tpu_torch.experiments import run_experiment
from riemannhamiltonianmontecarlo_tpu_torch.tools.common import (
    add_io_args,
    blr_data_source,
    device_line,
    device_or_exit,
    emit,
)
from riemannhamiltonianmontecarlo_tpu_torch.utils.config import MALA_STEP_SIZES, reference_preset

SAMPLERS = [
    ("hmc", 1024),
    ("mala", 2048),
    ("mmala", 2048),
    ("mmala_simplified", 2048),
    ("rmhmc", 2048),
]

HEADER = ("| sampler | chains | preset eps | preset s/minESS | adapted eps "
          "| adapted accept | adapted s/minESS | adapted/preset "
          "| divergent (preset/adapted) | max R-hat (preset/adapted) |\n"
          "|---|---|---|---|---|---|---|---|---|---|")


def run_adaptive(dataset: str = "german", *, device: str | torch.device = "cuda", chains: int | None = None,
                 samples: int | None = None, burn_in: int | None = None, samplers=None, seed: int = 0) -> str:
    """The section of one dataset; the keywords cut the run as in
    ``make_results.run_dataset`` (``chains`` default: ``SAMPLERS``')."""
    device = torch.device(device)
    rows = []
    for sampler, default_chains in SAMPLERS:
        if samplers is not None and sampler not in samplers:
            continue
        n_chains = default_chains if chains is None else chains
        preset_kw = reference_preset(sampler, dataset).sampler_kwargs
        preset_eps = preset_kw.get("step_size", MALA_STEP_SIZES.get(dataset, "--") if sampler == "mala" else "--")
        kw = dict(device=device, num_chains=n_chains, num_samples=samples, burn_in=burn_in, seed=seed,
                  ess_mode="device")
        print(f"--- {dataset}/{sampler} preset", flush=True)
        try:
            pre = run_experiment(sampler, dataset, **kw)
            print(f"--- {dataset}/{sampler} adapted", flush=True)
            ada = run_experiment(sampler, dataset, adapt=True, **kw)
        except Exception as e:  # keep the table going
            print(f"    FAILED: {e}", flush=True)
            rows.append(f"| {sampler} | {n_chains} | {preset_eps} | FAILED | | | | | | |")
            continue
        ratio = ada.time_per_min_ess / pre.time_per_min_ess
        rows.append(
            f"| {sampler} | {n_chains} | {preset_eps} | {pre.time_per_min_ess:.2e} "
            f"| {ada.adapted_step_size:.3g} | {ada.accept_rate:.3f} "
            f"| {ada.time_per_min_ess:.2e} | {ratio:.2f}x "
            f"| {pre.divergences}/{ada.divergences} "
            f"| {pre.rhat_max:.3f}/{ada.rhat_max:.3f} |"
        )
        print("   ", rows[-1], flush=True)
    return (
        f"## Dual-averaged step sizes vs hand-tuned presets -- {dataset}, {device_line(device)}\n\n"
        "Adapted runs start from a dimension-blind default step and warm up by\n"
        "dual averaging on the pooled acceptance of every chain (thousands of\n"
        "chains give a near-noiseless per-step acceptance signal, so the step\n"
        "converges in tens of iterations; parallel/adaptation.py).  Preset runs\n"
        "use the reference's hand-tuned constants.  adapted/preset < ~1 means\n"
        "zero-tuning matches or beats hand tuning (paper Table 2 shows RMHMC's\n"
        f"sensitivity to (eps, L) on this dataset).  Data: {blr_data_source(dataset)}.\n\n"
        + HEADER + "\n" + "\n".join(rows)
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="german")
    add_io_args(ap)
    args = ap.parse_args(argv)
    device = device_or_exit(ap, args.device)
    section = run_adaptive(args.dataset, device=device)
    emit(f"adaptive-{args.dataset}", section, args.out)
    if " | FAILED | " in section:
        sys.exit(f"{section.count(' | FAILED | ')} sampler(s) FAILED")


if __name__ == "__main__":
    main()
