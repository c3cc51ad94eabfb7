"""The native C++ ESS engine against NumPy on a results-scale sample tensor.

Port of ``tools/ess_engine_bench.py``.  It runs the BLR RMHMC experiment
through ``ess_mode="native"`` (the CLI's ``--ess-mode native`` route,
``experiments.run_experiment``), then times the threaded C++ Geyer engine
(``native/fastess.cpp``, built by ``diagnostics.native``) and the NumPy
estimator in its alias-free mode, the one the engine implements, on the
same (C, S, D) host tensor, and holds them within 1e-3 relative.

Usage::

    RHMC_DATA_DIR=<dir with german.csv> python -m \\
        riemannhamiltonianmontecarlo_tpu_torch.tools.ess_engine_bench \\
        [--dataset german] [--chains 2048] [--device cuda] [--out FILE]

Never ``RESULTS.md``: the section is printed, or spliced into ``--out``
under the ``ess-engine`` markers, headed with the device and the host's
cores.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from riemannhamiltonianmontecarlo_tpu_torch import diagnostics
from riemannhamiltonianmontecarlo_tpu_torch.experiments import run_experiment
from riemannhamiltonianmontecarlo_tpu_torch.tools.common import (
    add_io_args,
    blr_data_source,
    device_line,
    device_or_exit,
    emit,
)

MAX_REL_DEV = 1e-3


def run_bench(dataset: str = "german", *, device: str | torch.device = "cuda", chains: int = 2048,
              samples: int | None = None, burn_in: int | None = None, seed: int = 0) -> str:
    """The section; ``samples`` / ``burn_in`` default to the reference preset."""
    device = torch.device(device)
    print(f"--- BLR {dataset} rmhmc, ess_mode=native ({chains} chains)", flush=True)
    res = run_experiment("rmhmc", dataset, device=device, num_chains=chains, num_samples=samples, burn_in=burn_in,
                         seed=seed, ess_mode="native", keep_samples=True)
    print(res.summary(), flush=True)
    x = res.samples  # (C, S, D) host array
    c, s, d = x.shape

    t0 = time.perf_counter()
    ess_native = diagnostics.ess_geyer_native(x)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    ess_numpy = diagnostics.ess_multichain(x, nfft_mode="exact")
    t_numpy = time.perf_counter() - t0
    rel = float((np.abs(ess_native - ess_numpy) / ess_numpy).max())
    print(f"native {t_native:.2f}s vs numpy {t_numpy:.2f}s ({t_numpy / t_native:.1f}x); max rel dev {rel:.2e}",
          flush=True)
    if not rel < MAX_REL_DEV:
        raise AssertionError(f"native ESS departs from NumPy's by {rel:.2e} (limit {MAX_REL_DEV})")

    return (
        f"## Native ESS engine -- BLR {dataset} RMHMC, {c} chains x {s} samples x {d} coords, "
        f"{os.cpu_count()}-core host, sampled on {device_line(device)}\n\n"
        "A full-protocol run measured end-to-end through `ess_mode=\"native\"`\n"
        "(`experiments.run_experiment` -> `native/fastess.cpp`, threaded FFT Geyer; its own\n"
        "run stats below -- the BLR table row is an independent measurement).\n"
        f"Post-processing the same ({c}, {s}, {d}) tensor ({c * d:,} series).  "
        f"Data: {blr_data_source(dataset)}.\n\n"
        "| engine | wall (s) | speedup | max rel. deviation |\n"
        "|---|---|---|---|\n"
        f"| NumPy (reference mode) | {t_numpy:.2f} | 1x | -- |\n"
        f"| C++ threaded (`fastess`) | {t_native:.2f} | {t_numpy / t_native:.1f}x | {rel:.1e} |\n\n"
        f"Experiment row: min ESS {res.ess_min:,.0f}, sampling {res.sampling_time_s:.2f} s, "
        f"s/minESS {res.time_per_min_ess:.2e}, accept {res.accept_rate:.3f}, max R-hat {res.rhat_max:.4f}."
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="german")
    ap.add_argument("--chains", type=int, default=2048)
    add_io_args(ap)
    args = ap.parse_args(argv)
    device = device_or_exit(ap, args.device)
    emit("ess-engine", run_bench(args.dataset, device=device, chains=args.chains), args.out)


if __name__ == "__main__":
    main()
