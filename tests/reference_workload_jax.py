"""The JAX package's numbers that ``chip_smoke.py`` holds the port's workloads to.

Not a test (pytest does not collect it): a script, run once on a CPU with the
JAX package installed, whose output is stored in ``chip_smoke.py`` (``LGCJ_JAX``,
``FHN_JAX``; the ``rmhmc``, ``hmc`` and ``mmala`` entries of ``SV_JAX``).

    JAX_PLATFORMS=cpu python tests/reference_workload_jax.py --workload lgc \\
        --samplers rmhmc_joint mmala_joint --lgc-n 32 --chains 16 --burn-in 50 --samples 100
    JAX_PLATFORMS=cpu python tests/reference_workload_jax.py --workload stochvol \\
        --samplers hmc --chains 64 --burn-in 20 --samples 20
    JAX_PLATFORMS=cpu python tests/reference_workload_jax.py --workload fhn \\
        --samplers rmhmc --chains 64 --burn-in 50 --samples 50

For each sampler it builds the workload with the JAX package's
``experiments.build_workload(workload, sampler, seed=seed, ...)`` (reference
constants, data generated from the seed), runs ``parallel.run`` for
``burn-in`` + ``samples`` sweeps from the reference start (the burn-in
stepped by the workload's warmup kernel where it has one) and prints one JSON
line: the mean acceptance of the sampling phase, the divergences, and the
mean and standard deviation over chains of the per-chain means of the
constrained hyperparameters (StochVol, joint LGC: the ``"hyper"`` group) or
of the ODE parameters (FitzHugh-Nagumo: the ``"params"`` group).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from riemannhamiltonianmontecarlo_tpu import experiments, parallel  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", choices=("stochvol", "lgc", "fhn"), required=True)
    ap.add_argument("--samplers", nargs="+", required=True)
    ap.add_argument("--lgc-n", type=int, default=64)
    ap.add_argument("--stochvol-obs", type=int, default=2000)
    ap.add_argument("--fhn-obs", type=int, default=200)
    ap.add_argument("--fhn-substeps", type=int, default=5)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--burn-in", type=int, default=50)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    size = {"lgc": {"lgc_n": args.lgc_n}, "stochvol": {"stochvol_obs": args.stochvol_obs},
            "fhn": {"fhn_obs": args.fhn_obs, "fhn_substeps": args.fhn_substeps}}[args.workload]
    group = "params" if args.workload == "fhn" else "hyper"
    for sampler in args.samplers:
        kernel, init_fn, collect_fn, groups_fn, warmup_kernel = experiments.build_workload(
            args.workload, sampler, seed=args.seed, **size)
        t0 = time.perf_counter()
        res = parallel.run(kernel, jax.random.key(args.seed), init_fn(args.chains), num_samples=args.samples,
                           burn_in=args.burn_in, collect_fn=collect_fn, warmup_kernel=warmup_kernel)
        cm = np.asarray(groups_fn(res.samples)[group]).mean(axis=1)  # (C, S, P) -> (C, P)
        print(json.dumps({
            "workload": args.workload, "sampler": sampler, **size, "chains": args.chains,
            "burn_in": args.burn_in, "samples": args.samples, "seed": args.seed, "jax": jax.__version__,
            "accept": float(res.accept_rate), "divergent": int(res.divergences),
            "mean": cm.mean(axis=0).tolist(), "sd": cm.std(axis=0, ddof=1).tolist(),
            "seconds": time.perf_counter() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
