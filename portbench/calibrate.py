"""The readings a cell's limits are set from: the program's over many seeds, and the control's.

    python3 -m portbench.calibrate --workload <cell> --seeds 11 12 ... --control-seeds 3 --seconds 3

For each seed the cell runs as ``portbench.run`` runs it (a short window of
``--seconds``), and the numbers the comparison reads on its kept transitions
are printed.  For the first ``--control-seeds`` seeds the control is judged on
the same transitions: the plain reference in the precision below the
configuration's, which the configuration names as its ``control``
(``reference.precision``: ``tf32`` where it states float32 with TF32 off and
its work is contractions, ``bfloat16`` where its work is elementwise float32),
put in the program's place, from the same state and
draws.  A limit lies above the program's largest reading and below the
control's smallest (PERF.md gives both).  The benchmark's own runs never run
the control.  Needs a CUDA card; ``calibrate_cell`` also runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_readings(cell, checks, device) -> dict:
    """The comparison's numbers for the control on ``checks`` (``run.Check``)."""
    from portbench import judge, spec
    from portbench.reference import precision

    family = spec.family(cell)
    low = precision.BY_NAME[cell.config["control"]]
    ref_low = family.reference(cell.config, cell.traffic, low, device)
    ref = family.reference(cell.config, cell.traffic, precision.FLOAT64, device)
    cands = [{key: judge.control_output(c.before[key], prop) for _, key, prop in ref_low.sweep(c.before, c.noise)}
             for c in checks]
    return judge.readings(ref, checks, cands)


def calibrate_cell(cell, seeds, control_seeds: int, seconds: float, device, emit=print) -> dict:
    """Run ``cell`` on each seed; return {"program": [readings...], "control": [readings...]}."""
    from portbench import run

    found = {"program": [], "control": []}
    for i, seed in enumerate(seeds):
        checks = []
        out = run.run_cell(cell, seed, seconds, False, device, time.perf_counter(), keep=checks)
        row = {"seed": seed, "program": {k: v["value"] for k, v in out["checks"].items()},
               "correct": out["correct"], "checks": len(checks)}
        found["program"].append(row["program"])
        if i < control_seeds:
            row["control"] = control_readings(cell, checks, device)
            found["control"].append(row["control"])
        emit(json.dumps(row))
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    from portbench import run

    run.pin_caches(run.CHECKOUT)
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_json(run.CHECKOUT / "BENCHMARK.json"), args.workload)
    found = calibrate_cell(cell, args.seeds, args.control_seeds, args.seconds, torch.device("cuda", 0),
                           emit=lambda s: print(s, flush=True))
    summary = {k: {"program_max": max(r[k] for r in found["program"]),
                   "control_min": min((r[k] for r in found["control"]), default=None)}
               for k in found["program"][0]}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
