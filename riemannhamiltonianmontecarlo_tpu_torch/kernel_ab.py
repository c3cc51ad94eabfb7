"""Time the K1 / K2 kernels of two checkouts in turns on one CUDA card.

    python -m riemannhamiltonianmontecarlo_tpu_torch.kernel_ab --parent DIR [--out FILE]

``DIR`` holds another checkout of the repository (for example an earlier
commit unpacked with ``git archive`` under the git-ignored ``build/``); this
checkout is the change.  The two are measured in the order parent, change,
change, parent, each turn in a process of its own that imports the port
from that checkout, builds its kernels there and times them with this
checkout's ``chip_smoke.py`` helpers at ``chip_smoke.TIMED_SHAPES``:

* ``ms``: median CUDA-event time of one wrapper call (50 calls);
* ``burst_ms``: 200 wrapper calls back to back, over the count;
* ``kernel_only_ms``: 200 launches back to back on allocated operands;
* ``device_us``: the kernel's own duration by name, torch.profiler, 50 launches;
* ``wrapper_device_us`` / ``wrapper_device_kernels``: every device event of
  one wrapper call (the kernel and whatever copies the wrapper makes).

A checkout whose wrappers take chains-last (D, D, C) operands (no
``hopper_linalg.launch_geometry``) gets its launches on such operands.
Prints one JSON line per turn, kernel and shape, with the card's name and
power limit.  Needs a CUDA device and nvcc; there is no CPU path.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TURNS = ("parent", "change", "change", "parent")


def _measure(root: Path) -> list[dict]:
    """Runs in the child: import the port from ``root`` and time its kernels."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke  # dataclasses looks a class's module up there
    spec.loader.exec_module(smoke)  # imports the port: from root, first on sys.path
    import torch

    hl = smoke.hl
    if Path(hl.__file__).resolve().parents[2] != root.resolve():
        raise RuntimeError(f"imported the port from {hl.__file__}, not from {root}")
    public_layout = hasattr(hl, "launch_geometry")
    lib, card, rows = hl._lib(), smoke.smi_line(), []
    with torch.inference_mode():
        for c, d in smoke.TIMED_SHAPES:
            g, b = smoke.spd_batch(c, d, seed=d)
            gk, bk = (g, b) if public_layout else (g.permute(1, 2, 0).contiguous(), b.T.contiguous())
            l, x, logdet = torch.empty_like(gk), torch.empty_like(bk), torch.empty(c, device=g.device)
            calls = {
                "cholesky": (lambda: hl.cholesky_cuda(g),
                             lambda: hl._launch("cholesky", lib.rhmc_cholesky, (gk, l), c, d)),
                "chol_solve_logdet": (lambda: hl.chol_solve_logdet_cuda(g, b),
                                      lambda: hl._launch("chol_solve_logdet", lib.rhmc_chol_solve_logdet,
                                                         (gk, bk, x, logdet), c, d)),
            }
            for name, (wrapper, launch) in calls.items():
                dev, whole = smoke.device_us(launch, name_part=smoke.KERNEL_NAMES[name]), smoke.device_us(wrapper)
                bound, _ = smoke.bound_us(name, c, d)
                rows.append({
                    "kernel": name, "C": c, "D": d, "layout": "public" if public_layout else "chains-last",
                    "ms": smoke.median_ms(wrapper), "burst_ms": smoke.burst_ms(wrapper),
                    "kernel_only_ms": smoke.burst_ms(launch), "device_us": dev["us"],
                    "device_us_source": dev["source"], "wrapper_device_us": whole["us"],
                    "wrapper_device_kernels": whole["events_per_call"], "bound_us": bound,
                    "share_of_bound": bound / dev["us"], "card": card,
                })
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    ap.add_argument("--measure", type=Path, default=None, help=argparse.SUPPRESS)  # the child's mode
    args = ap.parse_args(argv)
    if args.measure is not None:
        print(json.dumps(_measure(args.measure)), flush=True)
        return
    if args.parent is None:
        ap.error("--parent is required")
    roots = {"parent": args.parent.resolve(), "change": REPO}
    lines = []
    for turn, which in enumerate(TURNS):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", str(roots[which])],
                              capture_output=True, text=True, check=False, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"turn {turn} ({which}) failed:\n{proc.stdout}\n{proc.stderr}")
        for row in json.loads(proc.stdout.strip().splitlines()[-1]):
            lines.append(json.dumps({"turn": turn, "which": which, **row}))
            print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
