"""What the results tools share: the device heading, the number format and
the section splicing of the JAX package's ``tools/make_results.py``, and the
rule that no results tool writes ``RESULTS.md``.

``RESULTS.md`` is the JAX package's record.  A results tool prints its section, or
splices it into ``--out FILE`` between ``<!-- section:NAME -->`` /
``<!-- end:NAME -->`` markers, the JAX tools' own; an ``--out`` that names
``RESULTS.md`` is refused.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

import torch

from riemannhamiltonianmontecarlo_tpu_torch.experiments import resolve_device
from riemannhamiltonianmontecarlo_tpu_torch.models.datasets import find_data_file

RESULTS = Path(__file__).resolve().parents[2] / "RESULTS.md"


def fmt(x: float) -> str:
    return f"{x:.3g}" if abs(x) < 1000 else f"{x:,.0f}"


def splice(text: str, name: str, section: str) -> str:
    start, end = f"<!-- section:{name} -->", f"<!-- end:{name} -->"
    block = f"{start}\n{section}\n{end}"
    if start in text:
        pre = text[: text.index(start)]
        post = text[text.index(end) + len(end):]
        return pre + block + post
    return text.rstrip() + "\n\n" + block + "\n"


def smi_line(index: int = 0) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[index]


def device_line(device: torch.device) -> str:
    """What the numbers were taken on: the card's name and power limit, or the CPU."""
    if device.type != "cuda":
        return f"torch {torch.__version__} on the CPU ({torch.get_num_threads()} threads)"
    return f"{smi_line(device.index or 0)} (torch {torch.__version__}, CUDA {torch.version.cuda})"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def blr_data_source(dataset: str) -> str:
    path = find_data_file(f"{dataset}.csv")
    return f"{dataset}.csv from {path.parent}" if path is not None else f"{dataset}.csv absent"


def add_io_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1 or cpu (default cuda)")
    ap.add_argument("--out", default=None, help="splice the section into this file (default: print it)")


def device_or_exit(ap: argparse.ArgumentParser, device: str) -> torch.device:
    """The device asked for; a CUDA request without a card is an error (exit 2)."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        ap.error(str(e))


def emit(name: str, section: str, out: str | Path | None) -> None:
    """Print ``section``, or splice it into ``out`` under ``name``'s markers."""
    if out is None:
        print(section, flush=True)
        return
    out = Path(out)
    if out.resolve() == RESULTS.resolve():
        raise ValueError(f"{RESULTS.name} is the JAX package's record: write the section to another file")
    text = out.read_text() if out.exists() else "# RESULTS\n"
    out.write_text(splice(text, name, section))
    print(f"=== wrote section {name} to {out}", flush=True)
