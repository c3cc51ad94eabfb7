"""Chain-parallel scaling: BLR RMHMC throughput against world size, the
chain count per rank held fixed (weak scaling).

Port of ``tools/scaling_table.py``.  For each world size the ranks are plain
processes started by ``parallel.launch.spawn`` over Gloo, on the CPU
(``--device cpu``) or sharing one card; each advances its rows of the chains
with the chain-split step (``parallel.run(..., mesh=)``) through a burn-in,
an untimed run and a timed one.  The time is the slowest rank's.  On a card
each rank replays a CUDA graph of its chain-split step (it makes no
collective, so Gloo does not keep it eager), captured in the burn-in; the
rows give the path and the captures each rank made.

Indicative only: ranks that share one card, or one host's cores, cannot
scale -- the table shows the harness and the split program end to end (the
chains are the same whatever the split: ``tests/test_torch_distributed.py``).

Usage::

    RHMC_DATA_DIR=<dir with australian.csv> python -m \\
        riemannhamiltonianmontecarlo_tpu_torch.tools.scaling_table \\
        [--ranks 1 2 4 8] [--chains-per-rank 64] [--device cuda] [--out FILE]

The table is printed, or spliced into ``--out`` under the ``scaling``
markers, headed with the device.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from riemannhamiltonianmontecarlo_tpu_torch import interop, models, parallel, utils
from riemannhamiltonianmontecarlo_tpu_torch.parallel.launch import spawn
from riemannhamiltonianmontecarlo_tpu_torch.samplers import rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.tools.common import (
    add_io_args,
    blr_data_source,
    device_line,
    device_or_exit,
    emit,
    synchronize,
)

LAUNCH_TIMEOUT = 1800.0


def rank_run(out: str, device: str, chains_per_rank: int, samples: int, burn_in: int, data_dir: str | None) -> None:
    """One rank (run by ``parallel.launch``): rank 0 writes the slowest
    rank's seconds to ``out``."""
    if data_dir:
        models.datasets._SEARCH_PATHS = (data_dir,)
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    ds = models.load_dataset("australian")
    model = interop.logreg_from_numpy(ds.X, ds.t, device=device)
    kernel = rmhmc.build(model)
    mesh = parallel.make_mesh()
    chains = chains_per_rank * dist.get_world_size()
    init = utils.default_init(model, torch.Generator(device=device).manual_seed(7), chains)
    gen = torch.Generator(device=device).manual_seed(1)
    captures = parallel.graphs.capture_count()
    warm = parallel.run(kernel, gen, init, num_samples=0, burn_in=burn_in, collect=False, mesh=mesh)
    pre = parallel.run(kernel, gen, None, num_samples=samples, collect=False, init_state=warm.final_state, mesh=mesh)
    synchronize(device)
    dist.barrier()
    t0 = time.perf_counter()
    res = parallel.run(kernel, gen, None, num_samples=samples, collect=False, init_state=pre.final_state, mesh=mesh)
    synchronize(device)
    seconds = time.perf_counter() - t0
    made = parallel.graphs.capture_count() - captures
    slowest, most = (parallel.collectives.all_reduce(torch.tensor([x], dtype=torch.float64), dist.group.WORLD,
                                                     op=dist.ReduceOp.MAX) for x in (seconds, made))
    if dist.get_rank() == 0:
        path = "captured" if made else "eager"
        Path(out).write_text(json.dumps({"seconds": float(slowest[0]), "accept": float(res.accept_rate),
                                         "device": str(device), "path": path, "captures": int(most[0])}))


def run_scaling(*, device: str | torch.device = "cuda", ranks=(1, 2, 4, 8), chains_per_rank: int = 64,
                samples: int = 200, burn_in: int = 100) -> str:
    """The section: one row per world size in ``ranks``."""
    device = torch.device(device)
    data = models.datasets.find_data_file("australian.csv")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in ranks:
            out = Path(tmp) / f"world{n}.json"
            spawn("riemannhamiltonianmontecarlo_tpu_torch.tools.scaling_table:rank_run", n, device=device.type,
                  backend="gloo", timeout=LAUNCH_TIMEOUT,
                  args=[str(out), device.type, chains_per_rank, samples, burn_in, str(data.parent) if data else None])
            got = json.loads(out.read_text())
            chains = chains_per_rank * n
            rate = chains * samples / got["seconds"]
            step = f"{got['path']} ({got['captures']} capture{'s' * (got['captures'] != 1)} a rank)"
            rows.append((n, chains, step, got["seconds"], rate, got["accept"]))
            print(f"{n} rank(s): {chains} chains, {samples} steps in {got['seconds']:.2f}s = {rate:,.0f} "
                  f"chain-samples/s (accept {got['accept']:.3f}, step {step})", flush=True)
    base = rows[0][4] / rows[0][0]
    table = [f"| ranks | chains ({chains_per_rank}/rank) | step | time (s) | chain-samples/s | accept "
             "| scaling (shared device -- NOT indicative) |", "|---|---|---|---|---|---|---|"]
    for n, chains, step, t, rate, accept in rows:
        table.append(f"| {n} | {chains} | {step} | {t:.2f} | {rate:,.0f} | {accept:.3f} "
                     f"| {rate / (base * n):.2f}x/linear |")
    return (
        f"## Chain-split demonstration (ranks sharing one device -- not a scaling claim) -- BLR australian "
        f"RMHMC, weak scaling shape ({chains_per_rank} chains/rank), {device_line(device)}\n\n"
        "**Indicative only:** the ranks are processes over Gloo that share one device (one card,\n"
        "or one host's cores), so wall clock cannot improve; the table shows the chain-split\n"
        "program end to end (every rank draws every chain's noise and keeps its rows, so the\n"
        "chains are the same however they are split).  "
        f"Data: {blr_data_source('australian')}.\n\n"
        + "\n".join(table)
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--chains-per-rank", type=int, default=64)
    add_io_args(ap)
    args = ap.parse_args(argv)
    device = device_or_exit(ap, args.device)
    emit("scaling", run_scaling(device=device, ranks=args.ranks, chains_per_rank=args.chains_per_rank), args.out)


if __name__ == "__main__":
    main()
