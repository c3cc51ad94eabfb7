"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.

Set-up (``setup_s``, from this module's first statement): torch is imported,
the card queried, the program imported, the CUDA context made, the program's
CUDA library loaded (built on a checkout's first run, under the checkout's
``build/``), the configuration's data made, the chains started from the seed,
``burn_in`` steps run (the first captures the step's CUDA graph), and one
segment of each length the window uses run once.  The window: the captured
step replayed through ``parallel.runner.run`` in segments of ``segment_steps``
steps, the state carried from one to the next, at most ``IN_FLIGHT`` segments
queued ahead of the device, until ``--seconds`` have passed on the host's
clock; then the device is synchronised and the window closes.  At ``CHECKS``
moments drawn from the seed one segment is a single step, whose state before
and after and whose generator state are kept for the comparison.  Every
transition's position is kept (on the device up to ``DEVICE_SAMPLE_BYTES``,
then in pinned host memory) for the ESS.  A capture inside the window fails
the run.

With ``--trace 1``, after the window, ``TRACE_WARM_SEGMENTS`` segments of the
window's length run under ``torch.profiler`` unread (its first graph launches
and set-up), the device is synchronised, and the segments that follow for at
least ``TRACE_SECONDS`` are the traced steps: the per-layer metrics are read
from them and from the window; with ``--trace 0`` the end-to-end metrics.
Then the program is freed and each kept transition is judged against the plain reference (``judge.py``).
The last line of standard output is the result; the numbers compared, each
with its limit, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "riemannhamiltonianmontecarlo_tpu")
DEVICE_SAMPLE_BYTES = 16 << 30  # kept samples past this go to pinned host memory
IN_FLIGHT = 2  # segments queued ahead of the device in the window
CHECKS = 4  # single steps of the window kept for the comparison
TRACE_WARM_SEGMENTS = 1  # segments run under the profiler before the traced steps, not read
TRACE_SECONDS = 0.3  # the traced steps last at least this long by the host's clock
TRACED_RANGE = "portbench.traced_steps"


def pin_caches(checkout: Path) -> None:
    """Every compiler cache a run could write, at a fixed path inside the checkout (the program builds its
    CUDA library under ``<checkout>/build/hopper_kernels`` by itself)."""
    cache = checkout / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


class Facts(NamedTuple):
    """What the metric readers read."""

    shapes: dict
    setup_s: float
    window_s: float
    steps: int
    chains: int
    accept_rate: float
    ess: list  # each coordinate's ESS, summed over chains
    capture_s: float | None
    step_ops: float
    trace: object  # yardstick.trace.Trace of the traced steps, or None


class Check(NamedTuple):
    before: dict  # the program's plain state before the step
    after: dict
    noise: dict


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card_reading() -> dict:
    """The card's name, SM clock, power draw and limit and temperature from ``nvidia-smi``."""
    fields = "name,clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return {"error": repr(exc)}
    return dict(zip(fields.split(","), (v.strip() for v in out.split(","))))


def _to_host(x):
    import torch

    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float, keep: list | None = None,
             split: dict | None = None) -> dict:
    """Run ``cell`` (``spec.Cell``) once; return the result's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` with a trace, ``setup_split``, ``checks``).  The kept transitions
    (``Check``) are appended to ``keep`` where given; ``split`` holds the set-up's parts timed before."""
    import numpy as np
    import torch

    from portbench import judge, spec
    from portbench.reference import precision
    from portbench.yardstick import ess as ess_mod
    from portbench.yardstick import trace as tr

    family = spec.family(cell)
    from riemannhamiltonianmontecarlo_tpu_torch.ops import _build
    from riemannhamiltonianmontecarlo_tpu_torch.parallel import graphs, runner

    traffic = cell.traffic
    split = dict(split or {})
    split["program_import_s"] = time.perf_counter() - t0 - sum(split.values())
    mark = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros((), device=device)
        torch.cuda.synchronize(device)
    split["cuda_context_s"] = time.perf_counter() - mark
    mark = time.perf_counter()
    if device.type == "cuda":
        _build.load_library()
        torch.cuda.synchronize(device)
    split["library_s"] = time.perf_counter() - mark
    mark = time.perf_counter()
    system = family.build(cell.config, traffic, seed, device)
    kernel, state = system.kernel, system.state
    chains = traffic["chains"]
    _sync(device)
    split["data_and_start_s"] = time.perf_counter() - mark

    capture = True if device.type == "cuda" else None
    gen = torch.Generator(device=device).manual_seed(spec.seed_of(seed, "chains"))

    def segment(s, n: int):
        return runner.run(kernel, gen, None, init_state=s, num_samples=n, capture=capture)

    mark = time.perf_counter()
    state = runner.run(kernel, gen, None, init_state=state, num_samples=0, burn_in=traffic["burn_in"],
                       collect=False, capture=capture).final_state
    _sync(device)
    split["burn_in_s"] = time.perf_counter() - mark
    entry = graphs.lookup(kernel.step, None, state)
    capture_s = entry.capture_s if entry is not None else None
    split["capture_s"] = capture_s
    mark = time.perf_counter()
    for n in (traffic["segment_steps"], 1):  # every segment length of the window, once
        state = segment(state, n).final_state
    _sync(device)
    split["warm_up_s"] = time.perf_counter() - mark
    setup_s = time.perf_counter() - t0
    captures = graphs.capture_count()

    rng = np.random.default_rng(spec.seed_of(seed, "checks"))
    check_at = sorted(rng.uniform(0.05, 0.9, size=CHECKS) * seconds)
    held, segs, accept, steps, queued = [], [], torch.zeros((), dtype=torch.float64, device=device), 0, deque()
    kept_bytes = 0
    card, card_thread = {}, None
    if trace and device.type == "cuda":
        card_thread = threading.Timer(0.5 * seconds, lambda: card.update(_card_reading()))
    start = time.perf_counter()
    if card_thread is not None:
        card_thread.start()
    while (now := time.perf_counter() - start) < seconds:
        if len(held) < len(check_at) and now >= check_at[len(held)]:
            gen_state = gen.get_state()
            res = segment(state, 1)
            held.append((state, gen_state, res.final_state))
        else:
            res = segment(state, traffic["segment_steps"])
        state = res.final_state
        n = res.samples.shape[1]
        sample = res.samples
        if kept_bytes + sample.numel() * sample.element_size() > DEVICE_SAMPLE_BYTES and device.type == "cuda":
            sample = _to_host(sample)
        else:
            kept_bytes += sample.numel() * sample.element_size()
        segs.append(sample)
        accept += res.accept_rate.to(torch.float64) * n
        steps += n
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            queued.append(ev)
            if len(queued) > IN_FLIGHT:
                queued.popleft().synchronize()
    _sync(device)
    window_s = time.perf_counter() - start
    if card_thread is not None:
        card_thread.join()
    if graphs.capture_count() != captures:
        raise RuntimeError("a CUDA graph was captured inside the window")
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        traced_steps, seg = 0, traffic["segment_steps"]
        with profile(activities=activities) as prof:
            for _ in range(TRACE_WARM_SEGMENTS):
                state = segment(state, seg).final_state
            _sync(device)
            with record_function(TRACED_RANGE):
                mark = time.perf_counter()
                while traced_steps == 0 or time.perf_counter() - mark < TRACE_SECONDS:
                    state = segment(state, seg).final_state
                    traced_steps += seg
                _sync(device)
                traced_s = time.perf_counter() - mark
        traced = tr.from_events(prof.events(), traced_steps, traced_s, since=TRACED_RANGE)

    checks = [Check(system.plain(a), system.plain(b), system.noise(torch.Generator(device=device).set_state(g), a))
              for a, g, b in held]
    del held
    if keep is not None:
        keep.extend(checks)
    failed = int(sum(int((~torch.isfinite(s)).any(-1).sum()) for s in segs))
    coords = segs[0].shape[-1]

    def series(d: int):
        return lambda lo, hi: torch.cat([s[lo:hi, :, d].to(device) for s in segs], dim=1)

    ess = [float(ess_mod.total_ess(series(d), chains, steps, device)) for d in range(coords)]
    facts = Facts(system.shapes, setup_s, window_s, steps, chains, float(accept) / steps, ess, capture_s,
                  spec.step_ops(cell), traced)

    # The program is freed before the reference runs: the reference sets no memory peak and shares nothing.
    del system, kernel, state, res, segs, entry, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = family.reference(cell.config, traffic, precision.FLOAT64, device)
    readings = judge.readings(ref, checks, [c.after for c in checks])
    compared = {k: {"value": readings.get(k, float("nan")), "limit": lim} for k, lim in cell.limits.items()}
    correct = (bool(checks) and failed == 0 and set(readings) == set(cell.limits)
               and all(v["value"] <= v["limit"] for v in compared.values()))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(cell, m["name"]).read(facts)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": correct, "attempted": chains * steps, "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = tr.busy_us(traced.ops) / 1e6
        dev["window_s"] = traced.window_s
        out["breakdown"] = tr.breakdown(traced)
    out["setup_split"] = split
    out["window"] = {"seconds": window_s, "steps": steps, "checks": len(checks), "ess": ess,
                     "accept_rate": facts.accept_rate}
    if card:
        out["card"] = card
    out["checks"] = compared
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    pin_caches(CHECKOUT)

    import torch

    from portbench import spec

    split = {"torch_import_s": time.perf_counter() - _T0}
    bench = spec.load_json(CHECKOUT / "BENCHMARK.json")
    cell = spec.resolve(bench, args.workload)
    mark = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    split["cuda_query_s"] = time.perf_counter() - mark
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), _T0, split=split)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the run loaded {loaded}; the benchmark measures the PyTorch port alone", file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
