"""What a ``torch.profiler`` trace of a window of steps says: the device's operations, its busy time, the
time of a kernel by name, and where the device sat idle.

Busy time is the union of the device operations' intervals, so operations that overlap count once.
"""

from __future__ import annotations

import re
from typing import NamedTuple


class Trace(NamedTuple):
    ops: list  # (name, start_us, end_us) of each device operation (kernels, copies, sets), by start
    host: list  # (name, start_us, end_us) of each host event
    steps: int  # chain steps (sweeps) the window made
    window_s: float  # the traced steps' length by the host's clock, from the sync before them to the one after


def from_events(events, steps: int, window_s: float, since: str | None = None) -> Trace:
    """A trace from ``prof.events()`` (``torch.autograd.profiler_util.FunctionEvent``).  With ``since``, the
    name of a ``record_function`` range, only what starts inside that range on the host's side and any device
    operation that starts after the range begins; the range's own events (its host span and the profiler's
    annotation of it on the device) are left out."""
    import torch

    lo, hi = float("-inf"), float("inf")
    if since is not None:
        spans = [e for e in events if e.name == since and e.device_type != torch.autograd.DeviceType.CUDA]
        if spans:
            lo, hi = float(spans[0].time_range.start), float(spans[0].time_range.end)
    ops, host = [], []
    for e in events:
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name == since or row[1] < lo:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append(row)
        elif row[1] <= hi:
            host.append(row)
    ops.sort(key=lambda r: r[1])
    return Trace(ops, host, steps, window_s)


def busy_us(ops) -> float:
    """The length of the union of the operations' intervals (``ops`` sorted by start)."""
    total, reach = 0.0, float("-inf")
    for _, start, end in ops:
        if end <= reach:
            continue
        total += end - max(start, reach)
        reach = end
    return total


def matching(ops, pattern: str) -> list:
    """The operations whose name matches ``pattern`` (a regular expression, searched)."""
    rx = re.compile(pattern)
    return [op for op in ops if rx.search(op[0])]


def time_us(ops) -> float:
    return sum(end - start for _, start, end in ops)


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """(start_us, end_us) of each stretch between device operations, from the first to the last."""
    gaps, reach = [], None
    for _, start, end in trace.ops:
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    return gaps


def _host_at(trace: Trace, t: float) -> str:
    """The innermost host event that spans time ``t``, or "host idle"."""
    best = None
    for name, start, end in trace.host:
        if start <= t <= end and (best is None or end - start < best[1]):
            best = (name, end - start)
    return best[0] if best else "host idle"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and the longest idle gaps named by what
    the host was doing in their middle, in seconds, at most ``top`` of each."""
    by_name: dict[str, float] = {}
    for name, start, end in trace.ops:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[name, us / 1e6] for name, us in device_ops],
            "idle_gaps": [[_host_at(trace, 0.5 * (a + b)), (b - a) / 1e6] for a, b in gaps]}
