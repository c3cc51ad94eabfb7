"""Progress monitoring: windowed acceptance prints and a profiler trace.

Port of ``riemannhamiltonianmontecarlo_tpu/parallel/monitor.py``.  The
reference prints windowed acceptance rates every 50-1000 iterations and
resets the window (``code/hmc.py:85-89``, ``code/rmhmc.py:39-45``,
``StochVol_RMHMC.m:448-462``).  ``monitor`` does it as a kernel wrapper;
``profile_trace`` wraps a run in a ``torch.profiler`` session that writes
a Chrome trace.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Any, NamedTuple

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel


class MonitorState(NamedTuple):
    inner: Any
    accept_sum: Tensor  # () window sum of the per-step mean accept probability, on the chains' device
    divergence_sum: Tensor  # () window divergence count, on the chains' device
    step: Tensor  # () steps taken, a host (CPU) tensor: the print decision never waits for the device

    @property
    def position(self) -> Tensor:  # runner collection passthrough
        return self.inner.position


def monitor(kernel: Kernel, every: int = 50, label: str = "mcmc") -> Kernel:
    """Wrap a kernel to print windowed acceptance and divergences.

    The window's sums stay on the device; every ``every`` steps the wrapper
    prints ``[label] step s: window accept a, divergences d`` and resets
    them.  The print reads the device, so it is a host sync, the only one:
    CUDA-graph capture of the step loop (ROADMAP item 6b) must leave it
    outside the graph.  The wrapper keeps the inner kernel's ``transition``
    / ``draw_noise`` split, so the runner can split its chains; the window
    is then this rank's chains.
    """

    def init(position: Tensor) -> MonitorState:
        zero = torch.zeros((), device=position.device)
        return MonitorState(kernel.init(position), zero, torch.zeros((), dtype=torch.int64, device=position.device),
                            torch.zeros((), dtype=torch.int64))

    def finish(state: MonitorState, inner, info: Info) -> tuple[MonitorState, Info]:
        acc = state.accept_sum + info.accept_prob.mean()
        div = state.divergence_sum + info.divergent.sum()
        step_no = state.step + 1
        if int(step_no) % every == 0:
            print(f"[{label}] step {int(step_no)}: window accept {float(acc) / every:.3f}, divergences {int(div)}",
                  flush=True)
            acc, div = torch.zeros_like(acc), torch.zeros_like(div)
        return MonitorState(inner, acc, div, step_no), info

    def transition(state: MonitorState, noise) -> tuple[MonitorState, Info]:
        return finish(state, *kernel.transition(state.inner, noise))

    def step(generator: torch.Generator, state: MonitorState) -> tuple[MonitorState, Info]:
        return finish(state, *kernel.step(generator, state.inner))

    return Kernel(init, step, transition if kernel.transition else None, kernel.draw_noise)


@contextlib.contextmanager
def profile_trace(log_dir: str | Path):
    """torch.profiler session around a sampling run; writes ``<log_dir>/trace.json``
    (Chrome trace format: chrome://tracing or Perfetto) and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
