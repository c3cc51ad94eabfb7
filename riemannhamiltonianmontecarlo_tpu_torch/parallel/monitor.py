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
    step: Tensor  # () steps taken, a host (CPU) tensor that the step passes through and ``after_step`` advances

    @property
    def position(self) -> Tensor:  # runner collection passthrough
        return self.inner.position


def monitor(kernel: Kernel, every: int = 50, label: str = "mcmc") -> Kernel:
    """Wrap a kernel to print windowed acceptance and divergences.

    The step adds each step's mean accept probability and divergence count
    to the window's sums, which stay on the device, and does nothing else,
    so it is capturable where ``kernel`` is.  The count of steps and the
    print live on the host, in ``Kernel.after_step``, which the runner calls
    after every eager step and every replay of the step's CUDA graph: after
    every ``every``-th step of the state (counted across phases) it prints
    ``[label] step s: window accept a, divergences d`` and zeroes the sums.
    The print reads the device, one sync a window, the only one.  Eager and
    captured runs print the same lines; a graph's warm-up and its capture
    print nothing.  The wrapper keeps the inner kernel's ``transition`` /
    ``draw_noise`` split, so the runner can split its chains; the window is
    then this rank's chains.  Under a mesh it stays capturable where
    ``kernel`` is (the chain split keeps ``after_step``), and the count and
    prints stay host work between the replays.
    """

    def init(position: Tensor) -> MonitorState:
        zero = torch.zeros((), device=position.device)
        return MonitorState(kernel.init(position), zero, torch.zeros((), dtype=torch.int64, device=position.device),
                            torch.zeros((), dtype=torch.int64))

    def finish(state: MonitorState, inner, info: Info) -> tuple[MonitorState, Info]:
        acc = state.accept_sum + info.accept_prob.mean()
        div = state.divergence_sum + info.divergent.sum()
        return MonitorState(inner, acc, div, state.step), info

    def after_step(state: MonitorState) -> MonitorState:
        if kernel.after_step is not None:
            state = state._replace(inner=kernel.after_step(state.inner))
        step_no = state.step + 1
        if int(step_no) % every == 0:
            print(f"[{label}] step {int(step_no)}: window accept {float(state.accept_sum) / every:.3f}, "
                  f"divergences {int(state.divergence_sum)}", flush=True)
            state.accept_sum.zero_()
            state.divergence_sum.zero_()
        return state._replace(step=step_no)

    def transition(state: MonitorState, noise) -> tuple[MonitorState, Info]:
        return finish(state, *kernel.transition(state.inner, noise))

    def step(generator: torch.Generator, state: MonitorState) -> tuple[MonitorState, Info]:
        return finish(state, *kernel.step(generator, state.inner))

    draw_noise = kernel.draw_noise
    if kernel.noise_from_state and draw_noise is not None:
        def draw_noise(generator: torch.Generator, state: MonitorState):
            return kernel.draw_noise(generator, state.inner)

    return Kernel(init, step, transition if kernel.transition else None, draw_noise, kernel.noise_from_state,
                  capturable=kernel.capturable, after_step=after_step)


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
