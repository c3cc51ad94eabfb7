"""Chain runner: warmup + sampling loops over a batch of chains.

Port of ``run`` from ``riemannhamiltonianmontecarlo_tpu/parallel/runner.py``.
The JAX package's jitted ``lax.scan`` becomes a Python loop over steps, run
under ``torch.inference_mode()``: samples go into one preallocated
(S, C, D) tensor on the chains' device, and the acceptance and divergence
sums stay on the device (no host sync per step).  The burn-in / sampling
split mirrors the reference convention of timing only the post-burn-in
phase (``code/hmc.py:92-96``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Kernel, tree_map


@dataclasses.dataclass
class RunResult:
    samples: Any  # (C, S, D) post-burn-in positions (thinned), or None
    final_state: Any
    accept_rate: Tensor  # () mean accept probability over the sampling phase
    divergences: Tensor  # () total divergent transitions in the sampling phase
    warmup_accept_rate: Tensor  # () mean accept probability during warmup


def _position_of(state) -> Tensor:
    return state.position


def _scan_phase(step, generator: torch.Generator, state, num_steps: int, collect: bool, collect_fn=None):
    """Advance ``num_steps`` steps; returns (state, outputs (S, ...) or None, accept, divergences)."""
    fn = collect_fn or _position_of
    device = state.position.device
    accept_sum = torch.zeros((), device=device)
    div_sum = torch.zeros((), dtype=torch.int64, device=device)
    out = None
    if collect and num_steps > 0:
        out = tree_map(lambda x: x.new_empty((num_steps, *x.shape)), fn(state))
    for i in range(num_steps):
        state, info = step(generator, state)
        if out is not None:
            tree_map(lambda buf, x: buf[i].copy_(x), out, fn(state))
        accept_sum += info.accept_prob.mean()
        div_sum += info.divergent.sum()
    return state, out, accept_sum / max(num_steps, 1), div_sum


def run(
    kernel: Kernel,
    generator: torch.Generator,
    init_position: Tensor | None,
    *,
    num_samples: int,
    burn_in: int = 0,
    thin: int = 1,
    collect: bool = True,
    warmup_kernel: Kernel | None = None,
    init_state=None,
    collect_fn=None,
) -> RunResult:
    """Run ``burn_in`` warmup steps then collect ``num_samples`` samples.

    init_position: (C, D).  Returns samples as (C, num_samples // thin, D).
    ``warmup_kernel`` (same state type) replaces ``kernel`` during burn-in.
    ``collect_fn`` maps the kernel state to the tree of tensors recorded
    each step (default: ``state.position``).  ``init_state`` continues from
    a previous run's ``final_state`` (``init_position`` is then ignored).
    All randomness comes from ``generator``, which lives on the chains'
    device.
    """
    with torch.inference_mode():
        state = init_state if init_state is not None else (warmup_kernel or kernel).init(init_position)

        warm_accept = torch.zeros((), device=state.position.device)
        if burn_in > 0:
            warm_step = (warmup_kernel or kernel).step
            state, _, warm_accept, _ = _scan_phase(warm_step, generator, state, burn_in, False)

        state, positions, accept, div = _scan_phase(
            kernel.step, generator, state, num_samples, collect, collect_fn
        )
        samples = None
        if positions is not None:
            # (S, C, D) -> (C, S, D); thinning keeps every thin-th sample.
            samples = tree_map(lambda s: s.movedim(0, 1)[:, thin - 1 :: thin], positions)

    return RunResult(
        samples=samples,
        final_state=state,
        accept_rate=accept,
        divergences=div,
        warmup_accept_rate=warm_accept,
    )
