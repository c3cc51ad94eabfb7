"""Chain runner: warmup + sampling loops over a batch of chains.

Port of ``run`` and ``run_checkpointed`` from
``riemannhamiltonianmontecarlo_tpu/parallel/runner.py``.
The JAX package's jitted ``lax.scan`` becomes, on a CUDA device, the replay
of a captured CUDA graph of one step (``parallel.graphs``), for every
kernel that declares its step capturable (``Kernel.capturable``), with a
mesh or without; elsewhere (the CPU, a kernel that cannot be captured) it
is a Python loop over steps (``_scan_phase``).  Either runs under
``torch.inference_mode()``: samples go into one preallocated (S, C, D)
tensor on the chains' device, and the acceptance and divergence sums stay
on the device (no host sync per step).  The two give the same chains from
the same generator.  The burn-in / sampling split mirrors the reference
convention of timing only the post-burn-in phase (``code/hmc.py:92-96``).

Sharding: pass a ``parallel.mesh.Mesh`` and the chains are split over its
``"chains"`` axis: each rank advances rows lo:hi of the global initial
position with the kernel's chain-sliced step (``mesh.chain_sliced``), so
the same seed gives the same chains however the axis is split, and keeps
its own (C_local, S, D) samples, as JAX keeps addressable shards.  The
acceptance and divergence figures are global (``collectives``), reduced
eagerly after each phase, outside the graph; a step itself communicates
only where the model is split along another axis.  A chain-split step is
captured on any backend (it makes no collective); a step that all-reduces
inside is captured where its groups are NCCL's and runs eagerly over Gloo,
as its kernel declares (``Kernel.capturable``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives, graphs
from riemannhamiltonianmontecarlo_tpu_torch.parallel.collectives import all_reduce, cross_chain_mean, cross_chain_sum
from riemannhamiltonianmontecarlo_tpu_torch.parallel.mesh import CHAIN_AXIS, Mesh, chain_sliced, shard_chains
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Kernel, tree_map


@dataclasses.dataclass
class RunResult:
    samples: Any  # (C, S, D) post-burn-in positions (thinned), or None
    final_state: Any
    accept_rate: Tensor  # () mean accept probability over the sampling phase
    divergences: Tensor  # () total divergent transitions in the sampling phase
    warmup_accept_rate: Tensor  # () mean accept probability during warmup


def _scan_phase(step, generator: torch.Generator, state, num_steps: int, collect: bool, collect_fn=None,
                after_step=None):
    """Advance ``num_steps`` steps, each followed by the host's ``after_step``
    (``Kernel.after_step``, or None); returns (state, outputs (S, ...) or
    None, accept, divergences)."""
    fn = collect_fn or graphs.position_of
    device = state.position.device
    accept_sum = torch.zeros((), device=device)
    div_sum = torch.zeros((), dtype=torch.int64, device=device)
    out = None
    if collect and num_steps > 0:
        out = tree_map(lambda x: x.new_empty((num_steps, *x.shape)), fn(state))
    for i in range(num_steps):
        state, info = step(generator, state)
        if after_step is not None:
            state = after_step(state)
        if out is not None:
            tree_map(lambda buf, x: buf[i].copy_(x), out, fn(state))
        accept_sum += info.accept_prob.mean()
        div_sum += info.divergent.sum()
    return state, out, accept_sum / max(num_steps, 1), div_sum


def _phase(kernel: Kernel, generator: torch.Generator, state, num_steps: int, collect: bool, collect_fn,
           graph: bool):
    """One phase: replayed from the step's CUDA graph where ``graph``, else ``_scan_phase``."""
    if graph and num_steps > 0:
        entry = graphs.step_graph(kernel.step, collect_fn, state)
        return entry.scan(generator, state, num_steps, collect, kernel.after_step)
    return _scan_phase(kernel.step, generator, state, num_steps, collect, collect_fn, kernel.after_step)


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
    mesh: Mesh | None = None,
    capture: bool | None = None,
) -> RunResult:
    """Run ``burn_in`` warmup steps then collect ``num_samples`` samples.

    init_position: (C, D).  Returns samples as (C, num_samples // thin, D).
    With a ``mesh`` whose chain axis has k > 1 ranks, ``init_position`` is
    the global (C, D) and the samples are this rank's (C / k, S, D);
    ``init_state`` is this rank's state.
    ``warmup_kernel`` (same state type) replaces ``kernel`` during burn-in.
    ``collect_fn`` maps the kernel state to the tree of tensors recorded
    each step (default: ``state.position``).  ``init_state`` continues from
    a previous run's ``final_state`` (``init_position`` is then ignored).
    All randomness comes from ``generator``, which lives on the chains'
    device.
    ``capture``: None replays a CUDA graph of each phase's step where the
    chains are on a CUDA device and the phase's kernel declares itself
    capturable, and runs the eager loop elsewhere; True requires the graph
    (raises on the CPU, or for a kernel that cannot be captured, naming the
    backends of the mesh's groups); False runs the eager loop.
    """
    if mesh is not None and capture:
        for k in (kernel, warmup_kernel or kernel):
            if not k.capturable:
                backends = {axis: collectives.backend(g) for axis, g in mesh.groups.items()}
                raise ValueError("capture=True: the kernel declares that its step cannot be captured "
                                 f"(Kernel.capturable); the mesh's groups run over {backends}, and a step's "
                                 "collectives are captured over NCCL only")
    device = (init_position if init_state is None else init_state.position).device
    graph = graphs.wants_capture(kernel, device, capture)
    warm_graph = burn_in > 0 and graphs.wants_capture(warmup_kernel or kernel, device, capture)
    group = None
    if mesh is not None:
        group = mesh.group(CHAIN_AXIS)
        if mesh.size(CHAIN_AXIS) > 1:
            kernel = chain_sliced(kernel, mesh)
            warmup_kernel = None if warmup_kernel is None else chain_sliced(warmup_kernel, mesh)
            if init_state is None:
                init_position = shard_chains(mesh, init_position)
    with torch.inference_mode():
        state = init_state if init_state is not None else (warmup_kernel or kernel).init(init_position)

        warm_accept = torch.zeros((), device=state.position.device)
        if burn_in > 0:
            # collect_fn as in sampling, so that one graph serves both phases of one kernel.
            state, _, warm_accept, _ = _phase(warmup_kernel or kernel, generator, state, burn_in, False, collect_fn,
                                              warm_graph)

        state, positions, accept, div = _phase(kernel, generator, state, num_samples, collect, collect_fn, graph)
        samples = None
        if positions is not None:
            # (S, C, D) -> (C, S, D); thinning keeps every thin-th sample.
            samples = tree_map(lambda s: s.movedim(0, 1)[:, thin - 1 :: thin], positions)
        if mesh is not None:
            # Global figures: the mean over ranks of each rank's per-step chain means.
            warm_accept, accept = (cross_chain_mean(a[None], group) for a in (warm_accept, accept))
            div = cross_chain_sum(div[None], group)

    return RunResult(
        samples=samples,
        final_state=state,
        accept_rate=accept,
        divergences=div,
        warmup_accept_rate=warm_accept,
    )


def segment_generator(seed: int, segment: int, device: torch.device | str) -> torch.Generator:
    """The generator of one segment of a segmented run, a function of
    (seed, segment) alone: the analog of ``jax.random.fold_in(key, segment)``.
    A run stopped after any segment and resumed draws what the run that was
    not stopped draws."""
    mixed = int(np.random.SeedSequence([seed, segment]).generate_state(1, dtype=np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed & (2**63 - 1))


def _agreed_segment(segment: int, device: torch.device) -> int:
    """The segment every rank resumes from (-1: none); ranks that disagree
    (a run killed between two ranks' saves) raise instead of resuming with
    different collectives."""
    both = all_reduce(torch.tensor([segment, -segment], dtype=torch.int64, device=device),
                      dist.group.WORLD, op=dist.ReduceOp.MAX)
    hi, lo = int(both[0]), -int(both[1])
    if hi != lo:
        raise RuntimeError(f"the ranks' checkpoints are at different segments ({lo} to {hi}): "
                           "remove them and start again")
    return hi


def run_checkpointed(
    kernel: Kernel,
    seed: int,
    init_position: Tensor,
    *,
    num_samples: int,
    checkpoint_path,
    burn_in: int = 0,
    checkpoint_every: int = 500,
    collect_fn=None,
    warmup_kernel: Kernel | None = None,
    mesh: Mesh | None = None,
    capture: bool | None = None,
    _stop_after_segments: int | None = None,
) -> RunResult:
    """``run`` in ``checkpoint_every``-step segments with resume.

    After each segment the kernel state is checkpointed atomically
    (``utils.checkpoint.save_state``) and the segment's samples are
    persisted to ``<checkpoint_path>.seg<i>``, so a killed run restarts from
    the last completed segment instead of step 0.  The burn-in (at least one
    step, by ``warmup_kernel`` where given) draws from
    ``segment_generator(seed, 0)`` and sampling segment i from
    ``segment_generator(seed, i + 1)``, on ``init_position``'s device, so an
    interrupted-and-resumed run is bit-identical to an uninterrupted one.
    ``capture`` as in ``run``: the segments replay one graph, whatever
    their generators.  ``_stop_after_segments`` simulates a crash (tests only).

    With a ``mesh`` the chains are split as in ``run``; when the job has more
    than one rank each file is the rank's own shard, ``<path>.p<rank>``
    holding its rows (``utils.checkpoint``), and the ranks resume from the
    same segment or raise.
    """
    from riemannhamiltonianmontecarlo_tpu_torch.utils import checkpoint as ckpt

    path = Path(checkpoint_path)
    device = init_position.device
    n_seg = -(-num_samples // checkpoint_every)
    sizes = [checkpoint_every] * (n_seg - 1)
    sizes.append(num_samples - checkpoint_every * (n_seg - 1))

    def seg_path(i: int) -> Path:
        return path.with_name(path.name + f".seg{i}")

    start_seg = -1
    if ckpt.checkpoint_exists(path):
        start_seg = ckpt.saved_step(path)
    if mesh is not None:
        start_seg = _agreed_segment(start_seg, device)
    if start_seg >= 0:
        local = init_position if mesh is None or mesh.size(CHAIN_AXIS) == 1 else shard_chains(mesh, init_position)
        with torch.inference_mode():
            template = (warmup_kernel or kernel).init(local)
        state, start_seg, _ = ckpt.load_state(path, template)
        warm_accept = torch.zeros((), device=device)
    else:
        warm = run(kernel, segment_generator(seed, 0, device), init_position, num_samples=0,
                   burn_in=max(burn_in, 1), collect=False, warmup_kernel=warmup_kernel, collect_fn=collect_fn,
                   mesh=mesh, capture=capture)
        state, start_seg, warm_accept = warm.final_state, 0, warm.warmup_accept_rate
        ckpt.save_state(path, state, step=0)

    accepts, divs = [], []
    for i in range(start_seg, n_seg):
        if _stop_after_segments is not None and i - start_seg >= _stop_after_segments:
            break
        res = run(kernel, segment_generator(seed, i + 1, device), None, num_samples=sizes[i],
                  init_state=state, collect_fn=collect_fn, mesh=mesh, capture=capture)
        state = res.final_state
        accepts.append(float(res.accept_rate) * sizes[i])
        divs.append(int(res.divergences))
        ckpt.save_state(seg_path(i), res.samples, step=i)
        ckpt.save_state(path, state, step=i + 1)

    # Reassemble all persisted segments (including pre-crash ones) in order,
    # stopping at the first gap.
    parts = []
    for i in range(n_seg):
        if not ckpt.checkpoint_exists(seg_path(i)):
            break
        parts.append(ckpt.load_leaves(seg_path(i)))
    samples = None
    if parts:
        merged = [torch.from_numpy(np.concatenate([p[j] for p in parts], axis=1)).to(device)
                  for j in range(len(parts[0]))]
        # The collect_fn tree's structure, from a probe of the final state.
        samples = ckpt.tree_unflatten((collect_fn or graphs.position_of)(state), merged)

    total = sum(sizes[start_seg : start_seg + len(accepts)]) or 1
    return RunResult(
        samples=samples,
        final_state=state,
        accept_rate=torch.tensor(sum(accepts) / total, device=device),
        divergences=torch.tensor(sum(divs), device=device),
        warmup_accept_rate=warm_accept,
    )
