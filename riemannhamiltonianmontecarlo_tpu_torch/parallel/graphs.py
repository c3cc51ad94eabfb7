"""The chain runner's step captured as a CUDA graph.

The port's counterpart of the JAX runner's ``jax.jit(lax.scan(step))``
(``riemannhamiltonianmontecarlo_tpu/parallel/runner.py:45-59``): on a CUDA
device ``parallel.run`` advances the chains by replaying one captured step
instead of launching every op of every step from the host.

A ``StepGraph`` holds static buffers shaped like the kernel's state and the
graph of ``body``: one step from the static state, the step's collected
tree written into a static slot, the accept and divergence sums added to
static scalars, and the new state written back into the static state.
``scan`` copies a state in, replays the graph once a step (copying the slot
into the samples after each replay) and returns copies, so a later replay
never overwrites what a caller holds.

Randomness: the step draws from the entry's own generator, registered with
the graph.  ``scan`` sets it to the caller's generator's state before the
replays and hands the advanced state back after them, so each replay draws
what the eager step draws at that point of the caller's stream, and one
graph serves every generator (``run_checkpointed``'s segment generators
included).

Capture (``StepGraph.capture``, CUDA only) first runs a few eager steps on a
clone of the state, on a side stream and with a throwaway generator, so that
the kernels' libraries are built and cuBLAS / cuSOLVER and the allocator
are initialised before capture; the chains and the caller's generator are
not touched.  A capture that fails raises: there is no fallback.

Launch counts: a kernel's wrapper adds one to its device counter
(``ops.launches``) on the stream it launches on, so the capture records that
addition beside the kernel and every replay counts its launches on the
device; the warm-up's launches are not counted (``launches.paused``) and
the capture itself executes nothing.

Host work between steps (``Kernel.after_step``: the monitor's count and
prints) is not in the graph: ``scan`` runs it after each replay on the
static state, which it may zero in place or whose host leaves it may
replace; a leaf that the step passes through (the monitor's host step
count) is left out of the graph by the write-back.

``step_graph`` caches entries by the step function (weakly: an entry dies
with its kernel), the collect function and the state's structure, shapes,
dtypes and device, as the JAX package's jit cache does; a kernel rebuilt
with another step size is another step function, so another entry.  A
chain-split step (``mesh.chain_sliced``) is keyed by the step it splits and
its mesh, so the wrap each ``run`` makes replays the first wrap's graph.

Runs with a mesh.  A chain-split step makes no collective and is captured on
any backend.  A step that all-reduces inside (a model split over ``"data"``
or ``"latent"``, the adaptive kernel's pooled acceptance) is captured where
its groups are NCCL's (``collectives.capturable``): the all-reduces are
recorded with the step's kernels, on NCCL's stream joined to the capture's
by events, and their device counter beside them.  The warm-up steps run
before the capture, so they create the NCCL communicators and the counter
outside it.  The runner is SPMD, so every rank of a group reaches the same
capture at the same step, and replays its graph as often as the others do;
the end-of-phase reductions (``runner.run``'s acceptance and divergences)
stay eager collectives on the same communicators, after the replays.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.ops import launches
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Kernel, tree_map

WARMUP_STEPS = 2  # eager steps on a clone before capture
_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # step -> {(mesh, fn, signature): StepGraph}
_CAPTURES = [0]


def capture_count() -> int:
    """Captures made in this process (a timed region checks it made none)."""
    return _CAPTURES[0]


def wants_capture(kernel: Kernel, device: torch.device, capture: bool | None) -> bool:
    """Whether a phase of ``kernel`` on ``device`` replays a graph.

    ``capture=None`` follows the kernel's declaration on a CUDA device and
    is eager elsewhere; ``True`` raises where a graph cannot be made.
    """
    if capture is None:
        return device.type == "cuda" and kernel.capturable
    if capture:
        if device.type != "cuda":
            raise ValueError(f"capture=True needs the chains on a CUDA device, got {device}")
        if not kernel.capturable:
            raise ValueError("capture=True: the kernel declares that its step cannot be captured (Kernel.capturable)")
    return bool(capture)


def position_of(state) -> Tensor:
    """The runner's default collect function."""
    return state.position


def _leaves(tree) -> list[Tensor]:
    out: list[Tensor] = []
    tree_map(out.append, tree)
    return out


def _signature(tree):
    """The tree's structure with each leaf's shape, dtype and device."""
    if tree is None or isinstance(tree, Tensor):
        return None if tree is None else (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return dict, tuple((k, _signature(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple(_signature(t) for t in tree)
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def _write_back(static, new) -> None:
    """static <- new, leaf by leaf.  A leaf the step passed through is the
    static buffer itself and stays; a leaf that shares another static
    buffer's memory is copied before any buffer is written."""
    statics, news = _leaves(static), _leaves(new)
    storages = {s.untyped_storage().data_ptr() for s in statics}
    pending = []
    for s, n in zip(statics, news, strict=True):
        if n is s:
            continue
        if n.untyped_storage().data_ptr() in storages:
            n = n.clone()
        pending.append((s, n))
    for s, n in pending:
        s.copy_(n)


class StepGraph:
    """One kernel step on static buffers: ``body`` is what the graph holds.

    Built from a template state (copied in).  Until ``capture`` succeeds,
    ``scan`` runs ``body`` eagerly, which is how the CPU tests hold the
    graph's function against the runner's eager loop; ``step_graph`` never
    returns an entry that was not captured.
    """

    def __init__(self, step: Callable, fn: Callable, state):
        self.device = state.position.device
        self.state = tree_map(torch.clone, state)
        self.slot = tree_map(torch.empty_like, fn(state))
        self.accept_sum = torch.zeros((), device=self.device)
        self.div_sum = torch.zeros((), dtype=torch.int64, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.capture_s: float | None = None
        self.pool_bytes: int | None = None  # device memory reserved by the capture (its pool)
        self._step, self._fn = step, fn
        self._advance = self.body

    def body(self) -> None:
        """static state -> step -> slot, sums -> static state."""
        new, info = self._step(self.generator, self.state)
        tree_map(Tensor.copy_, self.slot, self._fn(new))
        self.accept_sum += info.accept_prob.mean()
        self.div_sum += info.divergent.sum()
        _write_back(self.state, new)

    def capture(self) -> None:
        """Warm up on a clone, then record ``body`` into a CUDA graph (raises on failure)."""
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {self.device}")
        with torch.cuda.device(self.device):
            t0 = time.perf_counter()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with launches.paused(), torch.cuda.stream(side):
                self._warm_up(WARMUP_STEPS)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            with torch.cuda.graph(graph, stream=side):
                self.body()
            torch.cuda.synchronize()
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
            self.capture_s = time.perf_counter() - t0
        self._advance = graph.replay  # holds the graph
        self._step = self._fn = None  # the graph holds the step's work; the entry must not keep the kernel alive
        _CAPTURES[0] += 1

    def _warm_up(self, steps: int) -> None:
        """Eager steps on a clone of the state with a throwaway generator."""
        scratch, scratch_gen = tree_map(torch.clone, self.state), torch.Generator(device=self.device)
        for _ in range(steps):
            scratch, info = self._step(scratch_gen, scratch)
            self._fn(scratch), info.accept_prob.mean(), info.divergent.sum()
            if _signature(scratch) != _signature(self.state):
                raise ValueError("a captured step must return a state of the structure, shapes and dtypes it was "
                                 f"given: got {_signature(scratch)} from {_signature(self.state)}")

    def scan(self, generator: torch.Generator, state, num_steps: int, collect: bool, after_step=None):
        """``num_steps`` steps from ``state``, as ``runner._scan_phase``:
        (state, outputs (S, ...) or None, mean accept, divergences), all new
        tensors.  ``after_step`` (``Kernel.after_step``, or None) runs on the
        host after each replay, on the static state, as the eager loop runs
        it after each step."""
        tree_map(Tensor.copy_, self.state, state)
        self.accept_sum.zero_()
        self.div_sum.zero_()
        out = None
        if collect:
            out = tree_map(lambda x: x.new_empty((num_steps, *x.shape)), self.slot)
        self.generator.set_state(generator.get_state())
        for i in range(num_steps):
            self._advance()
            if after_step is not None:
                self.state = after_step(self.state)
            if out is not None:
                tree_map(lambda buf, x: buf[i].copy_(x), out, self.slot)
        generator.set_state(self.generator.get_state())
        final = tree_map(torch.clone, self.state)
        return final, out, self.accept_sum / max(num_steps, 1), self.div_sum.clone()


def _keys(step: Callable, fn: Callable | None, state) -> tuple[Callable, tuple]:
    """(the step that holds the entry weakly, the entry's key under it): a
    chain-split step's are the step it splits and, in the key, its mesh."""
    held, mesh = getattr(step, "sliced", (step, None))
    return held, (mesh, fn or position_of, _signature(state))


def lookup(step: Callable, fn: Callable | None, state) -> StepGraph | None:
    """The entry ``step_graph`` captured for these arguments, or None; never captures."""
    held, key = _keys(step, fn, state)
    return _GRAPHS.get(held, {}).get(key)


def step_graph(step: Callable, fn: Callable | None, state) -> StepGraph:
    """The captured entry for (``step``, ``fn``, the state's signature),
    captured on first use; ``fn`` None collects the position, as ``run`` does."""
    entry = lookup(step, fn, state)
    if entry is None:
        entry = StepGraph(step, fn or position_of, state)
        entry.capture()
        held, key = _keys(step, fn, state)
        _GRAPHS.setdefault(held, {})[key] = entry
    return entry
