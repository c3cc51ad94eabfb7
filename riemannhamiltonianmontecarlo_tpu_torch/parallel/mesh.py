"""A mesh of named axes over the ranks of a ``torch.distributed`` job.

Port of ``riemannhamiltonianmontecarlo_tpu/parallel/mesh.py``.  The
framework's data-parallel axis is the *chain* axis (SURVEY.md section 2.4):
thousands of chains per device, split over ranks along ``"chains"``.  All
kernel math is batched over the leading chain axis, so a rank advances its
own chains with no communication; collectives appear only where a model is
split along another axis (BLR rows over ``"data"``, the LGC operators over
``"latent"``) and in the reductions of adaptation and diagnostics.

Two things JAX gives for free are explicit here:

* **the process groups.**  ``make_mesh`` lays the ranks of the default
  process group out row-major over ``shape`` and makes one group per line
  of each axis; a rank keeps the group of its own line.  (The port's own
  small class rather than ``torch.distributed.device_mesh.DeviceMesh``:
  the layer needs only the groups, on CPU and CUDA tensors alike, and
  ``DeviceMesh`` binds one device type and its own initialization.)
* **layout-independent randomness.**  JAX's partitionable threefry makes
  the same seed give the same chains however the chain axis is split;
  Philox does not (a rank drawing (C/k, D) does not get rows of a (C, D)
  draw).  ``chain_sliced`` wraps a kernel so that every rank draws the
  noise of all chains from the shared generator and keeps its own rows;
  a transition that draws inside (Gibbs's GIG draw, Philox counters
  indexed by the global element) draws every chain's noise too.

A split step makes no collective, so the runner replays it as a CUDA graph
wherever the kernel it splits is capturable, on any backend; a model split
along another axis is capturable where its group's collectives are
(``collectives.capturable``: NCCL).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import ChainRows, Kernel, tree_map

CHAIN_AXIS = "chains"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on named axes: each axis's size, the rank's index
    along it and the process group of the ranks that share its other
    coordinates.  An axis the mesh does not name has size 1 and no group."""

    axis_names: tuple[str, ...]
    sizes: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, Any]

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.sizes)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)


def initialize_distributed(*, device: str | torch.device = "cuda", backend: str | None = None, **kwargs) -> None:
    """``torch.distributed.init_process_group``, idempotent as the JAX one.

    Reads the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) unless ``kwargs``
    give ``init_method``, ``world_size``, ``rank`` (and ``timeout``).  The
    backend is NCCL for a CUDA ``device`` and Gloo for the CPU unless named;
    Gloo on CUDA tensors serves ranks that share one card.  On CUDA the
    rank's card becomes the current device.  A second call is a no-op; a
    real failure (no address, a rank mismatch, no card) raises.
    """
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda') but torch.cuda.is_available() is False")
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), **kwargs)


def make_mesh(num_ranks: int | None = None, axis_names: tuple[str, ...] = (CHAIN_AXIS,),
              shape: tuple[int, ...] | None = None) -> Mesh:
    """A mesh over every rank of the default process group.

    ``shape`` (default: all ranks on the one axis) lays the ranks out
    row-major.  Every rank must call this, with the same arguments: each
    group is made by all ranks (``torch.distributed.new_group``).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if num_ranks is None else num_ranks
    if n != world:
        raise ValueError(f"the mesh covers every rank: num_ranks {n} != world size {world}")
    shape = (n,) if shape is None else tuple(shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does not hold {n} ranks")
    grid = np.arange(n).reshape(shape)
    coords = {name: int(i) for name, i in zip(axis_names, np.unravel_index(rank, shape))}
    groups = {}
    for a, name in enumerate(axis_names):
        for line in np.moveaxis(grid, a, -1).reshape(-1, shape[a]).tolist():
            group = dist.new_group(line)
            if rank in line:
                groups[name] = group
    return Mesh(tuple(axis_names), dict(zip(axis_names, shape)), coords, groups)


def chain_slice(mesh: Mesh, num_chains: int) -> tuple[int, int]:
    """(lo, hi): this rank's rows of a ``num_chains`` chain axis."""
    k = mesh.size(CHAIN_AXIS)
    if num_chains % k:
        raise ValueError(f"{num_chains} chains do not split evenly over {k} ranks of the '{CHAIN_AXIS}' axis")
    per = num_chains // k
    lo = mesh.index(CHAIN_AXIS) * per
    return lo, lo + per


def shard_chains(mesh: Mesh, tree):
    """This rank's rows of every leaf of ``tree`` with a leading (chain) axis."""

    def local(x: Tensor) -> Tensor:
        if x.ndim == 0:
            return x
        lo, hi = chain_slice(mesh, x.shape[0])
        return x[lo:hi]

    return tree_map(local, tree)


def _sampler_name(kernel: Kernel) -> str:
    fn = kernel.draw_noise or kernel.step
    return fn.__module__.rsplit(".", 1)[-1]


def _map_leaves(fn, tree, *rest):
    """``tree_map`` that also hands ``fn`` the leaves that are not tensors
    (an object a transition draws from, ``ops.gig.GigDraws``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map_leaves(fn, *leaves) for leaves in zip(tree, *rest, strict=True)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def _global_view(tree, chains: int, total: int, name: str, device=None):
    """Zero-stride views of ``tree``'s leaves with ``total`` rows in place of
    the ``chains`` of their leading axis (0-dim leaves as they are), on
    ``device`` (default: each leaf's own)."""

    def view(x: Tensor) -> Tensor:
        if x.ndim == 0:
            return x if device is None else torch.empty((), dtype=x.dtype, device=device)
        if x.shape[0] != chains:
            raise ValueError(f"{name}: a state leaf of shape {tuple(x.shape)} does not lead with the {chains} chains")
        return torch.empty((), dtype=x.dtype, device=device or x.device).expand(total, *x.shape[1:])

    return tree_map(view, tree)


def _noise_chain_axes(kernel: Kernel, name: str, arg):
    """The chain axis of every noise leaf: the one axis whose length follows
    the chain count, probed by drawing at 2 and 3 chains on the CPU (None
    for a leaf that splits itself, ``split_chains``).  A leaf that is
    neither, or has no such axis, cannot be split over chains: it raises."""
    c = arg.shape[0] if isinstance(arg, Tensor) else arg.position.shape[0]
    probe = [kernel.draw_noise(torch.Generator().manual_seed(0), _global_view(arg, c, n, name, "cpu")) for n in (2, 3)]

    def axis(a, b):
        if not isinstance(a, Tensor):
            if hasattr(a, "split_chains"):
                return None
            raise ValueError(f"{name}: its noise holds a leaf that is not a tensor ({type(a).__name__}): "
                             "it cannot be split over chains")
        moved = [ax for ax, (m, n) in enumerate(zip(a.shape, b.shape)) if m != n]
        if a.ndim != b.ndim or len(moved) != 1 or (a.shape[moved[0]], b.shape[moved[0]]) != (2, 3):
            raise ValueError(f"{name}: a noise leaf of shape {tuple(a.shape)} at 2 chains and {tuple(b.shape)} at 3 "
                             "has no chain axis: it cannot be split over chains")
        return moved[0]

    return _map_leaves(axis, *probe)


def chain_sliced(kernel: Kernel, mesh: Mesh) -> Kernel:
    """``kernel`` with a step that advances this rank's rows of the chains.

    Each step draws the noise of all chains, ``draw_noise`` on a zero-stride
    view of the local position (or state, ``Kernel.noise_from_state``) with
    C_global rows (the noise reads only shapes, dtypes and the device),
    keeps rows lo:hi of every leaf along its chain axis (probed once per
    state shape: AMH's and the Gibbs sweep's noise are coordinate-major) and
    calls the pure ``transition``.  A leaf that draws inside the transition
    (Gibbs's GIG draw) is given this rank's ``ChainRows``.  Every rank
    draws from the same generator, so the same seed gives the same chains
    however the chain axis is split.  A kernel without ``transition`` and
    ``draw_noise``, or whose noise holds a leaf with no chain axis, raises,
    naming the sampler.  The returned kernel has no ``draw_noise``: it is
    not split again.

    The split step makes no collective, so it is capturable where
    ``kernel`` is.  The probe draws on the CPU: it runs at the first step of
    a state shape, which under ``parallel.graphs`` is an eager warm-up step,
    and raises inside a capture.  The step carries ``sliced = (kernel.step,
    mesh)``: ``parallel.graphs`` keys a split step's graph by these, so the
    wraps that each ``run`` makes of one kernel on one mesh replay one graph.
    """
    name = _sampler_name(kernel)
    if kernel.transition is None or kernel.draw_noise is None:
        raise ValueError(f"{name}: the kernel has no pure transition and draw_noise: it cannot be split over chains")
    k, i = mesh.size(CHAIN_AXIS), mesh.index(CHAIN_AXIS)
    group = mesh.group(CHAIN_AXIS)
    axes_by_shape: dict[tuple, Any] = {}

    def step(generator: torch.Generator, state):
        arg = state if kernel.noise_from_state else state.position
        c = state.position.shape[0]
        shapes = tuple(tuple(x.shape) for x in _leaves(arg))
        if shapes not in axes_by_shape:
            if state.position.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{name}: the chain-axis probe of a new state shape is inside a CUDA graph "
                                   "capture: it must run at an eager step first")
            axes_by_shape[shapes] = _noise_chain_axes(kernel, name, arg)
        rows = ChainRows(i * c, (i + 1) * c, c * k, group)
        noise = kernel.draw_noise(generator, _global_view(arg, c, c * k, name))

        def take(leaf, axis):
            return leaf.split_chains(rows) if axis is None else leaf.narrow(axis, rows.lo, c)

        return kernel.transition(state, _map_leaves(take, noise, axes_by_shape[shapes]))

    step.sliced = (kernel.step, mesh)
    return Kernel(kernel.init, step, kernel.transition, capturable=kernel.capturable, after_step=kernel.after_step)


def _leaves(tree) -> list[Tensor]:
    out: list[Tensor] = []
    tree_map(out.append, tree)
    return out
