"""Checkpoint / resume for chain states.

Port of ``riemannhamiltonianmontecarlo_tpu/utils/checkpoint.py``.  The
reference only dumps posterior samples at the end of a run
(``BLR_RMHMC.m:406``, ``ODE_RMHMC.m:550-556``) with no resume.  Here any
kernel-state tree (positions, cached geometry, adaptation state) round-trips
through a single ``.npz`` file, with an iteration counter and, optionally,
the state of a ``torch.Generator`` (the analog of the JAX PRNG key), so long
sampling runs can stop and resume bit-exactly.

A tree is what ``samplers.base.tree_map`` walks: tensors, None, (named)
tuples, lists and dicts of trees.  Restore needs a template tree with the
same structure (build the kernel state for the right shapes, then load into
it); each leaf comes back on its template leaf's device with its dtype.

In a ``torch.distributed`` job of more than one rank each rank writes and
reads its own shard file, ``<path>.p<rank>``, holding its local slice of
every leaf (its rows of the chain axis), as the JAX package writes one per
process: no rank gathers another's chains to checkpoint.  A job of one rank,
or no job, uses the bare path.  Periodic checkpointing of long runs is
``parallel.run_checkpointed``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import tree_map


def tree_leaves(tree) -> list[Tensor]:
    """The tensor leaves of a tree, in ``tree_map``'s order."""
    leaves: list[Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template tree holds")
    return tree


def _shard_path(path: str | Path) -> Path:
    """This rank's shard file; the bare path in a job of one rank."""
    path = Path(path)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return path.with_name(path.name + f".p{dist.get_rank()}")
    return path


def save_state(path: str | Path, state: Any, *, step: int = 0, generator: torch.Generator | None = None) -> None:
    """Serialize a kernel-state tree (+ iteration counter, generator state), atomically."""
    payload = {f"leaf_{i}": leaf.detach().cpu().numpy() for i, leaf in enumerate(tree_leaves(state))}
    payload["__step__"] = np.asarray(step, np.int64)
    if generator is not None:
        payload["__generator__"] = generator.get_state().numpy()
    path = _shard_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    tmp.replace(path)  # atomic publish


def checkpoint_exists(path: str | Path) -> bool:
    return _shard_path(path).exists()


def saved_step(path: str | Path) -> int:
    """The iteration counter of a saved state."""
    with np.load(_shard_path(path)) as data:
        return int(data["__step__"])


def load_leaves(path: str | Path) -> list[np.ndarray]:
    """The saved leaves as NumPy arrays, in order."""
    with np.load(_shard_path(path)) as data:
        n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
        return [data[f"leaf_{i}"] for i in range(n_leaves)]


def load_state(path: str | Path, like: Any):
    """Restore a state saved by :func:`save_state`.

    ``like`` is a template tree with the target structure, shapes, dtypes
    and devices.  Returns (state, step, generator_state_or_None); give the
    last to ``torch.Generator.set_state``.
    """
    with np.load(_shard_path(path)) as data:
        leaves = []
        for i, tmpl in enumerate(tree_leaves(like)):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != template {tuple(tmpl.shape)}")
            leaves.append(torch.from_numpy(arr).to(device=tmpl.device, dtype=tmpl.dtype))
        step = int(data["__step__"])
        gen_state = torch.from_numpy(data["__generator__"]) if "__generator__" in data else None
    return tree_unflatten(like, leaves), step, gen_state
