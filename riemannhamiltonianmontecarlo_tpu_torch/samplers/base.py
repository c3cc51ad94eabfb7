"""Transition-kernel interface.

Port of ``riemannhamiltonianmontecarlo_tpu/samplers/base.py``.  A sampler is
a set of plain functions on *batched* chain states (leading chain axis C):

* ``init(position) -> State``                  position: (C, D)
* ``step(generator, state) -> (State, Info)``  draws its noise from the
  ``torch.Generator`` (on the chains' device) and calls
* ``transition(state, noise) -> (State, Info)``, the pure part: the same
  state and noise always give the same result, so a test can feed it the
  JAX package's draws;
* ``draw_noise(generator, position) -> Noise``, where the noise is a
  function of the position's shape, dtype and device alone: the parallel
  layer draws the noise of every chain and keeps its own rows
  (``parallel.mesh.chain_sliced``).  Samplers whose noise depends on more
  of the state (Gibbs, the two-block samplers) leave it None.

Divergence policy as in the JAX package: a non-finite proposal rejects that
chain's move and sets ``Info.divergent`` without disturbing the rest.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch import Tensor


class Info(NamedTuple):
    """Per-step, per-chain diagnostics emitted by every kernel.

    A coordinate-sweep kernel (component-wise Metropolis) reports at sweep
    level: ``accept_prob`` is the mean over the sweep's proposals and
    ``accepted`` the float fraction of them taken.  Single-proposal kernels
    give a bool ``accepted``.
    """

    accept_prob: Tensor  # (C,) min(1, exp(ratio)), 0 where divergent (sweep mean for AMH)
    accepted: Tensor  # (C,) bool; float fraction of the sweep's moves for AMH
    divergent: Tensor  # (C,) bool: a proposal was masked to a rejection


class Kernel(NamedTuple):
    init: Callable[[Tensor], Any]
    step: Callable[[torch.Generator, Any], tuple[Any, Info]]
    transition: Callable[[Any, Any], tuple[Any, Info]] | None = None
    draw_noise: Callable[[torch.Generator, Tensor], Any] | None = None


def metropolis_accept(u: Tensor, ratio: Tensor, divergent: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Vectorized MH accept step given the caller's u ~ U[0, 1).

    ``ratio > log u`` (the reference's ``Ratio > 0 or Ratio > log(rand)``,
    ``code/hmc.py:77``); u = 0 gives log u = -inf and accepts any finite
    ratio.  Non-finite ratios and divergent proposals always reject.
    """
    ok = torch.isfinite(ratio)
    if divergent is not None:
        ok = ok & ~divergent
    accept = ok & (ratio > torch.log(u))
    accept_prob = torch.where(ok, torch.exp(torch.clamp(ratio, max=0.0)), 0.0)
    return accept, accept_prob


class LatentResult(NamedTuple):
    """One MH update of a latent block (the two-block samplers)."""

    x: Tensor  # (C, T) after the MH test
    accepted: Tensor  # (C,) bool
    accept_prob: Tensor  # (C,)
    divergent: Tensor  # (C,) bool


def finish_latent(x: Tensor, x_new: Tensor, ratio: Tensor, u_acc: Tensor) -> LatentResult:
    """The MH test of a latent block's proposal ``x_new``; a non-finite ratio or proposal is a divergent reject."""
    divergent = ~(torch.isfinite(ratio) & torch.isfinite(x_new).all(dim=-1))
    accept, accept_prob = metropolis_accept(u_acc, ratio, divergent)
    return LatentResult(torch.where(accept[:, None], x_new, x), accept, accept_prob, divergent)


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the tensor leaves of matching trees.

    Trees are tensors, None, (named) tuples, lists and dicts of trees.
    """
    if tree is None:
        return None
    if isinstance(tree, Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, *leaves) for leaves in zip(tree, *rest, strict=True)]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def tree_where(cond: Tensor, tree_true, tree_false):
    """Select between two trees per chain (cond broadcast on the leading axis)."""

    def sel(a: Tensor, b: Tensor) -> Tensor:
        c = cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim))
        return torch.where(c, a, b)

    return tree_map(sel, tree_true, tree_false)
