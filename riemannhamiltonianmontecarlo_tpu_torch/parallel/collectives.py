"""Cross-rank reductions over the process groups of a mesh.

Port of ``riemannhamiltonianmontecarlo_tpu/parallel/collectives.py``.  Under
JAX's GSPMD a mean over a sharded chain axis lowers to the right collectives
by itself; in the port every collective is explicit and goes through this
module.  It issues only ``all_reduce``: with ``broadcast`` the one
collective that Gloo takes on CUDA tensors, so one code path serves NCCL on
the card, Gloo on the CPU and Gloo between ranks that share one card (NCCL
refuses two ranks on one GPU).  A gather is an all-reduce of a zero-filled
buffer of the full width, into which each rank writes its own columns:
adding zeros is exact, so the gathered values are bit for bit the ranks'.

A ``group`` of None means one process: the reductions are the local ones,
as in the JAX package with ``axis_name=None``.

Operators sharded by rows (``RowShards``, the LGC model's latent axis) meet
a whole-width activation in two patterns, both here:

* ``matmul(x, W)`` = x @ W: each rank multiplies its columns of x by its
  rows of W and the partial products are all-reduced;
* ``matmul_t(x, W)`` = x @ W^T: each rank computes its columns of the
  result, which are gathered.

With a plain tensor both are one ``torch.matmul``, so an unsharded caller
computes what it computed before.

Every all-reduce is counted (``call_counts`` / ``reset_call_counts``), so
a run can report collectives per transition.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch import Tensor

_COUNTS = {"all_reduce": 0}


def call_counts() -> dict[str, int]:
    """All-reduces issued since the last reset."""
    return dict(_COUNTS)


def reset_call_counts() -> None:
    _COUNTS["all_reduce"] = 0


def all_reduce(x: Tensor, group, op=dist.ReduceOp.SUM) -> Tensor:
    """Reduce ``x`` in place over ``group`` (None: no-op) and return it."""
    if group is not None:
        _COUNTS["all_reduce"] += 1
        dist.all_reduce(x, op=op, group=group)
    return x


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def cross_chain_sum(x: Tensor, group=None) -> Tensor:
    """Sum over the leading (chain) axis, across the ranks of ``group``."""
    return all_reduce(torch.sum(x, dim=0), group)


def cross_chain_mean(x: Tensor, group=None) -> Tensor:
    """Mean over the leading (chain) axis, across the ranks of ``group``.

    The divisor is the global chain count, the local count times the group's
    size: the chain axis is split evenly (``mesh.chain_slice``).
    """
    if group is None:
        return torch.mean(x, dim=0)
    return cross_chain_sum(x, group) / (x.shape[0] * group_size(group))


def gather_columns(cols: Tensor, lo: int, width: int, group) -> Tensor:
    """(..., hi - lo) columns lo:hi of each rank -> the whole (..., width)."""
    if group is None:  # one process: the columns are the whole width
        return cols
    out = cols.new_zeros((*cols.shape[:-1], width))
    out[..., lo : lo + cols.shape[-1]] = cols
    return all_reduce(out, group)


class RowShards(NamedTuple):
    """Rows lo:hi of a (D, D) operator, held by one rank of ``group``."""

    rows: Tensor  # (hi - lo, D)
    lo: int
    hi: int
    group: Any  # the process group of the sharded axis

    @classmethod
    def of(cls, full: Tensor, lo: int, hi: int, group) -> "RowShards":
        return cls(full[lo:hi].clone(), lo, hi, group)

    @property
    def dim(self) -> int:
        return self.rows.shape[-1]


def matmul(x: Tensor, w: Tensor | RowShards) -> Tensor:
    """x @ W for a whole (..., D) x and a plain or row-sharded W."""
    if isinstance(w, Tensor):
        return torch.matmul(x, w)
    return all_reduce(torch.matmul(x[..., w.lo : w.hi], w.rows), w.group)


def matmul_t(x: Tensor, w: Tensor | RowShards) -> Tensor:
    """x @ W^T for a whole (..., D) x and a plain or row-sharded W."""
    if isinstance(w, Tensor):
        return torch.matmul(x, w.T)
    return gather_columns(torch.matmul(x, w.rows.T), w.lo, w.dim, w.group)


def gather_rows(w: RowShards) -> Tensor:
    """The whole (D, D) operator on every rank (a one-time setup step)."""
    return gather_columns(w.rows.T, w.lo, w.dim, w.group).T.contiguous()
