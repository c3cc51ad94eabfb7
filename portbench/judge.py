"""How ``correct`` is decided: a chain's transition against the plain reference's, one block at a time.

The program's output for a block is its chains' states after a transition;
the reference (``reference/``, float64) works out the same transition again
from the state before it and the transition's draws.  Two numbers a block,
each the worst over the compared chains:

* ``<block>_err``: how far a chain's new state lies from where the reference
  puts it, |x - x_ref| / (1 + |x_ref|) by coordinate.  A chain that moved
  is held to the reference's proposal; a chain that stayed is held to its
  old state, which the sampler keeps bit for bit (0 then).
* ``<block>_gap``: by how much the program's Metropolis-Hastings decision
  contradicts the reference's log ratio: log u - ratio_ref where the program
  moved the chain, ratio_ref - log u where it kept it, 0 where they agree
  (infinite where the program moved a chain the reference finds divergent).
  A decision within the program's rounding of the boundary reads as a small
  gap; a decision the program got wrong reads as a large one.

A block's state after the transition feeds the next block, as the program
hands it on (StochVol's hyper block is judged at the program's latent state).
"""

from __future__ import annotations

import torch
from torch import Tensor

from portbench.reference.mcmc import Proposal


def mh_readings(x_in: Tensor, x_out: Tensor, prop: Proposal) -> tuple[float, float]:
    """(err, gap) of a block over its chains: x_in, x_out (C, D) the program's states before and after."""
    ref = prop.x.to(torch.float64)
    x_in = x_in.to(device=ref.device, dtype=torch.float64)
    x_out = x_out.to(device=ref.device, dtype=torch.float64)
    moved = (x_out != x_in).any(-1)
    expected = torch.where(moved[:, None], ref, x_in)
    err = torch.nan_to_num((x_out - expected).abs() / (1.0 + expected.abs()), nan=float("inf")).amax(-1)
    margin = (prop.ratio - prop.log_u).to(torch.float64)
    margin = torch.where(prop.divergent | ~torch.isfinite(margin), float("-inf"), margin)
    gap = torch.where(moved, torch.clamp(-margin, min=0.0), torch.clamp(margin, min=0.0))
    return float(err.max()), float(gap.max())


def control_output(x_in: Tensor, prop: Proposal) -> Tensor:
    """A control's state after a block: its proposal where its own decision moves the chain, else the state
    before, bit for bit (so that only what the control computed differs)."""
    return torch.where(prop.accept()[:, None].to(x_in.device), prop.x.to(device=x_in.device, dtype=x_in.dtype), x_in)


def readings(ref, checks, outputs) -> dict[str, float]:
    """Each block's ``_err`` and ``_gap``, the worst over ``checks`` (``run.Check``): the candidate's state after
    each check's step is ``outputs[i]`` (the program's, or a control's), judged against ``ref`` (a family's
    ``Reference``) following that state."""
    out: dict[str, float] = {}
    for c, after in zip(checks, outputs, strict=True):
        for name, key, prop in ref.sweep(c.before, c.noise, follow=after):
            err, gap = mh_readings(c.before[key], after[key], prop)
            out[f"{name}_err"] = max(out.get(f"{name}_err", 0.0), err)
            out[f"{name}_gap"] = max(out.get(f"{name}_gap", 0.0), gap)
    return out
