"""Chain initialization helpers.

Port of ``riemannhamiltonianmontecarlo_tpu/utils/init.py``: chains start at
a cheap MAP estimate plus per-chain jitter (w = 0 is a rejection trap at the
reference HMC constants; see the JAX module's docstring).
"""

from __future__ import annotations

import torch
from torch import Tensor


def map_estimate(model, w0: Tensor | None = None, num_steps: int = 500, lr: float = 0.01) -> Tensor:
    """Cheap MAP estimate of the log joint, on the model's device.

    Models exposing a Fisher ``metric`` get Newton/IWLS ascent
    ``w += G(w)^{-1} grad(w)`` (for BLR, G is exactly the Hessian of the
    negative log joint), at most 25 steps; others get gradient ascent with
    a fixed ``lr``, which is not safe for arbitrary curvature.
    """
    x = model.X
    w = torch.zeros(model.dim, dtype=x.dtype, device=x.device) if w0 is None else w0
    if hasattr(model, "metric"):
        for _ in range(min(num_steps, 25)):
            w = w + torch.linalg.solve(model.metric(w), model.grad(w))
        return w
    for _ in range(num_steps):
        w = w + lr * model.grad(w)
    return w


def jittered_init(generator: torch.Generator, center: Tensor, num_chains: int, scale: float = 0.1) -> Tensor:
    """(C, D) starting positions: center + scale * N(0, I) per chain."""
    noise = torch.randn(
        (num_chains, center.shape[-1]), generator=generator, dtype=center.dtype, device=center.device
    )
    return center[None, :] + scale * noise


def default_init(model, generator: torch.Generator, num_chains: int, *, scale: float = 0.1) -> Tensor:
    """MAP + jitter in one call."""
    return jittered_init(generator, map_estimate(model), num_chains, scale)
