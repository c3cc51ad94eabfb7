"""Utilities: chain initialization."""

from riemannhamiltonianmontecarlo_tpu_torch.utils.init import (
    default_init,
    jittered_init,
    map_estimate,
)

__all__ = ["default_init", "jittered_init", "map_estimate"]
