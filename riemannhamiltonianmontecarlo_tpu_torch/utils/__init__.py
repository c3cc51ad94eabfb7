"""Utilities: configuration presets, chain initialization, checkpoint / resume."""

from riemannhamiltonianmontecarlo_tpu_torch.utils import checkpoint
from riemannhamiltonianmontecarlo_tpu_torch.utils.config import (
    ExperimentConfig,
    reference_preset,
)
from riemannhamiltonianmontecarlo_tpu_torch.utils.init import (
    default_init,
    jittered_init,
    map_estimate,
)

__all__ = ["checkpoint", "ExperimentConfig", "reference_preset", "default_init", "jittered_init", "map_estimate"]
