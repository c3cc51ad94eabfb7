"""Execution layer: the chain runner and step-size adaptation."""

from riemannhamiltonianmontecarlo_tpu_torch.parallel.adaptation import (
    AdaptationConfig,
    adaptive,
    frozen_step_size,
    run_adaptive,
)
from riemannhamiltonianmontecarlo_tpu_torch.parallel.runner import RunResult, run

__all__ = ["AdaptationConfig", "adaptive", "frozen_step_size", "run_adaptive", "RunResult", "run"]
