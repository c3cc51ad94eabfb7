"""Execution layer: the chain runner (plain and checkpointed) and step-size adaptation."""

from riemannhamiltonianmontecarlo_tpu_torch.parallel.adaptation import (
    AdaptationConfig,
    adaptive,
    frozen_step_size,
    run_adaptive,
)
from riemannhamiltonianmontecarlo_tpu_torch.parallel.runner import RunResult, run, run_checkpointed, segment_generator

__all__ = ["AdaptationConfig", "adaptive", "frozen_step_size", "run_adaptive", "RunResult", "run", "run_checkpointed",
           "segment_generator"]
