"""Execution layer: the chain runner."""

from riemannhamiltonianmontecarlo_tpu_torch.parallel.runner import RunResult, run

__all__ = ["RunResult", "run"]
