"""Models: log-posteriors with gradients and Fisher-metric geometry."""

from riemannhamiltonianmontecarlo_tpu_torch.models import datasets
from riemannhamiltonianmontecarlo_tpu_torch.models.datasets import (
    Dataset,
    load_dataset,
    synthetic_logreg,
)
from riemannhamiltonianmontecarlo_tpu_torch.models.logreg import LogisticRegression, ManifoldState

__all__ = [
    "datasets",
    "Dataset",
    "load_dataset",
    "synthetic_logreg",
    "LogisticRegression",
    "ManifoldState",
]
