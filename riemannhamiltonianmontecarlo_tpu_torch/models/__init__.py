"""Models: log-posteriors with gradients and Fisher-metric geometry."""

from riemannhamiltonianmontecarlo_tpu_torch.models import base, datasets, fhn, lgc, stochvol
from riemannhamiltonianmontecarlo_tpu_torch.models.base import FunctionModel, ManifoldModel, Model, autodiff_manifold
from riemannhamiltonianmontecarlo_tpu_torch.models.datasets import (
    Dataset,
    load_dataset,
    synthetic_logreg,
)
from riemannhamiltonianmontecarlo_tpu_torch.models.fhn import FHNModel
from riemannhamiltonianmontecarlo_tpu_torch.models.lgc import LGCJointModel, LGCModel
from riemannhamiltonianmontecarlo_tpu_torch.models.logreg import LogisticRegression, ManifoldState
from riemannhamiltonianmontecarlo_tpu_torch.models.stochvol import StochVolModel

__all__ = [
    "base",
    "datasets",
    "fhn",
    "lgc",
    "stochvol",
    "Model",
    "ManifoldModel",
    "FunctionModel",
    "autodiff_manifold",
    "LGCModel",
    "LGCJointModel",
    "StochVolModel",
    "FHNModel",
    "Dataset",
    "load_dataset",
    "synthetic_logreg",
    "LogisticRegression",
    "ManifoldState",
]
