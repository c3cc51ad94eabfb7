"""Diagnostics: ESS (reference-compatible Geyer estimator), split R-hat, Geweke."""

from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.ess import (
    autocorrelation,
    ess_geyer,
    ess_geyer_device,
    ess_multichain,
    nextpow2,
)
from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.geweke import geweke_z
from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.rhat import split_rhat, split_rhat_device

__all__ = [
    "autocorrelation",
    "ess_geyer",
    "ess_geyer_device",
    "ess_multichain",
    "nextpow2",
    "geweke_z",
    "split_rhat",
    "split_rhat_device",
]
