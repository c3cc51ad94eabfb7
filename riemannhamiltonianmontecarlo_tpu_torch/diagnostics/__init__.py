"""Diagnostics: ESS (reference-compatible Geyer estimator) and split R-hat."""

from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.ess import (
    autocorrelation,
    ess_geyer,
    ess_multichain,
    nextpow2,
)
from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.rhat import split_rhat

__all__ = ["autocorrelation", "ess_geyer", "ess_multichain", "nextpow2", "split_rhat"]
