"""Diagnostics: ESS (reference-compatible Geyer estimator; the native C++
engine in ``native``), split R-hat, Geweke; figures in ``plots`` (imported on
its own: it needs matplotlib)."""

from riemannhamiltonianmontecarlo_tpu_torch.diagnostics import native

from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.ess import (
    autocorrelation,
    ess_geyer,
    ess_geyer_device,
    ess_multichain,
    nextpow2,
)
from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.geweke import geweke_z
from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.native import ess_geyer_native
from riemannhamiltonianmontecarlo_tpu_torch.diagnostics.rhat import split_rhat, split_rhat_device

__all__ = [
    "autocorrelation",
    "ess_geyer",
    "ess_geyer_device",
    "ess_multichain",
    "nextpow2",
    "geweke_z",
    "ess_geyer_native",
    "native",
    "split_rhat",
    "split_rhat_device",
]
