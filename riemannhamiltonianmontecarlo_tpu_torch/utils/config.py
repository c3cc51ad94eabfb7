"""Experiment configuration with reference presets.

The reference has no config system: hyperparameters live in keyword
defaults (``code/rmhmc.py:13``), edit-the-source dataset selection
(``code/main.py:20``) and MATLAB ``switch(DataSet)`` blocks
(``BLR_RMHMC.m:7-184``).  Here each (sampler, workload) pair has a
dataclass preset reproducing those constants exactly, so parity runs are
one function call.

A copy of ``riemannhamiltonianmontecarlo_tpu/utils/config.py`` (plain
Python), so both packages run the same presets.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    sampler: str
    dataset: str = "australian"
    num_iterations: int = 6000
    burn_in: int = 1000
    num_chains: int = 1024
    sampler_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_samples(self) -> int:
        return self.num_iterations - self.burn_in


# (iterations, burn_in, sampler kwargs) per sampler, from the reference
# Python defaults (BLR workload).
_BLR_PRESETS: dict[str, tuple[int, int, dict[str, Any]]] = {
    # code/metropolis.py:14
    "metropolis": (10000, 5000, {}),
    # code/hmc.py:12 (eps=0.14 is the heart/ripley constant; the MATLAB
    # switch blocks BLR_hmc.m:36,:72,:108,:138,:168 are per-dataset --
    # see HMC_STEP_SIZES below, applied by reference_preset).
    "hmc": (6000, 1000, {"step_size": 0.14, "num_leapfrog": 100}),
    # code/rmhmc.py:13
    "rmhmc": (
        6000,
        1000,
        {"step_size": 0.5, "num_leapfrog": 6, "num_fixed_point": 4},
    ),
    # MCMC/BLR_RMHMC_StudentT.m (same trajectory constants as RMHMC)
    "rmhmc_studentt": (
        6000,
        1000,
        {"step_size": 0.5, "num_leapfrog": 6, "num_fixed_point": 4},
    ),
    # MCMC/BLR_MALA.m:33-36 -- 25000/20000, per-dataset step size below,
    # transient scaling sqrt(D) (2 sqrt(D) for ripley), stationary D^(1/3)
    "mala": (25000, 20000, {}),
    # MCMC/BLR_mMALA.m
    "mmala": (10000, 5000, {"step_size": 1.0}),
    "mmala_simplified": (10000, 5000, {"step_size": 1.0}),
    # code/iwls.py:13
    "iwls": (10000, 5000, {}),
    # code/gibbs_sampler.py:73
    "gibbs": (10000, 5000, {}),
}


def reference_preset(sampler: str, dataset: str = "australian", **overrides) -> ExperimentConfig:
    if sampler not in _BLR_PRESETS:
        raise KeyError(f"no preset for sampler '{sampler}'; options: {sorted(_BLR_PRESETS)}")
    iters, burn, kwargs = _BLR_PRESETS[sampler]
    kwargs = dict(kwargs)
    if sampler == "hmc" and dataset in HMC_STEP_SIZES:
        kwargs["step_size"] = HMC_STEP_SIZES[dataset]
    cfg = ExperimentConfig(
        sampler=sampler,
        dataset=dataset,
        num_iterations=iters,
        burn_in=burn,
        sampler_kwargs=kwargs,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


# Per-dataset HMC step sizes (BLR_hmc.m:36,:72,:108,:138,:168).
HMC_STEP_SIZES = {
    "australian": 0.1,
    "german": 0.05,
    "heart": 0.14,
    "pima": 0.1,
    "ripley": 0.14,
}


# Per-dataset MALA step sizes (BLR_MALA.m switch blocks :35,:70,:105,:135,:166).
MALA_STEP_SIZES = {
    "australian": 0.04,
    "german": 0.013,
    "heart": 0.075,
    "pima": 0.025,
    "ripley": 0.1,
}
# Ripley uses the doubled transient scaling (BLR_MALA.m:167).
MALA_TRANSIENT_FACTOR = {"ripley": 2.0}
