"""Transition kernels (batched over a leading chain axis)."""

from riemannhamiltonianmontecarlo_tpu_torch.samplers import gibbs, hmc, iwls, lgc_joint, mala, metropolis, mmala, phmc, pmala, rmhmc, stochvol
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept

__all__ = ["gibbs", "hmc", "iwls", "lgc_joint", "mala", "metropolis", "mmala", "phmc", "pmala", "rmhmc", "stochvol", "Info", "Kernel", "metropolis_accept"]
