"""Transition kernels (batched over a leading chain axis)."""

from riemannhamiltonianmontecarlo_tpu_torch.samplers import gibbs, hmc, iwls, mala, metropolis, mmala, rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept

__all__ = ["gibbs", "hmc", "iwls", "mala", "metropolis", "mmala", "rmhmc", "Info", "Kernel", "metropolis_accept"]
