"""Transition kernels (batched over a leading chain axis)."""

from riemannhamiltonianmontecarlo_tpu_torch.samplers import rmhmc
from riemannhamiltonianmontecarlo_tpu_torch.samplers.base import Info, Kernel, metropolis_accept

__all__ = ["rmhmc", "Info", "Kernel", "metropolis_accept"]
