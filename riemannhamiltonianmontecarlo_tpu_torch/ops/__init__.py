"""Batched numerical ops: chain-vectorized linalg and its Hopper kernels."""

from riemannhamiltonianmontecarlo_tpu_torch.ops import hopper_linalg
from riemannhamiltonianmontecarlo_tpu_torch.ops.linalg import (
    cho_solve,
    cholesky,
    inv_psd_from_chol,
    logdet_from_chol,
    mvn_sample,
    solve_lower_triangular,
    solve_psd,
    solve_upper_from_lower,
)

__all__ = [
    "hopper_linalg",
    "cholesky",
    "cho_solve",
    "solve_lower_triangular",
    "solve_upper_from_lower",
    "solve_psd",
    "inv_psd_from_chol",
    "logdet_from_chol",
    "mvn_sample",
]
