"""Batched numerical ops: chain-vectorized linalg and its Hopper kernels,
batched tridiagonal algebra (StochVol) and its scan kernel, the
FitzHugh-Nagumo sensitivity kernel, the truncated-normal and GIG samplers
of the Gibbs sampler, RMHMC's two fixed points and BLR's kernels for them."""

from riemannhamiltonianmontecarlo_tpu_torch.ops import fhn_sens, hopper_linalg, launches, logreg_fixed_point, tridiag
from riemannhamiltonianmontecarlo_tpu_torch.ops.gig import sample_gig_half
from riemannhamiltonianmontecarlo_tpu_torch.ops.truncnorm import truncated_normal_onesided
from riemannhamiltonianmontecarlo_tpu_torch.ops.linalg import (
    cho_solve,
    chol_inv_logdet,
    cholesky,
    inv_psd,
    inv_psd_from_chol,
    logdet_from_chol,
    mvn_sample,
    solve_lower_triangular,
    solve_psd,
    solve_upper_from_lower,
)

__all__ = [
    "fhn_sens",
    "hopper_linalg",
    "launches",
    "logreg_fixed_point",
    "tridiag",
    "cholesky",
    "cho_solve",
    "chol_inv_logdet",
    "solve_lower_triangular",
    "solve_upper_from_lower",
    "solve_psd",
    "inv_psd",
    "inv_psd_from_chol",
    "logdet_from_chol",
    "mvn_sample",
    "sample_gig_half",
    "truncated_normal_onesided",
]
