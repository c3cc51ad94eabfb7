"""Chain-batched small-matrix linear algebra.

Port of ``riemannhamiltonianmontecarlo_tpu/ops/linalg.py``.  RMHMC on the
BLR workloads (and the StochVol hyper block, D = 3) needs Cholesky factors,
triangular solves, PD inverses and log-determinants of tiny (D = 3..25)
matrices batched over thousands of chains; LGC's position-dependent mMALA
(D = 4096) takes the library path.  The plain path keeps the chain axis vectorized and unrolls the
factorization over the static dimension D, as the JAX package does.

``method`` selects the implementation:

* ``None`` (auto): a 3-D (C, D, D) CUDA batch with D <= 48 goes to the
  hand-written Hopper kernels (``ops/hopper_linalg.py``), always; anything
  else takes the unrolled path (D <= 48) or the library path.  The JAX
  package's C >= 256 cut-over was a TPU measurement and is not carried over.
* ``"unrolled"``: the unrolled plain-PyTorch path.
* ``"library"``: ``torch.linalg`` (the JAX package's ``"xla"``).
* ``"kernel"``: the Hopper kernels for any 3-D batch (their plain twins for
  a CPU tensor; the JAX package's ``"pallas"``).

``chol_inv_logdet`` is RMHMC's geometry in one call: where ``cholesky``
would take K1 it is the kernel K3 (factor, inverse and half log-determinant
in one launch, in place of K1 and the ~230 launches of the unrolled
``inv_psd_from_chol`` at D = 15); otherwise the factor by ``method``, then
``inv_psd_from_chol`` and ``logdet_from_chol``, as the JAX package's
``rmhmc.geometry`` does.

All functions accept arbitrary leading batch axes.
"""

from __future__ import annotations

import torch
from torch import Tensor

from riemannhamiltonianmontecarlo_tpu_torch.ops import hopper_linalg

# Above this dimension the unrolled elimination issues too many small ops
# and the library factorization wins; the kernels are sized for it too.
UNROLL_MAX_DIM = hopper_linalg.MAX_DIM

METHODS = (None, "unrolled", "library", "kernel")


def _check_method(method: str | None) -> None:
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")


def _use_kernel(a: Tensor, method: str | None) -> bool:
    _check_method(method)
    if method == "kernel":
        return a.ndim == 3
    return method is None and a.is_cuda and a.ndim == 3 and a.shape[-1] <= UNROLL_MAX_DIM


def _use_unrolled(d: int, method: str | None) -> bool:
    _check_method(method)
    if method == "unrolled":
        return True
    if method == "library":
        return False
    return d <= UNROLL_MAX_DIM


def cholesky(a: Tensor, *, method: str | None = None) -> Tensor:
    """Lower Cholesky factor of PD matrices.  (..., D, D) -> (..., D, D).

    A matrix that is not PD gives non-finite entries in its own factor,
    whatever the method (``torch.linalg.cholesky`` would raise).
    """
    if _use_kernel(a, method):
        return hopper_linalg.cholesky(a)
    if _use_unrolled(a.shape[-1], method):
        return hopper_linalg.cholesky_plain(a)
    l, info = torch.linalg.cholesky_ex(a)
    lower = torch.ones(l.shape[-2:], dtype=torch.bool, device=l.device).tril()
    return torch.where((info != 0)[..., None, None] & lower, torch.nan, l)


def solve_lower_triangular(l: Tensor, b: Tensor, *, method: str | None = None) -> Tensor:
    """Solve L y = b with L lower triangular.  b: (..., D) or (..., D, K)."""
    d = l.shape[-1]
    vector = b.ndim == l.ndim - 1
    if vector:
        b = b[..., None]
    if not _use_unrolled(d, method):
        y = torch.linalg.solve_triangular(l, b, upper=False)
    else:
        rows = []
        for i in range(d):
            s = b[..., i, :]
            for k in range(i):
                s = s - l[..., i, k, None] * rows[k]
            rows.append(s / l[..., i, i, None])
        y = torch.stack(rows, dim=-2)
    return y[..., 0] if vector else y


def solve_upper_from_lower(l: Tensor, b: Tensor, *, method: str | None = None) -> Tensor:
    """Solve L^T y = b (back substitution on the transpose of lower L)."""
    d = l.shape[-1]
    vector = b.ndim == l.ndim - 1
    if vector:
        b = b[..., None]
    if not _use_unrolled(d, method):
        y = torch.linalg.solve_triangular(l.mT, b, upper=True)
    else:
        rows: list = [None] * d
        for i in reversed(range(d)):
            s = b[..., i, :]
            for k in range(i + 1, d):
                s = s - l[..., k, i, None] * rows[k]
            rows[i] = s / l[..., i, i, None]
        y = torch.stack(rows, dim=-2)
    return y[..., 0] if vector else y


def cho_solve(l: Tensor, b: Tensor, *, method: str | None = None) -> Tensor:
    """Solve A x = b given the lower Cholesky factor L of A."""
    return solve_upper_from_lower(l, solve_lower_triangular(l, b, method=method), method=method)


def solve_psd(a: Tensor, b: Tensor, *, method: str | None = None) -> Tensor:
    """Solve A x = b for symmetric PD A via Cholesky."""
    if b.ndim == 2 and _use_kernel(a, method):
        x, _ = hopper_linalg.chol_solve_logdet(a, b)
        return x
    return cho_solve(cholesky(a, method=method), b, method=method)


def inv_psd(a: Tensor, *, method: str | None = None) -> Tensor:
    """Inverse of symmetric PD matrices via Cholesky (K1 on a 3-D CUDA batch)."""
    return inv_psd_from_chol(cholesky(a, method=method), method=method)


def inv_psd_from_chol(l: Tensor, *, method: str | None = None) -> Tensor:
    """A^{-1} = L^{-T} L^{-1} from the lower Cholesky factor."""
    d = l.shape[-1]
    eye = torch.eye(d, dtype=l.dtype, device=l.device).expand(l.shape)
    linv = solve_lower_triangular(l, eye, method=method)
    return torch.matmul(linv.mT, linv)


def chol_inv_logdet(a: Tensor, *, method: str | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """(L, A^{-1}, 1/2 log|A|) of symmetric PD matrices: K3 on a 3-D CUDA batch
    (where ``cholesky`` takes K1), else ``cholesky(method=)``, the unrolled
    ``inv_psd_from_chol`` and ``logdet_from_chol``."""
    if _use_kernel(a, method):
        return hopper_linalg.chol_inv_logdet(a)
    l = cholesky(a, method=method)
    return l, inv_psd_from_chol(l), 0.5 * logdet_from_chol(l)


def logdet_from_chol(l: Tensor) -> Tensor:
    """log|A| = 2 sum log diag L.  (..., D, D) -> (...,)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), dim=-1)


def mvn_sample(chol_l: Tensor, eps: Tensor) -> Tensor:
    """z ~ N(0, L L^T) as L @ eps, given the caller's eps ~ N(0, I) of shape (..., D).

    Follows the MATLAB oracle's N(0, G) contract, not the reference Python
    port's ``randn @ cholesky(G)`` (covariance L^T L); see the JAX package's
    ``ops.mvn_sample``.
    """
    return torch.einsum("...ab,...b->...a", chol_l, eps)
