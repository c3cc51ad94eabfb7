"""Bayesian logistic regression with closed-form manifold geometry.

Port of ``riemannhamiltonianmontecarlo_tpu/models/logreg.py``; the
statistical contract and the derivative algebra are the same:

* log joint  ``L(w) = t^T X w - sum_n log(1 + exp(x_n^T w)) + log N(w; 0, alpha I)``;
* gradient   ``X^T (t - sigma(Xw)) - w / alpha``;
* Fisher metric ``G(w) = X^T diag(v) X + I / alpha``, ``v = p (1 - p)``;
* ``dG_d = sum_n c_{nd} x_n x_n^T`` with ``c_{nd} = v_n (1 - 2 p_n) X_{nd}``,
  so every contraction a manifold sampler needs is an O(N D^2) GEMM over
  the data axis, batched over chains.

The model is an ``nn.Module`` whose design matrix, labels, mask and
outer-feature matrix are buffers, so ``.to(device)`` moves all of them.
The GEMMs here are plain large products and stay ``torch.matmul`` (cuBLAS);
the package's precision module keeps them in full fp32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor, nn


class ManifoldState(NamedTuple):
    """Everything a manifold kernel needs at a position, in one fused pass."""

    logp: Tensor  # (...,)
    grad: Tensor  # (..., D)
    metric: Tensor  # (..., D, D)
    cache: Tensor  # dG cache: the (..., N) weights v * (1 - 2p)


class LogisticRegression(nn.Module):
    """Bayesian logistic regression model over a fixed design matrix.

    Args:
      X: (N, D) design matrix (bias column / basis expansion already applied).
      t: (N,) binary labels in {0, 1}.
      alpha: prior variance (reference uses 100, ``code/rmhmc.py:19``).
      mask: (N,) row validity (1 real, 0 padding), or None.  A padded row has
        x_n = 0 and t_n = 0, which contributes zero to grad / G / dG; the mask
        removes its ``softplus(0) = log 2`` term from logp.
    """

    def __init__(self, X: Tensor, t: Tensor, alpha: float = 100.0, mask: Tensor | None = None):
        super().__init__()
        self.alpha = float(alpha)
        self.register_buffer("X", X)
        self.register_buffer("t", t.reshape(-1))
        self.register_buffer("mask", mask)
        n, d = X.shape
        # Outer-product features F[n, d*D+e] = X[n,d] X[n,e], (N, D^2): every
        # weighted second-moment contraction becomes one dense GEMM,
        #   G(w) = reshape(v @ F) + I/alpha,  s_n = x_n^T M x_n = M_flat @ F^T.
        self.register_buffer("outer_features", (X[:, :, None] * X[:, None, :]).reshape(n, d * d))

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def num_data(self) -> int:
        return self.X.shape[0]

    # -- densities ---------------------------------------------------------

    def _logits(self, w: Tensor) -> Tensor:
        return torch.matmul(w, self.X.T)  # (..., D) @ (D, N) -> (..., N)

    def log_prior(self, w: Tensor) -> Tensor:
        const = -0.5 * self.dim * math.log(2.0 * math.pi * self.alpha)
        return const - 0.5 * torch.sum(w * w, dim=-1) / self.alpha

    def _loglik(self, f: Tensor) -> Tensor:
        sp = nn.functional.softplus(f)
        if self.mask is not None:
            sp = sp * self.mask
        return torch.sum(f * self.t, dim=-1) - torch.sum(sp, dim=-1)

    def logp(self, w: Tensor) -> Tensor:
        return self._loglik(self._logits(w)) + self.log_prior(w)

    def grad(self, w: Tensor) -> Tensor:
        resid = self.t - torch.sigmoid(self._logits(w))  # (..., N)
        return torch.matmul(resid, self.X) - w / self.alpha

    def logp_and_grad(self, w: Tensor) -> tuple[Tensor, Tensor]:
        f = self._logits(w)
        logp = self._loglik(f) + self.log_prior(w)
        resid = self.t - torch.sigmoid(f)
        return logp, torch.matmul(resid, self.X) - w / self.alpha

    # -- manifold geometry -------------------------------------------------

    def _weights(self, w: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        p = torch.sigmoid(self._logits(w))
        v = p * (1.0 - p)
        c = v * (1.0 - 2.0 * p)
        return p, v, c

    def _metric_from_v(self, v: Tensor) -> Tensor:
        # G = X^T diag(v) X + I/alpha as one (C, N) x (N, D^2) GEMM.
        d = self.dim
        g = torch.matmul(v, self.outer_features).reshape(*v.shape[:-1], d, d)
        return g + torch.eye(d, dtype=g.dtype, device=g.device) / self.alpha

    def metric(self, w: Tensor) -> Tensor:
        _, v, _ = self._weights(w)
        return self._metric_from_v(v)

    def manifold_state(self, w: Tensor) -> ManifoldState:
        """Fused logp + grad + G + dG weights (one logits matmul)."""
        f = self._logits(w)
        logp = self._loglik(f) + self.log_prior(w)
        p = torch.sigmoid(f)
        grad = torch.matmul(self.t - p, self.X) - w / self.alpha
        v = p * (1.0 - p)
        c = v * (1.0 - 2.0 * p)
        return ManifoldState(logp, grad, self._metric_from_v(v), c)

    def dg_cache(self, w: Tensor) -> Tensor:
        """(..., N) weights c_n = v_n (1 - 2 p_n);  dG_d = X^T diag(c X[:,d]) X."""
        _, _, c = self._weights(w)
        return c

    def dg_bilinear(self, w: Tensor, u: Tensor, v: Tensor, *, cache: Tensor | None = None) -> Tensor:
        """[u^T dG_d v]_d = X^T (c * (Xu) * (Xv))."""
        c = self.dg_cache(w) if cache is None else cache
        xu = torch.matmul(u, self.X.T)
        xv = xu if v is u else torch.matmul(v, self.X.T)
        return torch.matmul(c * xu * xv, self.X)

    def dg_trace(self, w: Tensor, m: Tensor, *, cache: Tensor | None = None) -> Tensor:
        """[tr(M dG_d)]_d = X^T (c * s),  s_n = x_n^T M x_n."""
        c = self.dg_cache(w) if cache is None else cache
        return torch.matmul(c * self.quadratic_forms(m), self.X)

    def dg_dotted(self, w: Tensor, m: Tensor, *, cache: Tensor | None = None) -> Tensor:
        """[sum_e (M dG_e M)[:, e]] = ((c * s) @ X) M,  s_n = x_n^T M x_n (M symmetric)."""
        c = self.dg_cache(w) if cache is None else cache
        csx = torch.matmul(c * self.quadratic_forms(m), self.X)  # (..., D)
        return torch.einsum("...d,...de->...e", csx, m)

    def quadratic_forms(self, m: Tensor) -> Tensor:
        """s_n = x_n^T M x_n, batched: one (..., D^2) x (D^2, N) GEMM."""
        m_flat = m.reshape(*m.shape[:-2], self.dim * self.dim)
        return torch.matmul(m_flat, self.outer_features.T)

    # -- IWLS helpers (``code/iwls.py:28-35``) ------------------------------

    def iwls_proposal(self, w: Tensor) -> tuple[Tensor, Tensor]:
        """One Newton/IWLS step: proposal mean and covariance.

        cov  = (I/alpha + X^T diag(v) X)^{-1} = G(w)^{-1}
        mean = cov @ (X^T diag(v) X w + X^T (t - p))
        ``inv_ex`` skips the singularity check, which would wait for the
        device; a singular G gives non-finite entries, as ``jnp.linalg.inv``.
        """
        f = self._logits(w)
        p = torch.sigmoid(f)
        v = p * (1.0 - p)
        g = self._metric_from_v(v)
        rhs = torch.matmul(v * f + (self.t - p), self.X)  # (..., D)
        cov = torch.linalg.inv_ex(g).inverse
        mean = torch.einsum("...ab,...b->...a", cov, rhs)
        return mean, cov
