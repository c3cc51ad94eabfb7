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
``with_sharding`` splits the rows over a mesh axis: each method then
all-reduces its contractions over n (one collective per call, the partial
sums packed into one buffer) before the prior term is added.
The GEMMs here are plain large products and stay ``torch.matmul`` (cuBLAS);
the package's precision module keeps them in full fp32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor, nn

from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives


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
        self.group = None  # the process group the rows are split over (``with_sharding``)

    @property
    def dim(self) -> int:
        return self.X.shape[-1]

    @property
    def num_data(self) -> int:
        return self.X.shape[0]

    def with_sharding(self, mesh, axis: str = "data") -> "LogisticRegression":
        """This rank's rows of the model, the data axis split over ``axis``
        of ``mesh`` (the JAX package's ``with_sharding``, SURVEY.md section
        2.4 TP row).

        N is zero-padded up to a multiple of the axis size; padded rows have
        x_n = 0, t_n = 0 (no share of grad / G / dG) and a 0 ``mask`` entry
        that removes their ``softplus(0)`` from logp.  Each rank keeps rows
        lo:hi of ``X``, ``t``, ``mask`` and ``outer_features``; every sum over
        n is all-reduced over the axis's group before the prior is added, so
        each rank returns the whole model's values, up to the order of the
        sums.  ``quadratic_forms`` and the dG cache stay the rank's own rows.
        """
        k, i = mesh.size(axis), mesh.index(axis)
        n, d = self.X.shape
        per = -(-n // k)
        pad = per * k - n
        x = torch.cat([self.X, self.X.new_zeros((pad, d))])
        t = torch.cat([self.t, self.t.new_zeros((pad,))])
        mask = torch.cat([self.X.new_ones((n,)) if self.mask is None else self.mask, self.X.new_zeros((pad,))])
        rows = slice(i * per, (i + 1) * per)
        sharded = LogisticRegression(x[rows].clone(), t[rows].clone(), self.alpha, mask[rows].clone())
        sharded.group = mesh.group(axis)
        return sharded

    def _sum_over_data(self, w: Tensor, *partials: Tensor) -> tuple[Tensor, ...]:
        """Partial sums over this rank's rows (each of shape ``w.shape[:-1]``
        plus trailing dims) -> the sums over every row, in one all-reduce of
        the parts side by side; the parts themselves when the model is whole."""
        if self.group is None:
            return partials
        if len(partials) == 1:
            return (collectives.all_reduce(partials[0], self.group),)
        batch = w.shape[:-1]
        flat = [p.reshape(*batch, -1) for p in partials]
        total = collectives.all_reduce(torch.cat(flat, dim=-1), self.group)
        parts = torch.split(total, [f.shape[-1] for f in flat], dim=-1)
        return tuple(part.reshape(p.shape) for part, p in zip(parts, partials))

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
        (loglik,) = self._sum_over_data(w, self._loglik(self._logits(w)))
        return loglik + self.log_prior(w)

    def grad(self, w: Tensor) -> Tensor:
        resid = self.t - torch.sigmoid(self._logits(w))  # (..., N)
        (g,) = self._sum_over_data(w, torch.matmul(resid, self.X))
        return g - w / self.alpha

    def logp_and_grad(self, w: Tensor) -> tuple[Tensor, Tensor]:
        f = self._logits(w)
        resid = self.t - torch.sigmoid(f)
        loglik, g = self._sum_over_data(w, self._loglik(f), torch.matmul(resid, self.X))
        return loglik + self.log_prior(w), g - w / self.alpha

    # -- manifold geometry -------------------------------------------------

    def _weights(self, w: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        p = torch.sigmoid(self._logits(w))
        v = p * (1.0 - p)
        c = v * (1.0 - 2.0 * p)
        return p, v, c

    def _metric_terms(self, v: Tensor) -> Tensor:
        # X^T diag(v) X, flattened, as one (C, N) x (N, D^2) GEMM.
        return torch.matmul(v, self.outer_features)

    def _metric_from_terms(self, terms: Tensor) -> Tensor:
        # G = X^T diag(v) X + I/alpha.
        d = self.dim
        g = terms.reshape(*terms.shape[:-1], d, d)
        return g + torch.eye(d, dtype=g.dtype, device=g.device) / self.alpha

    def metric(self, w: Tensor) -> Tensor:
        _, v, _ = self._weights(w)
        (terms,) = self._sum_over_data(w, self._metric_terms(v))
        return self._metric_from_terms(terms)

    def manifold_state(self, w: Tensor) -> ManifoldState:
        """Fused logp + grad + G + dG weights (one logits matmul; sharded,
        one all-reduce)."""
        f = self._logits(w)
        p = torch.sigmoid(f)
        v = p * (1.0 - p)
        c = v * (1.0 - 2.0 * p)
        loglik, g, terms = self._sum_over_data(
            w, self._loglik(f), torch.matmul(self.t - p, self.X), self._metric_terms(v))
        return ManifoldState(loglik + self.log_prior(w), g - w / self.alpha, self._metric_from_terms(terms), c)

    def dg_cache(self, w: Tensor) -> Tensor:
        """(..., N) weights c_n = v_n (1 - 2 p_n);  dG_d = X^T diag(c X[:,d]) X."""
        _, _, c = self._weights(w)
        return c

    def dg_bilinear(self, w: Tensor, u: Tensor, v: Tensor, *, cache: Tensor | None = None) -> Tensor:
        """[u^T dG_d v]_d = X^T (c * (Xu) * (Xv))."""
        c = self.dg_cache(w) if cache is None else cache
        xu = torch.matmul(u, self.X.T)
        xv = xu if v is u else torch.matmul(v, self.X.T)
        return self._sum_over_data(u, torch.matmul(c * xu * xv, self.X))[0]

    def dg_trace(self, w: Tensor, m: Tensor, *, cache: Tensor | None = None) -> Tensor:
        """[tr(M dG_d)]_d = X^T (c * s),  s_n = x_n^T M x_n."""
        c = self.dg_cache(w) if cache is None else cache
        return self._sum_over_data(w, torch.matmul(c * self.quadratic_forms(m), self.X))[0]

    def dg_dotted(self, w: Tensor, m: Tensor, *, cache: Tensor | None = None) -> Tensor:
        """[sum_e (M dG_e M)[:, e]] = ((c * s) @ X) M,  s_n = x_n^T M x_n (M symmetric)."""
        c = self.dg_cache(w) if cache is None else cache
        (csx,) = self._sum_over_data(w, torch.matmul(c * self.quadratic_forms(m), self.X))  # (..., D)
        return torch.einsum("...d,...de->...e", csx, m)

    def quadratic_forms(self, m: Tensor) -> Tensor:
        """s_n = x_n^T M x_n, batched: one (..., D^2) x (D^2, N) GEMM (this rank's rows)."""
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
        terms, rhs = self._sum_over_data(w, self._metric_terms(v), torch.matmul(v * f + (self.t - p), self.X))
        cov = torch.linalg.inv_ex(self._metric_from_terms(terms)).inverse
        mean = torch.einsum("...ab,...b->...a", cov, rhs)
        return mean, cov
