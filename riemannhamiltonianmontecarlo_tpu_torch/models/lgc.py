"""Log-Gaussian Cox point process on an N x N grid (paper sec. 10).

Port of ``riemannhamiltonianmontecarlo_tpu/models/lgc.py``: ``LGCModel``
(known hyperparameters, below) and ``LGCJointModel`` (unknown sigma^2 and
beta, ``LGC_RMHMC_Paras_LV.m``; at the end of the file).  ``LGCModel``'s
statistical contract (``Log_Gaussian_Cox/RMHMC/LGC_RMHMC_LV.m``):

* hyperparameters s = 1.91, b = 1/33, mu = log(126) - s/2, m = 1/N^2
  (``:21-25``);
* GP prior covariance over unit-square grid coordinates
  ``Sigma_ij = s exp(-dist_ij / (b N))`` (``:58-79``);
* Poisson-count log joint ``y^T x - sum m e^x - (x-mu)^T Sigma^{-1}
  (x-mu)/2`` (``:86``);
* the constant metric G = Sigma^{-1} + diag(m exp(mu + diag Sigma)), the
  Fisher metric at the prior mean (``:95-101``), as ``metric_chol`` /
  ``metric_inv`` for ``samplers/phmc.py`` and ``samplers/pmala.py``;
* the position-dependent Fisher metric G(x) = Sigma^{-1} + diag(m e^x) and
  its (diagonal) dG contractions for ``samplers/mmala.py``.

D = N^2 = 4096 at the reference size.  The one-time dense algebra (inverse,
Cholesky) runs in float64 on the host and is cast to float32 on the model's
device; every per-position method is a (C, D) x (D, D) GEMM (cuBLAS, full
fp32) plus elementwise work.  ``logp_and_grad_fast`` is the TF32 variant,
for in-trajectory use only (as ``samplers/phmc.py`` runs its leapfrog
under ``trajectory_precision`` "high" / "default").  ``with_sharding`` splits
the three dense operators by rows over a mesh axis (the latent axis).
"""

from __future__ import annotations

import copy
import math
from pathlib import Path

import numpy as np
import torch
from torch import Tensor, nn
from torch.func import grad as func_grad

from riemannhamiltonianmontecarlo_tpu_torch import ops
from riemannhamiltonianmontecarlo_tpu_torch._precision import tf32_matmuls
from riemannhamiltonianmontecarlo_tpu_torch.models.base import autodiff_manifold, batched
from riemannhamiltonianmontecarlo_tpu_torch.models.datasets import find_data_file
from riemannhamiltonianmontecarlo_tpu_torch.models.logreg import ManifoldState
from riemannhamiltonianmontecarlo_tpu_torch.parallel import collectives

REFERENCE_MAT = "TestData64.mat"  # the authors' data set (Log_Gaussian_Cox/RMHMC/)


def grid_distances(n: int) -> np.ndarray:
    """Pairwise Euclidean distances of the unit-square grid (n^2, n^2)."""
    r = np.linspace(0.0, 1.0, n)
    xs, ys = np.meshgrid(r, r)
    coords = np.stack([xs.ravel(), ys.ravel()], axis=1)  # (n^2, 2)
    diff = coords[:, None, :] - coords[None, :, :]
    return np.sqrt((diff**2).sum(-1))


def grid_covariance(n: int, s: float, b: float) -> np.ndarray:
    """Sigma_ij = s exp(-||coord_i - coord_j|| / (b n)) on the unit square
    (``LGC_RMHMC_LV.m:58-79``; meshgrid order => row-major over (y, x))."""
    return s * np.exp(-grid_distances(n) / (b * n))


def generate_data(seed: int = 0, n: int = 64, s: float = 1.91, b: float = 1.0 / 33.0) -> tuple[np.ndarray, np.ndarray]:
    """Simulate (y counts, x_true) from the model (known-truth pattern)."""
    rng = np.random.default_rng(seed)
    mu = np.log(126.0) - s / 2.0
    m = 1.0 / n**2
    sigma = grid_covariance(n, s, b)
    chol = np.linalg.cholesky(sigma + 1e-10 * np.eye(n * n))
    x = mu + chol @ rng.normal(size=n * n)
    y = rng.poisson(m * np.exp(x)).astype(np.float64)
    return y, x


def load_data(path: str | Path | None = None, n: int = 64):
    """The authors' data set (fields Y counts, X latents) if present (``path``,
    or ``REFERENCE_MAT`` in ``$RHMC_DATA_DIR`` or ``<repo>/data``), else
    ``generate_data(n=n)``."""
    p = Path(path) if path is not None else find_data_file(REFERENCE_MAT)
    if p is None or not p.exists():
        return generate_data(n=n)
    from scipy.io import loadmat

    data = loadmat(p)
    return data["Y"].reshape(-1), data["X"].reshape(-1)


def host_operators(n: int, s: float, b: float) -> dict[str, np.ndarray]:
    """Sigma^{-1}, chol(G) and G^{-1} of the constant metric, in float64 on the host
    (the reference uses lightspeed chol2inv, ``LGC_RMHMC_LV.m:81``)."""
    mu = math.log(126.0) - s / 2.0
    m = 1.0 / n**2
    sigma = grid_covariance(n, s, b)
    sigma_inv = np.linalg.inv(sigma)
    g = sigma_inv + np.diag(m * np.exp(mu + np.diag(sigma)))
    return {"sigma_inv": sigma_inv, "metric_chol": np.linalg.cholesky(g), "metric_inv": np.linalg.inv(g)}


class LGCModel(nn.Module):
    """Latent-field posterior with precomputed dense GP algebra.

    ``y``: (D,) counts.  The dense (D, D) operators are buffers on ``y``'s
    device: computed from the grid in float64 on the host, or passed in
    (``sigma_inv``, ``metric_chol``, ``metric_inv``, e.g. the JAX model's
    float32 arrays, so that two implementations compute on identical
    constants).  All per-position methods are batched over leading chain axes.
    """

    capturable = True  # samplers.base.model_capturable; a sharded copy where its group is NCCL's

    def __init__(
        self,
        y: Tensor,
        n: int = 64,
        s: float = 1.91,
        b: float = 1.0 / 33.0,
        *,
        sigma_inv: Tensor | None = None,
        metric_chol: Tensor | None = None,
        metric_inv: Tensor | None = None,
    ):
        super().__init__()
        self.n, self.s, self.b = n, s, b
        self.mu = float(np.log(126.0) - s / 2.0)
        self.m = 1.0 / n**2
        given = {"sigma_inv": sigma_inv, "metric_chol": metric_chol, "metric_inv": metric_inv}
        host = host_operators(n, s, b) if any(v is None for v in given.values()) else {}
        self.register_buffer("y", y.reshape(-1).to(torch.float32))
        for name, value in given.items():
            if value is None:
                value = torch.from_numpy(host[name])
            self.register_buffer(name, value.to(device=y.device, dtype=torch.float32))

    @property
    def dim(self) -> int:
        return self.n * self.n

    OPERATORS = ("sigma_inv", "metric_chol", "metric_inv")

    def with_sharding(self, mesh, axis: str = "latent") -> "LGCModel":
        """A copy of the model whose dense (D, D) operators hold only this
        rank's rows lo:hi, split over ``axis`` of ``mesh`` (the JAX package's
        ``with_sharding``, the framework's long-context axis, SURVEY.md
        section 5): each operator becomes a ``collectives.RowShards``, D / k
        rows a rank.  Positions stay whole on every rank of the axis; each
        (C, D) x (D, D) product is a local partial product and an all-reduce
        (``collectives.matmul``).  Every sampler of the model runs on it, as
        GSPMD partitions any sampler in the JAX package: the constant-metric
        ones (``phmc``, ``pmala``) take the operators through the same seam,
        and mMALA's position-dependent ``metric`` gathers the whole
        Sigma^{-1} (``collectives.gather_rows``, an all-reduce) at each call,
        since each chain's dense (D, D) metric is factored whole.  The copy
        is capturable where the axis's group's collectives are
        (``collectives.capturable``: NCCL, not Gloo).
        """
        k, i = mesh.size(axis), mesh.index(axis)
        if self.dim % k:
            raise ValueError(f"D = {self.dim} latents do not split evenly over {k} ranks of the '{axis}' axis")
        lo, hi = i * self.dim // k, (i + 1) * self.dim // k
        sharded = copy.copy(self)
        sharded._buffers = dict(self._buffers)
        for name in self.OPERATORS:  # no longer buffers: nn.Module refuses a non-tensor under a buffer's name
            full = sharded._buffers.pop(name)
            object.__setattr__(sharded, name, collectives.RowShards.of(full, lo, hi, mesh.group(axis)))
        sharded.capturable = collectives.capturable(mesh.group(axis))  # its products are all-reduced in the step
        return sharded

    def logp(self, x: Tensor) -> Tensor:
        """y^T x - sum m e^x - (x-mu)^T Sigma^{-1} (x-mu)/2 (``:86``)."""
        centered = x - self.mu
        quad = torch.sum(centered * collectives.matmul(centered, self.sigma_inv), dim=-1)
        return torch.sum(x * self.y, dim=-1) - self.m * torch.sum(torch.exp(x), dim=-1) - 0.5 * quad

    def grad(self, x: Tensor) -> Tensor:
        """y - m e^x - Sigma^{-1}(x - mu) (``:127``)."""
        return self.y - self.m * torch.exp(x) - collectives.matmul(x - self.mu, self.sigma_inv)

    def logp_and_grad(self, x: Tensor) -> tuple[Tensor, Tensor]:
        centered = x - self.mu
        sx = collectives.matmul(centered, self.sigma_inv)
        expx = torch.exp(x)
        logp = torch.sum(x * self.y, dim=-1) - self.m * torch.sum(expx, dim=-1) - 0.5 * torch.sum(centered * sx, dim=-1)
        return logp, self.y - self.m * expx - sx

    def logp_and_grad_fast(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """The TF32 variant, for IN-TRAJECTORY use only.

        The ``Sigma^{-1}`` GEMM runs in TF32 on the card (no change on the
        CPU).  Safe only where the caller re-evaluates the exact Hamiltonian
        at the trajectory endpoints before the MH test (``samplers/phmc.py``
        ``trajectory_precision``): integration error then moves acceptance,
        not the stationary distribution.
        """
        with tf32_matmuls():
            return self.logp_and_grad(x)

    def prior_mean(self) -> Tensor:
        return torch.full((self.dim,), self.mu, dtype=torch.float32, device=self.y.device)

    # -- position-dependent manifold interface (mMALA, ``LGC_mMALA_LV.m``) --
    #
    # The exact Fisher metric is G(x) = Sigma^{-1} + diag(m e^x), so
    # dG_d = m e^{x_d} E_dd is diagonal: every contraction a manifold sampler
    # needs is elementwise or one matvec -- no (D, D, D) tensor at D = 4096.

    def metric(self, x: Tensor) -> Tensor:
        """G(x) = Sigma^{-1} + diag(m e^x).  (..., D) -> (..., D, D).

        Materializes a dense (D, D) per chain (64 MB at D = 4096): use few
        chains.  On a sharded model Sigma^{-1} is gathered whole first.
        """
        sigma_inv = self.sigma_inv
        if isinstance(sigma_inv, collectives.RowShards):
            sigma_inv = collectives.gather_rows(sigma_inv)
        return sigma_inv + torch.diag_embed(self.m * torch.exp(x))

    def dg_cache(self, x: Tensor) -> Tensor:
        """(..., D) diagonal weights m e^x;  dG_d = m e^{x_d} E_dd."""
        return self.m * torch.exp(x)

    def dg_bilinear(self, x: Tensor, u: Tensor, v: Tensor, *, cache: Tensor | None = None) -> Tensor:
        c = self.dg_cache(x) if cache is None else cache
        return c * u * v

    def dg_trace(self, x: Tensor, mmat: Tensor, *, cache: Tensor | None = None) -> Tensor:
        c = self.dg_cache(x) if cache is None else cache
        return c * torch.diagonal(mmat, dim1=-2, dim2=-1)

    def dg_dotted(self, x: Tensor, mmat: Tensor, *, cache: Tensor | None = None) -> Tensor:
        """[sum_e (M dG_e M)[:, e]] = M @ (c * diag M)."""
        c = self.dg_cache(x) if cache is None else cache
        weights = c * torch.diagonal(mmat, dim1=-2, dim2=-1)
        return torch.einsum("...ie,...e->...i", mmat, weights)

    def manifold_state(self, x: Tensor) -> ManifoldState:
        logp, grad = self.logp_and_grad(x)
        return ManifoldState(logp, grad, self.metric(x), self.dg_cache(x))

    # -- whitened view (MALA with transformation, ``LGC_MALA_Transient.m``) --

    def whitened(self) -> "WhitenedLGC":
        """Model over gamma with x = mu + L gamma, L = chol(Sigma) (float64 on
        the host, cast to float32); the reference's "MALA with
        transformation" (``LGC_MALA_Transient.m:32-37``).  The Jacobian is
        constant, so log densities differ by a constant."""
        sigma = grid_covariance(self.n, self.s, self.b)
        chol = np.linalg.cholesky(sigma + 1e-10 * np.eye(self.dim))
        return WhitenedLGC(self, torch.tensor(chol, dtype=torch.float32, device=self.y.device))


class WhitenedLGC:
    """The LGC posterior over gamma, x = mu + L gamma."""

    def __init__(self, model: LGCModel, chol: Tensor):
        self.model = model
        self.chol = chol
        self.dim = model.dim
        self.capturable = model.capturable

    def to_x(self, gamma: Tensor) -> Tensor:
        return self.model.mu + torch.matmul(gamma, self.chol.T)

    def logp(self, gamma: Tensor) -> Tensor:
        return self.model.logp(self.to_x(gamma))

    def grad(self, gamma: Tensor) -> Tensor:
        return torch.matmul(self.model.grad(self.to_x(gamma)), self.chol)

    def logp_and_grad(self, gamma: Tensor) -> tuple[Tensor, Tensor]:
        lp, gx = self.model.logp_and_grad(self.to_x(gamma))
        return lp, torch.matmul(gx, self.chol)


class LGCJointModel(nn.Module):
    """LGC with *unknown* GP hyperparameters (sigma^2, beta).

    Port of ``riemannhamiltonianmontecarlo_tpu/models/lgc.py::LGCJointModel``
    (reference ``LGC_RMHMC_Paras_LV.m``, the paper's most expensive
    configuration).  Inference alternates a manifold move on
    theta~ = (log sigma^2, log beta) given x with constant-metric latent
    updates, and each theta~ move rebuilds the dense GP algebra:

    * target over theta~ given x (``:147-150,343-349``): -1/2 log|Sigma|
      - 1/2 (x-mu)^T Sigma^{-1} (x-mu) + Gamma(2, 0.5) log-priors + the
      log-coordinate Jacobian;
    * expected-Fisher metric G_ij = 1/2 tr(A_i A_j) + prior curvature,
      A_i = Sigma^{-1} dSigma/dtheta~_i (``:101-121``);
    * dG in closed form (the reference hand-codes the same third-order
      products, ``:127-139``).  mu is FIXED at log(126) - 1.91/2 (``:28``).

    ``y``: (D,) counts; the model's buffers (``y`` and the (D, D) grid
    distances) live on ``device`` (default: ``y``'s).  Every per-theta~
    quantity is a dense (C, D, D) batch on that device, built by library
    factorizations (``ops.cholesky(method="library")``, which gives a
    non-finite factor, never an exception, for a K that is not PD in
    float32) and full-fp32 GEMMs: batch a handful of chains only (a
    (4, 4096, 4096) float32 batch is 268 MB, and ``"full"`` holds about ten).

    Deviation from the MATLAB, as in the JAX package: the gradient includes
    the Jacobian's derivative (+1 per coordinate) that the reference's own
    Hamiltonian includes and its gradient omits.
    """

    # samplers.base.model_capturable: the joint samplers take the closed form
    # (``hyper_geometry``); the ``use_autodiff`` oracle is a test tool.
    capturable = True

    def __init__(
        self,
        y: Tensor,
        n: int = 64,
        gamma_k: float = 2.0,  # LGC_RMHMC_Paras_LV.m:32
        gamma_theta: float = 0.5,  # :33
        init_sigma_sq: float = 1.91,  # :26 -- also pins mu
        init_beta: float = 1.0 / 33.0,  # :27
        *,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        y = torch.as_tensor(y)
        device = y.device if device is None else torch.device(device)
        self.n, self.gamma_k, self.gamma_theta = n, gamma_k, gamma_theta
        self.init_sigma_sq, self.init_beta = init_sigma_sq, init_beta
        self.mu = float(np.log(126.0) - init_sigma_sq / 2.0)
        self.m = 1.0 / n**2
        self.register_buffer("y", y.reshape(-1).to(device=device, dtype=torch.float32))
        self.register_buffer("dist", torch.tensor(grid_distances(n), dtype=torch.float32, device=device))

    @property
    def dim(self) -> int:
        return self.n * self.n

    def sigma_of(self, theta_t: Tensor) -> Tensor:
        """Sigma(theta~).  (..., 2) -> (..., D, D)."""
        sigma_sq = torch.exp(theta_t[..., 0])[..., None, None]
        beta = torch.exp(theta_t[..., 1])[..., None, None]
        return sigma_sq * torch.exp(-self.dist / (beta * self.n))

    # -- fused closed-form hyper geometry -----------------------------------
    #
    # Sigma(theta~) = sigma^2 K(beta) with K = exp(-S), S = dist/(beta n),
    # so A_1 = Sigma^{-1} dSigma/dt_1 = I exactly and every Fisher / dG term
    # reduces to ONE Cholesky of K, cho_solves for A_2 = K^{-1}(S o K) and
    # B = K^{-1}((S^2 - S) o K), and one GEMM A_2 A_2.  Identities (d/dt_2
    # means d/d log beta):
    #
    #   d(S o K)/dt_2 = (S^2 - S) o K          (dS/dt_2 = -S, dK/dt_2 = S o K)
    #   dA_2/dt_2     = -A_2 A_2 + B
    #   G = [[D/2, tr(A_2)/2], [., tr(A_2 A_2)/2]] + diag prior curvature
    #   dG/dt_2[1,1]  = -tr(A_2^3) + tr(A_2 B) + beta/gamma_theta
    #
    # with tr(A_2 A_2) = sum(A_2 o A_2^T), tr(A_2^3) = sum((A_2 A_2) o A_2^T),
    # tr(A_2 B) = sum(A_2 o B^T): elementwise, no further GEMM.  Needs no
    # autograd, so it runs under ``torch.inference_mode()`` as it is.

    def hyper_geometry(self, theta_t: Tensor, x: Tensor, *, parts: str) -> dict[str, Tensor]:
        """Fused hyper-block geometry at theta~ (C, 2), batched over the chains.

        ``x``: (D,) shared by every chain, or (C, D).  ``parts``: "logp"
        (logp only), "metric" (metric only) or "full" (logp, grad, metric,
        dg): the three call shapes of the RMHMC / mMALA kernels, each paying
        only the linear algebra it needs.  dg: (C, 2, 2, 2), dg[:, i] = dG/dt_i.
        """
        if parts not in ("logp", "metric", "full"):
            raise ValueError(f"parts must be logp|metric|full, got {parts!r}")
        d = self.dim
        t1, t2 = theta_t[:, 0], theta_t[:, 1]
        sigma_sq, beta = torch.exp(t1), torch.exp(t2)
        s_mat = self.dist / (beta * self.n)[:, None, None]
        k_mat = torch.exp(-s_mat)
        chol_k = ops.cholesky(k_mat, method="library")
        out = {}

        if parts in ("logp", "full"):
            c = (x - self.mu).expand(theta_t.shape[0], d)
            v = ops.cho_solve(chol_k, c, method="library")  # K^{-1} c
            quad = torch.sum(c * v, dim=-1) / sigma_sq  # c^T Sigma^{-1} c
            half_logdet = 0.5 * d * t1 + torch.sum(torch.log(torch.diagonal(chol_k, dim1=-2, dim2=-1)), dim=-1)
            prior = torch.sum(self.gamma_k * theta_t - torch.exp(theta_t) / self.gamma_theta, dim=-1)
            out["logp"] = -half_logdet - 0.5 * quad + prior
        if parts == "logp":
            return out

        sk = s_mat * k_mat
        a2 = ops.cho_solve(chol_k, sk, method="library")  # K^{-1}(S o K)
        tr_a2 = torch.diagonal(a2, dim1=-2, dim2=-1).sum(-1)
        tr_a2_sq = torch.sum(a2 * a2.mT, dim=(-2, -1))
        g12 = 0.5 * tr_a2
        out["metric"] = torch.stack([
            torch.stack([0.5 * d + sigma_sq / self.gamma_theta, g12], dim=-1),
            torch.stack([g12, 0.5 * tr_a2_sq + beta / self.gamma_theta], dim=-1),
        ], dim=-2)
        if parts == "metric":
            return out

        # gradient: dlogp/dt_i = -1/2 tr(A_i) + 1/2 c^T Sigma^{-1} dSigma_i
        # Sigma^{-1} c + prior' (LGC_RMHMC_Paras_LV.m target, :147-150).
        g1 = -0.5 * d + 0.5 * quad + self.gamma_k - sigma_sq / self.gamma_theta
        skv = torch.einsum("...ab,...b->...a", sk, v)
        g2 = -0.5 * tr_a2 + 0.5 * torch.sum(v * skv, dim=-1) / sigma_sq + self.gamma_k - beta / self.gamma_theta
        out["grad"] = torch.stack([g1, g2], dim=-1)

        b_mat = ops.cho_solve(chol_k, (s_mat * s_mat - s_mat) * k_mat, method="library")
        tr_a2_cube = torch.sum(torch.matmul(a2, a2) * a2.mT, dim=(-2, -1))
        tr_a2_b = torch.sum(a2 * b_mat.mT, dim=(-2, -1))
        dg12 = 0.5 * (torch.diagonal(b_mat, dim1=-2, dim2=-1).sum(-1) - tr_a2_sq)
        dg22 = -tr_a2_cube + tr_a2_b + beta / self.gamma_theta
        dg = theta_t.new_zeros((theta_t.shape[0], 2, 2, 2))
        dg[:, 0, 0, 0] = sigma_sq / self.gamma_theta
        dg[:, 1, 0, 1] = dg12
        dg[:, 1, 1, 0] = dg12
        dg[:, 1, 1, 1] = dg22
        out["dg"] = dg
        return out

    def hyper_manifold(self, x: Tensor, *, use_autodiff: bool = False):
        """ManifoldModel view of theta~ | x (batched over leading axes).

        ``use_autodiff=True`` derives grad / dG by ``torch.func`` through the
        reference-shaped ``hyper_logp_single`` / ``hyper_metric_single``: the
        slow oracle the closed form is tested against (tests only, small n).
        """
        return AutodiffJointHyperManifold(self, x) if use_autodiff else JointHyperManifold(self, x)

    # -- single-chain hyper-block quantities: the autodiff oracle -----------

    def hyper_logp_single(self, theta_t: Tensor, x: Tensor) -> Tensor:
        """log p(theta~ | x) at one (2,) theta~, through a factorization of Sigma itself."""
        chol = ops.cholesky(self.sigma_of(theta_t), method="library")
        centered = x - self.mu
        v = ops.cho_solve(chol, centered, method="library")
        half_logdet = torch.sum(torch.log(torch.diagonal(chol)))
        # Gamma(k, theta) priors on sigma^2 and beta plus the log-coordinate
        # Jacobian: (k-1) t_i - exp(t_i)/gamma_theta + t_i.
        prior = torch.sum(self.gamma_k * theta_t - torch.exp(theta_t) / self.gamma_theta)
        return -half_logdet - 0.5 * torch.dot(centered, v) + prior

    def hyper_metric_single(self, theta_t: Tensor) -> Tensor:
        """The expected-Fisher + prior metric (2, 2) at one (2,) theta~, from A_1 and A_2."""
        sigma = self.sigma_of(theta_t)
        beta = torch.exp(theta_t[1])
        chol = ops.cholesky(sigma, method="library")
        a1 = ops.cho_solve(chol, sigma, method="library")  # dSigma/dlog sigma^2 = Sigma
        a2 = ops.cho_solve(chol, self.dist / (beta * self.n) * sigma, method="library")  # dSigma/dlog beta
        g12 = 0.5 * torch.sum(a1 * a2.mT)
        # Prior curvature (LGC_RMHMC_Paras_LV.m:120-121).
        g11 = 0.5 * torch.sum(a1 * a1.mT) + torch.exp(theta_t[0]) / self.gamma_theta
        g22 = 0.5 * torch.sum(a2 * a2.mT) + beta / self.gamma_theta
        return torch.stack([torch.stack([g11, g12]), torch.stack([g12, g22])])

    # -- latent block given theta~ -------------------------------------------

    def latent_logp_and_grad(self, x: Tensor, sigma_inv: Tensor) -> tuple[Tensor, Tensor]:
        """Poisson-count conditional given the current Sigma^{-1} (per chain)."""
        centered = x - self.mu
        sx = torch.einsum("...ab,...b->...a", sigma_inv, centered)
        expx = torch.exp(x)
        logp = torch.sum(x * self.y, dim=-1) - self.m * torch.sum(expx, dim=-1) - 0.5 * torch.sum(centered * sx, dim=-1)
        return logp, self.y - self.m * expx - sx

    def latent_mass(self, theta_t: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """(Sigma^{-1}, chol G, G^{-1}) at theta~ (..., 2), each (..., D, D).

        G = Sigma^{-1} + diag(m exp(mu + diag Sigma)): the constant-metric
        trick re-evaluated at the current hyperparameters
        (``LGC_RMHMC_Paras_LV.m`` latent block).
        """
        sigma = self.sigma_of(theta_t)
        eye = torch.eye(self.dim, dtype=sigma.dtype, device=sigma.device).expand(sigma.shape)
        sigma_inv = ops.cho_solve(ops.cholesky(sigma, method="library"), eye, method="library")
        diag = self.m * torch.exp(self.mu + torch.diagonal(sigma, dim1=-2, dim2=-1))
        chol_g = ops.cholesky(sigma_inv + torch.diag_embed(diag), method="library")
        return sigma_inv, chol_g, ops.cho_solve(chol_g, eye, method="library")


class JointHyperManifold:
    """theta~ | x of ``LGCJointModel`` as a ManifoldModel, in closed form.

    ``x``: (D,) shared by every chain, or one (D,) per leading index of
    theta~.  Every method takes theta~ (..., 2).
    """

    dim = 2

    def __init__(self, model: LGCJointModel, x: Tensor):
        self.model = model
        self.x = x

    def _geom(self, th: Tensor, parts: str) -> dict[str, Tensor]:
        lead = th.shape[:-1]
        x = self.x if self.x.ndim == 1 else self.x.reshape(-1, self.x.shape[-1])
        out = self.model.hyper_geometry(th.reshape(-1, 2), x, parts=parts)
        return {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}

    def logp(self, th: Tensor) -> Tensor:
        return self._geom(th, "logp")["logp"]

    def grad(self, th: Tensor) -> Tensor:
        return self._geom(th, "full")["grad"]

    def logp_and_grad(self, th: Tensor) -> tuple[Tensor, Tensor]:
        g = self._geom(th, "full")
        return g["logp"], g["grad"]

    def metric(self, th: Tensor) -> Tensor:
        return self._geom(th, "metric")["metric"]

    def dg_cache(self, th: Tensor) -> Tensor:
        return self._geom(th, "full")["dg"]

    def _dg(self, th: Tensor, cache: Tensor | None) -> Tensor:
        return self.dg_cache(th) if cache is None else cache

    def dg_bilinear(self, th: Tensor, u: Tensor, v: Tensor, *, cache: Tensor | None = None) -> Tensor:
        return torch.einsum("...dab,...a,...b->...d", self._dg(th, cache), u, v)

    def dg_trace(self, th: Tensor, m: Tensor, *, cache: Tensor | None = None) -> Tensor:
        return torch.einsum("...dab,...ba->...d", self._dg(th, cache), m)

    def dg_dotted(self, th: Tensor, m: Tensor, *, cache: Tensor | None = None) -> Tensor:
        return torch.einsum("...ia,...eab,...be->...i", m, self._dg(th, cache), m)

    def manifold_state(self, th: Tensor) -> ManifoldState:
        g = self._geom(th, "full")
        return ManifoldState(g["logp"], g["grad"], g["metric"], g["dg"])


class AutodiffJointHyperManifold:
    """The same view by ``torch.func``: gradient of ``hyper_logp_single``,
    metric and dG through ``models.base.autodiff_manifold`` (jacrev of
    ``hyper_metric_single``), everything through ``with_autograd``."""

    dim = 2

    def __init__(self, model: LGCJointModel, x: Tensor):
        self.model = model
        self.x = x
        mani = autodiff_manifold(self, model.hyper_metric_single)
        self.metric, self.dg_cache = mani.metric, mani.dg_cache
        self.dg_bilinear, self.dg_trace, self.dg_dotted = mani.dg_bilinear, mani.dg_trace, mani.dg_dotted

    def _over_chains(self, fn, th: Tensor) -> Tensor:
        if self.x.ndim == 1:
            return batched(lambda a: fn(a, self.x), th)
        return batched(fn, th, self.x)

    def logp(self, th: Tensor) -> Tensor:
        return self._over_chains(self.model.hyper_logp_single, th)

    def grad(self, th: Tensor) -> Tensor:
        return self._over_chains(func_grad(self.model.hyper_logp_single), th)

    def logp_and_grad(self, th: Tensor) -> tuple[Tensor, Tensor]:
        return self.logp(th), self.grad(th)

    def manifold_state(self, th: Tensor) -> ManifoldState:
        return ManifoldState(self.logp(th), self.grad(th), self.metric(th), self.dg_cache(th))
