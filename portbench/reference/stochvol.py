"""Stochastic volatility's two-block sweep, written from ``StochVol_RMHMC.m`` / ``StochVol_mMALA.m``
(Girolami & Calderhead 2011, section 8).

Latent log-volatilities x (T) with x_1 ~ N(0, sigma^2 / (1 - phi^2)),
x_{t+1} = phi x_t + N(0, sigma^2) and y_t ~ N(0, beta^2 e^{x_t}); the hyper
block in theta~ = (beta, log sigma, atanh phi).

* The latent block x | theta (``StochVol_RMHMC.m:115-185``): the metric G =
  iC + I / 2, with iC the AR(1) precision (1 / sigma^2 at both ends, (1 +
  phi^2) / sigma^2 inside, -phi / sigma^2 beside the diagonal), constant in
  x.  "rmhmc": HMC with mass G, momentum L z with G = L L^T (L lower
  bidiagonal), ceil(u_len L) leapfrog steps in the direction of u_dir, every
  step run under a mask, and the kinetic energy 1/2 p^T G^-1 p; "mmala":
  the proposal N(x + eps/2 G^-1 grad, eps G^-1) drawn as mean + sqrt(eps)
  G^-1 L z, with both proposal densities (the log-determinants cancel).
* The hyper block theta~ | x (``:226-277``): the log joint, the priors and
  the Jacobian of the transform; the analytic Fisher-plus-prior metric and
  its derivative; the gradient by autograd of this module's own log density;
  RMHMC or mMALA from ``reference.mcmc``.

Tridiagonal systems are solved by parallel cyclic reduction, which is exact in
float64 on these diagonally dominant systems; the bidiagonal factor by its
recurrence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from portbench.reference import mcmc
from portbench.reference.precision import Precision


def constrain(theta: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    return theta[..., 0], torch.exp(theta[..., 1]), torch.tanh(theta[..., 2])


def matvec(diag: Tensor, off: Tensor, x: Tensor) -> Tensor:
    """A x for the symmetric tridiagonal A = (diag, off)."""
    return diag * x + F.pad(off * x[..., 1:], (0, 1)) + F.pad(off * x[..., :-1], (1, 0))


def bidiag_cholesky(diag: Tensor, off: Tensor) -> tuple[Tensor, Tensor]:
    """(l, e) with A = L L^T, L lower bidiagonal: l its diagonal (T), e below it (T - 1)."""
    ls, es = [torch.sqrt(diag[..., 0])], []
    for i in range(1, diag.shape[-1]):
        es.append(off[..., i - 1] / ls[-1])
        ls.append(torch.sqrt(diag[..., i] - es[-1] * es[-1]))
    return torch.stack(ls, -1), torch.stack(es, -1)


def chol_matvec(l: Tensor, e: Tensor, z: Tensor) -> Tensor:
    """L z."""
    return l * z + F.pad(e * z[..., :-1], (1, 0))


def solve(diag: Tensor, off: Tensor, b: Tensor) -> Tensor:
    """A^-1 b by parallel cyclic reduction (rows past either end act as identity rows)."""
    t = diag.shape[-1]
    lo, mid, hi, rhs = F.pad(off, (1, 0)), diag, F.pad(off, (0, 1)), b

    def before(v: Tensor, s: int, fill: float) -> Tensor:  # v[i - s]
        return F.pad(v[..., : t - s], (s, 0), value=fill)

    def after(v: Tensor, s: int, fill: float) -> Tensor:  # v[i + s]
        return F.pad(v[..., s:], (0, s), value=fill)

    s = 1
    while s < t:
        alpha = -lo / before(mid, s, 1.0)
        gamma = -hi / after(mid, s, 1.0)
        lo, mid, hi, rhs = (alpha * before(lo, s, 0.0),
                            mid + alpha * before(hi, s, 0.0) + gamma * after(lo, s, 0.0),
                            gamma * after(hi, s, 0.0),
                            rhs + alpha * before(rhs, s, 0.0) + gamma * after(rhs, s, 0.0))
        s *= 2
    return rhs / mid


class Model:
    def __init__(self, y, p: Precision, device):
        self.p = p
        self.y2 = p.t(y).to(device) ** 2
        self.t = self.y2.shape[-1]

    # -- latent block --------------------------------------------------------

    def ar1(self, theta: Tensor) -> tuple[Tensor, Tensor]:
        _, sigma, phi = constrain(theta)
        inv_s2 = 1.0 / sigma**2
        ends = torch.zeros(self.t, dtype=torch.bool, device=theta.device)
        ends[0] = ends[-1] = True
        diag = torch.where(ends, inv_s2[:, None], ((1.0 + phi**2) * inv_s2)[:, None])
        return diag, (-phi * inv_s2)[:, None].expand(-1, self.t - 1)

    def latent_logp(self, x: Tensor, theta: Tensor) -> Tensor:
        beta, sigma, phi = constrain(theta)
        innov = x[:, 1:] - phi[:, None] * x[:, :-1]
        return (-(x[:, 0] ** 2) * (1.0 - phi**2) / (2.0 * sigma**2)
                - (x / 2.0 + self.y2 / (2.0 * beta[:, None] ** 2 * torch.exp(x))).sum(-1)
                - (innov**2).sum(-1) / (2.0 * sigma**2))

    def latent_grad(self, x: Tensor, theta: Tensor) -> Tensor:
        beta = theta[:, 0, None]
        diag, off = self.ar1(theta)
        return -0.5 + self.y2 / (2.0 * beta**2 * torch.exp(x)) - matvec(diag, off, x)

    def latent(self, method: str, x: Tensor, theta: Tensor, noise: dict, k: dict) -> mcmc.Proposal:
        p = self.p
        eps = k["latent_step_size"]
        diag, off = self.ar1(theta)
        diag = diag + 0.5
        l, e = bidiag_cholesky(diag, off)
        z = p.t(noise["normal"])
        log_u = torch.log(noise["u_acc"].to(p.dtype))
        if method == "mmala":
            def drift(xc: Tensor) -> Tensor:
                return xc + 0.5 * eps * solve(diag, off, self.latent_grad(xc, theta))

            def quad(delta: Tensor) -> Tensor:
                return (delta * matvec(diag, off, delta)).sum(-1)

            mean = drift(x)
            x_new = mean + eps**0.5 * solve(diag, off, chol_matvec(l, e, z))
            ratio = (self.latent_logp(x_new, theta) - 0.5 * quad(x - drift(x_new)) / eps
                     - self.latent_logp(x, theta) + 0.5 * quad(x_new - mean) / eps)
        elif method == "rmhmc":
            p0 = chol_matvec(l, e, z)
            n_steps = torch.ceil(noise["u_len"].to(torch.float32) * k["latent_num_leapfrog"]).to(torch.int32)
            dt = (torch.where(noise["u_dir"] < 0.5, 1.0, -1.0).to(p.dtype) * eps)[:, None]
            xc, pc, gc = x, p0, self.latent_grad(x, theta)
            for i in range(k["latent_num_leapfrog"]):
                active = (i < n_steps)[:, None]
                half = pc + 0.5 * dt * gc
                xn = xc + dt * solve(diag, off, half)
                gn = self.latent_grad(xn, theta)
                xc = torch.where(active, xn, xc)
                pc = torch.where(active, half + 0.5 * dt * gn, pc)
                gc = torch.where(active, gn, gc)

            def kinetic(mom: Tensor) -> Tensor:
                return 0.5 * (mom * solve(diag, off, mom)).sum(-1)

            ratio = (self.latent_logp(xc, theta) - kinetic(pc)) - (self.latent_logp(x, theta) - kinetic(p0))
            x_new = xc
        else:
            raise ValueError(f"no reference for the latent block of {method!r}")
        divergent = ~(torch.isfinite(ratio) & torch.isfinite(x_new).all(-1))
        return mcmc.Proposal(x_new, ratio, log_u, divergent)

    # -- hyper block -----------------------------------------------------------

    def hyper_logp(self, theta: Tensor, x: Tensor) -> Tensor:
        beta, sigma, phi = constrain(theta)
        t = self.t
        innov = x[:, 1:] - phi[:, None] * x[:, :-1]
        joint = (-(x / 2.0).sum(-1) - t * torch.log(beta)
                 - (self.y2 / (2.0 * beta[:, None] ** 2 * torch.exp(x))).sum(-1)
                 + 0.5 * torch.log(1.0 - phi**2) - torch.log(sigma)
                 - x[:, 0] ** 2 * (1.0 - phi**2) / (2.0 * sigma**2)
                 - (t - 1) * torch.log(sigma) - (innov**2).sum(-1) / (2.0 * sigma**2))
        prior = (-beta - 0.5 / (2.0 * sigma**2) - 6.0 * torch.log(sigma**2) + torch.log(sigma)
                 + 19.0 * torch.log((phi + 1.0) / 2.0) + 0.5 * torch.log((1.0 - phi) / 2.0))
        return joint + prior + torch.log(sigma) + torch.log(1.0 - phi**2)

    def hyper_metric(self, theta: Tensor) -> Tensor:
        beta, sigma, phi = constrain(theta)
        t = self.t
        g = torch.zeros(theta.shape[0], 3, 3, dtype=theta.dtype, device=theta.device)
        g[:, 0, 0] = 2.0 * t / beta**2
        g[:, 1, 1] = 2.0 * t + 1.0 / sigma**2
        g[:, 1, 2] = g[:, 2, 1] = 2.0 * phi
        g[:, 2, 2] = 2.0 * phi**2 + (t - 1 + 39.0) * (1.0 - phi**2)
        return g

    def hyper_dmetric(self, theta: Tensor) -> Tensor:
        """dG/dtheta~_d, (C, 3, 3, 3)."""
        beta, sigma, phi = constrain(theta)
        t = self.t
        dphi = 1.0 - phi**2
        dg = torch.zeros(theta.shape[0], 3, 3, 3, dtype=theta.dtype, device=theta.device)
        dg[:, 0, 0, 0] = -4.0 * t / beta**3
        dg[:, 1, 1, 1] = -2.0 / sigma**2
        dg[:, 2, 1, 2] = dg[:, 2, 2, 1] = 2.0 * dphi
        dg[:, 2, 2, 2] = (4.0 * phi - 2.0 * (t - 1 + 39.0) * phi) * dphi
        return dg

    def hyper(self, method: str, theta: Tensor, x: Tensor, noise: dict, k: dict) -> mcmc.Proposal:
        model = _Hyper(self, x)
        p = self.p
        if method == "rmhmc":
            return mcmc.rmhmc(model, p, theta, p.t(noise["eps"]), noise["u_len"], noise["u_dir"], noise["u_acc"],
                              step_size=k["hyper_step_size"], num_leapfrog=k["hyper_num_leapfrog"],
                              num_fixed_point=k["hyper_num_fixed_point"], jitter=k["hyper_jitter"])
        if method == "mmala":
            return mcmc.mmala(model, p, theta, p.t(noise["eps"]), noise["u_acc"], step_size=k["hyper_step_size"],
                              jitter=k["hyper_jitter"])
        raise ValueError(f"no reference for the hyper block of {method!r}")


class _Hyper:
    """theta~ | x as a model of ``reference.mcmc``."""

    def __init__(self, model: Model, x: Tensor):
        self.m, self.x = model, x

    def metric(self, theta: Tensor) -> Tensor:
        return self.m.hyper_metric(theta)

    def geometry(self, theta: Tensor):
        with torch.inference_mode(False), torch.enable_grad():
            th = theta.detach().clone().requires_grad_(True)
            logp = self.m.hyper_logp(th, self.x)
            (grad,) = torch.autograd.grad(logp.sum(), th)
        return logp.detach(), grad, self.m.hyper_metric(theta), self.m.hyper_dmetric(theta)
