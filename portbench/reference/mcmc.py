"""RMHMC's and mMALA's transitions on any model that gives its geometry, written from the algorithms.

Girolami & Calderhead 2011 (sections 4-5), with the MATLAB code's contract
(``BLR_RMHMC.m:222-376``, ``BLR_mMALA.m``):

* RMHMC: momentum p0 = L eps with G = L L^T; a trajectory of ceil(u_len L)
  generalized-leapfrog steps (0 where u_len = 0) in the direction +1 where
  u_dir < 0.5, else -1, every one of the L steps run under a mask; each step
  an implicit momentum half-step (a fixed point of R rounds from p), an
  implicit position step (R rounds from w, G recomputed at each round's
  point), and an explicit momentum half-step at the new geometry (one
  round); a step that leaves a non-finite point or momentum stops the
  chain's trajectory and marks it divergent.  H = -log pi + 1/2 log|G| +
  1/2 p^T G^-1 p, and the ratio is H(start) - H(end).
* mMALA: the proposal N(mu(w), eps G^-1) with mu(w) = w + eps/2 G^-1 grad
  - eps sum_e (G^-1 dG_e G^-1)[:, e] + eps/2 G^-1 [tr(G^-1 dG_d)]_d, drawn
  as mu + sqrt(eps) L^-T z, and the Metropolis-Hastings ratio with both
  proposal densities.

A model gives ``geometry(w) -> (logp (C,), grad (C, D), G (C, D, D), dG (C,
D, D, D))`` with dG[c, d] = dG/dw_d, and ``metric(w)``.  Each transition
returns a ``Proposal``: the end of the trajectory (or the proposal), the
log ratio, log u and the divergence; the chain moves where the ratio is
finite, the proposal is not divergent and the ratio exceeds log u.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from portbench.reference.precision import Precision


class Proposal(NamedTuple):
    x: Tensor  # (C, D) the trajectory's end or the proposal
    ratio: Tensor  # (C,) log acceptance ratio
    log_u: Tensor  # (C,)
    divergent: Tensor  # (C,) bool

    def accept(self) -> Tensor:
        return torch.isfinite(self.ratio) & ~self.divergent & (self.ratio > self.log_u)

    def moved(self, x: Tensor) -> Tensor:
        """The chain's next state, as the sampler keeps it."""
        return torch.where(self.accept()[:, None], self.x, x)


class _Geo(NamedTuple):
    logp: Tensor
    dg: Tensor
    chol: Tensor
    inv: Tensor
    half_logdet: Tensor
    base: Tensor  # grad - 1/2 tr(G^-1 dG_d)


def _eye(p: Precision, d: int, like: Tensor) -> Tensor:
    return torch.eye(d, dtype=p.dtype, device=like.device)


def _inverse(p: Precision, chol: Tensor) -> Tensor:
    """G^-1 = L^-T L^-1 from L."""
    d = chol.shape[-1]
    linv = p.tri_solve(chol, _eye(p, d, chol).expand(chol.shape))
    return p.ein("...ka,...kb->...ab", linv, linv)


def _solve(p: Precision, g: Tensor, b: Tensor) -> Tensor:
    """G^-1 b by the Cholesky factor."""
    chol = p.cholesky(g)
    y = p.tri_solve(chol, b[..., None])
    return p.tri_solve(chol.mT, y, upper=True)[..., 0]


def rmhmc(model, p: Precision, w: Tensor, eps: Tensor, u_len: Tensor, u_dir: Tensor, u_acc: Tensor, *,
          step_size: float, num_leapfrog: int, num_fixed_point: int, jitter: float = 0.0) -> Proposal:
    """One RMHMC transition from w (C, D) with the draws eps (C, D) ~ N(0, I) and u_len, u_dir, u_acc ~ U[0, 1)."""
    c, d = w.shape
    eye = _eye(p, d, w)

    def geometry(x: Tensor) -> _Geo:
        logp, grad, g, dg = model.geometry(x)
        chol = p.cholesky(g + jitter * eye)
        inv = _inverse(p, chol)
        half_logdet = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        return _Geo(logp, dg, chol, inv, half_logdet, grad - 0.5 * p.ein("cab,cdba->cd", inv, dg))

    def hamiltonian(geo: _Geo, mom: Tensor) -> Tensor:
        return -geo.logp + geo.half_logdet + 0.5 * p.ein("ca,cab,cb->c", mom, geo.inv, mom)

    def momentum(geo: _Geo, mom: Tensor, dt: Tensor, rounds: int) -> Tensor:
        pm = mom
        for _ in range(rounds):
            u = p.ein("cab,cb->ca", geo.inv, pm)
            pm = mom + 0.5 * dt * (geo.base + 0.5 * p.ein("ca,cdab,cb->cd", u, geo.dg, u))
        return pm

    def position(x: Tensor, pm: Tensor, u0: Tensor, dt: Tensor) -> Tensor:
        xf = x
        for _ in range(num_fixed_point):
            xf = x + 0.5 * dt * (u0 + _solve(p, model.metric(xf) + jitter * eye, pm))
        return xf

    geo0 = geometry(w)
    p0 = p.ein("cab,cb->ca", geo0.chol, eps)
    h0 = hamiltonian(geo0, p0)
    n_steps = torch.ceil(u_len.to(torch.float32) * num_leapfrog).to(torch.int32)
    dt = (torch.where(u_dir < 0.5, 1.0, -1.0).to(p.dtype) * step_size)[:, None]

    x, mom, geo = w, p0, geo0
    bad = torch.zeros(c, dtype=torch.bool, device=w.device)
    for i in range(num_leapfrog):
        active = i < n_steps
        pm = momentum(geo, mom, dt, num_fixed_point)
        xf = position(x, pm, p.ein("cab,cb->ca", geo.inv, pm), dt)
        geo_f = geometry(xf)
        pf = momentum(geo_f, pm, dt, 1)
        step_bad = ~(torch.isfinite(xf).all(-1) & torch.isfinite(pf).all(-1))
        ok = active & ~bad & ~step_bad
        x = torch.where(ok[:, None], xf, x)
        mom = torch.where(ok[:, None], pf, mom)
        geo = _Geo(*(torch.where(ok.reshape(-1, *([1] * (a.ndim - 1))), a, b) for a, b in zip(geo_f, geo)))
        bad = bad | (active & step_bad)
    ratio = h0 - hamiltonian(geo, mom)
    return Proposal(x, ratio, torch.log(u_acc.to(p.dtype)), bad | ~torch.isfinite(ratio))


def mmala(model, p: Precision, w: Tensor, z: Tensor, u_acc: Tensor, *, step_size: float,
          jitter: float = 0.0) -> Proposal:
    """One mMALA transition from w (C, D) with the draws z (C, D) ~ N(0, I) and u_acc ~ U[0, 1)."""
    d = w.shape[-1]
    eye = _eye(p, d, w)
    eps = step_size

    def geometry(x: Tensor):
        logp, grad, g, dg = model.geometry(x)
        g = g + jitter * eye
        chol = p.cholesky(g)
        linv = p.tri_solve(chol, eye.expand(g.shape))
        inv = p.ein("cka,ckb->cab", linv, linv)
        drift = (0.5 * eps * p.ein("cab,cb->ca", inv, grad)
                 - eps * p.ein("cia,ceab,cbe->ci", inv, dg, inv)
                 + 0.5 * eps * p.ein("cab,cb->ca", inv, p.ein("cab,cdba->cd", inv, dg)))
        # log N(.; mean, eps G^-1) needs log|eps G^-1|^(1/2) = -sum log diag L + D/2 log eps.
        half_logdet = -torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1) + 0.5 * d * torch.log(
            torch.tensor(eps, dtype=p.dtype))
        return logp, x + drift, g, linv.mT, half_logdet

    def log_q(mean: Tensor, x: Tensor, g: Tensor, half_logdet: Tensor) -> Tensor:
        delta = mean - x
        return -half_logdet - 0.5 * p.ein("ca,cab,cb->c", delta, g, delta) / eps

    logp, mean, g, cov, half = geometry(w)
    w_new = mean + eps**0.5 * p.ein("cab,cb->ca", cov, z)
    logp_n, mean_n, g_n, _, half_n = geometry(w_new)
    ratio = logp_n + log_q(mean_n, w, g_n, half_n) - logp - log_q(mean, w_new, g, half)
    divergent = ~(torch.isfinite(ratio) & torch.isfinite(w_new).all(-1))
    return Proposal(w_new, ratio, torch.log(u_acc.to(p.dtype)), divergent)
