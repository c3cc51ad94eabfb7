"""Bayesian logistic regression's geometry, written from its equations (Girolami & Calderhead 2011, section 7).

log pi(w) = t^T X w - sum_n log(1 + e^{x_n^T w}) - |w|^2 / (2 alpha) (+ a constant);
grad = X^T (t - s) - w / alpha with s = sigma(X w);
G(w) = X^T diag(v) X + I / alpha with v = s (1 - s);
dG/dw_d = sum_n c_n x_nd x_n x_n^T with c = v (1 - 2 s).
"""

from __future__ import annotations

import torch
from torch import Tensor

from portbench.reference import mcmc
from portbench.reference.precision import Precision


class Model:
    def __init__(self, x, t, alpha: float, p: Precision, device):
        self.p = p
        self.x = p.t(x).to(device)  # (N, D)
        self.t = p.t(t).to(device)
        self.alpha = alpha
        n, d = self.x.shape
        self.d = d
        self.x2 = (self.x[:, :, None] * self.x[:, None, :]).reshape(n, d * d)
        self.x3 = (self.x[:, :, None, None] * self.x[:, None, :, None] * self.x[:, None, None, :]).reshape(n, d**3)

    def _eye(self, like: Tensor) -> Tensor:
        return torch.eye(self.d, dtype=self.p.dtype, device=like.device)

    def metric(self, w: Tensor) -> Tensor:
        s = torch.sigmoid(self.p.mm(w, self.x.T))
        return self.p.mm(s * (1 - s), self.x2).reshape(-1, self.d, self.d) + self._eye(w) / self.alpha

    def geometry(self, w: Tensor):
        p = self.p
        f = p.mm(w, self.x.T)
        s = torch.sigmoid(f)
        v = s * (1 - s)
        logp = (f * self.t - torch.nn.functional.softplus(f)).sum(-1) - 0.5 * (w * w).sum(-1) / self.alpha
        grad = p.mm(self.t - s, self.x) - w / self.alpha
        g = p.mm(v, self.x2).reshape(-1, self.d, self.d) + self._eye(w) / self.alpha
        dg = p.mm(v * (1 - 2 * s), self.x3).reshape(-1, self.d, self.d, self.d)
        return logp, grad, g, dg


def transition(sampler: str, model: Model, w: Tensor, noise: dict, constants: dict) -> mcmc.Proposal:
    """One transition of ``sampler`` ("rmhmc" or "mmala") from w with the draws ``noise`` (the sampler's names)."""
    p = model.p
    if sampler == "rmhmc":
        return mcmc.rmhmc(model, p, w, p.t(noise["eps"]), noise["u_len"], noise["u_dir"], noise["u_acc"],
                          step_size=constants["step_size"], num_leapfrog=constants["num_leapfrog"],
                          num_fixed_point=constants["num_fixed_point"])
    if sampler == "mmala":
        return mcmc.mmala(model, p, w, p.t(noise["eps"]), noise["u_acc"], step_size=constants["step_size"])
    raise ValueError(f"no reference for sampler {sampler!r}")
