"""Model interface for manifold MCMC.

Port of ``riemannhamiltonianmontecarlo_tpu/models/base.py``.  A model is an
object that samplers consume; every method is batched over leading (chain)
axes.  Manifold samplers never need the dense third-order tensor dG, only
three contractions:

* ``dg_bilinear(w, u, v)[d]  = u^T (dG/dw_d) v``
* ``dg_trace(w, M)[d]        = tr(M dG/dw_d)``          (M symmetric)
* ``dg_dotted(w, M)[d]       = sum_e (M (dG/dw_e) M)[d, e]``  (mMALA drift)

Models without closed forms derive everything from ``logp`` / ``metric``
via :func:`autodiff_manifold`.  The derivatives use ``torch.func`` (``grad``,
``jacrev``, ``vmap``), always through :func:`with_autograd`: the chain
runner steps under ``torch.inference_mode()``, where torch 2.11's ``grad``
and ``jacrev`` return zeros without an error (torch 2.13 differentiates).
The metric jacobian is reverse mode (``jacrev``): forward mode (``jacfwd``,
the JAX package's choice) gives the same dG but took 5.8 ms against 2.5 ms
for the StochVol hyper metric at 1024 chains on an H100, and under
inference mode in torch 2.11 it raises (no ``vmap`` rule for ``_make_dual``).
"""

from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

import torch
from torch import Tensor
from torch.func import grad, jacrev, vmap


@runtime_checkable
class Model(Protocol):
    """Minimal interface: an unnormalized log density and its gradient."""

    dim: int

    def logp(self, w: Tensor) -> Tensor:
        """Log joint density.  w: (..., D) -> (...)."""
        ...

    def grad(self, w: Tensor) -> Tensor:
        """Gradient of ``logp``.  w: (..., D) -> (..., D)."""
        ...


@runtime_checkable
class ManifoldModel(Model, Protocol):
    """Adds the Fisher-metric interface needed by RMHMC / mMALA.

    ``cache`` is an opaque per-position object from :meth:`dg_cache` that
    lets the dG contractions reuse work across the fixed-point iterations of
    a generalized-leapfrog step (for autodiff models the dense (..., D, D, D)
    metric jacobian).
    """

    def metric(self, w: Tensor) -> Tensor:
        """Fisher metric G(w).  (..., D) -> (..., D, D), symmetric PD."""
        ...

    def dg_cache(self, w: Tensor):
        """Precompute whatever the dG contractions need at ``w``."""
        ...

    def dg_bilinear(self, w: Tensor, u: Tensor, v: Tensor, *, cache=None) -> Tensor:
        """[u^T dG_d v]_d.  (..., D) x (..., D) x (..., D) -> (..., D)."""
        ...

    def dg_trace(self, w: Tensor, m: Tensor, *, cache=None) -> Tensor:
        """[tr(M dG_d)]_d for symmetric M.  (..., D, D) -> (..., D)."""
        ...

    def dg_dotted(self, w: Tensor, m: Tensor, *, cache=None) -> Tensor:
        """[sum_e (M dG_e M)[d, e]]_d  (mMALA curvature drift term)."""
        ...


def with_autograd(fn: Callable[..., Tensor]) -> Callable[..., Tensor]:
    """``fn``, a ``torch.func`` transform, run with inference mode off.

    Inside ``torch.inference_mode()`` it runs under ``inference_mode(False)``
    on clones of the inference-tensor arguments, which autograd may then
    save; elsewhere it runs as it is.  It moves no number between the host
    and the device, so a CUDA graph can capture it: the clones come from the
    graph's pool, and the backward pass, which autograd runs on its own
    device thread, is recorded on the capturing stream as the forward is
    (the StochVol hyper block runs it captured).
    """

    def run(*args: Tensor) -> Tensor:
        if not torch.is_inference_mode_enabled():
            return fn(*args)
        with torch.inference_mode(False):
            return fn(*(a.clone() if a.is_inference() else a for a in args))

    return run


def batched(fn: Callable, w: Tensor, *args: Tensor) -> Tensor:
    """Apply ``fn`` written for one position (D,) over the leading axes of w
    (and args), through :func:`with_autograd`."""
    if w.ndim == 1:
        return with_autograd(fn)(w, *args)
    lead = w.shape[:-1]
    flat = [a.reshape((-1,) + a.shape[len(lead):]) for a in (w, *args)]
    out = with_autograd(vmap(fn))(*flat)
    return out.reshape(lead + out.shape[1:])


class FunctionModel:
    """Wrap a plain ``logp`` callable of one position (D,) into a :class:`Model`."""

    def __init__(self, dim: int, logp_fn: Callable[[Tensor], Tensor]):
        self.dim = dim
        self.logp_fn = logp_fn

    def logp(self, w: Tensor) -> Tensor:
        return batched(self.logp_fn, w)

    def grad(self, w: Tensor) -> Tensor:
        return batched(grad(self.logp_fn), w)


class _AutodiffManifold:
    """Delegates logp / grad to ``model``; geometry from ``metric_fn`` by jacrev."""

    def __init__(self, model: Model, metric_fn: Callable[[Tensor], Tensor]):
        self.dim = model.dim
        self._model = model
        self._metric_fn = metric_fn

    def logp(self, w: Tensor) -> Tensor:
        return self._model.logp(w)

    def grad(self, w: Tensor) -> Tensor:
        return self._model.grad(w)

    def metric(self, w: Tensor) -> Tensor:
        return batched(self._metric_fn, w)

    def dg_cache(self, w: Tensor) -> Tensor:
        """Dense metric jacobian (..., D, D, D), jac[d] = dG/dw_d, reused across calls."""
        return batched(lambda v: torch.movedim(jacrev(self._metric_fn)(v), -1, 0), w)

    def _cache(self, w: Tensor, cache) -> Tensor:
        return self.dg_cache(w) if cache is None else cache

    def dg_bilinear(self, w, u, v, *, cache=None):
        return torch.einsum("...dab,...a,...b->...d", self._cache(w, cache), u, v)

    def dg_trace(self, w, m, *, cache=None):
        return torch.einsum("...dab,...ba->...d", self._cache(w, cache), m)

    def dg_dotted(self, w, m, *, cache=None):
        return torch.einsum("...ia,...eab,...be->...i", m, self._cache(w, cache), m)


def autodiff_manifold(model: Model, metric_fn: Callable[[Tensor], Tensor]) -> _AutodiffManifold:
    """Derive the dG contractions of a :class:`ManifoldModel` by autodiff.

    ``metric_fn`` maps a single position (D,) to G (D, D).  The full jacobian
    dG (D, D, D) is built with ``torch.func.jacrev`` (D reverse passes,
    vmapped) and contracted: O(D^3) storage per chain, fine for small D.
    """
    return _AutodiffManifold(model, metric_fn)
