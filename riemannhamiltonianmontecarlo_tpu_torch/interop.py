"""The JAX package's weights and state, as NumPy arrays, into port objects.

Takes NumPy arrays (``np.asarray`` of the JAX package's arrays) and never
imports jax, so both packages can be made to compute on identical inputs.
Every converter puts its result on ``device``, ``"cuda"`` unless the caller
asks for the CPU, as ``experiments.run_experiment`` does.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from riemannhamiltonianmontecarlo_tpu_torch.models.fhn import FHNModel
from riemannhamiltonianmontecarlo_tpu_torch.models.lgc import LGCJointModel, LGCModel
from riemannhamiltonianmontecarlo_tpu_torch.models.logreg import LogisticRegression
from riemannhamiltonianmontecarlo_tpu_torch.models.stochvol import StochVolModel
from riemannhamiltonianmontecarlo_tpu_torch.parallel.adaptation import AdaptiveState, DualAveragingState
from riemannhamiltonianmontecarlo_tpu_torch.samplers.rmhmc import RMHMCState, _Geometry


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    # A copy: arrays from JAX are read-only, and the port owns its tensors.
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def logreg_from_numpy(
    X: np.ndarray,
    t: np.ndarray,
    alpha: float = 100.0,
    mask: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> LogisticRegression:
    """``LogisticRegression`` (float32) on ``device`` from the design matrix, labels and mask."""
    return LogisticRegression(
        _tensor(X, device),
        _tensor(t, device),
        alpha=alpha,
        mask=None if mask is None else _tensor(mask, device),
    )


def stochvol_from_numpy(y: np.ndarray, device: str | torch.device = "cuda") -> StochVolModel:
    """``StochVolModel`` (float32) on ``device`` from the observations y (T,)."""
    return StochVolModel(_tensor(y, device))


def lgc_from_numpy(
    y: np.ndarray,
    n: int,
    sigma_inv: np.ndarray | None = None,
    metric_chol: np.ndarray | None = None,
    metric_inv: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> LGCModel:
    """``LGCModel`` on ``device`` from the counts y (n^2,).

    The dense (n^2, n^2) operators are taken as given where passed (e.g. the
    JAX model's float32 ``sigma_inv``, ``metric_chol`` and ``metric_inv``, so
    that both packages compute on identical constants); any not given are
    computed in float64 on the host.
    """
    ops = {"sigma_inv": sigma_inv, "metric_chol": metric_chol, "metric_inv": metric_inv}
    return LGCModel(_tensor(y, device), n=n, **{k: None if v is None else _tensor(v, device) for k, v in ops.items()})


def lgc_joint_from_numpy(y: np.ndarray, n: int, device: str | torch.device = "cuda", **constants) -> LGCJointModel:
    """``LGCJointModel`` on ``device`` from the counts y (n^2,).

    ``constants``: ``gamma_k``, ``gamma_theta``, ``init_sigma_sq``,
    ``init_beta`` where they differ from the reference's.  The model holds
    no precomputed operator: both packages build the grid distances from n.
    """
    return LGCJointModel(_tensor(y, device), n=n, device=device, **constants)


def fhn_from_numpy(data: np.ndarray, device: str | torch.device = "cuda", **constants) -> FHNModel:
    """``FHNModel`` (float32) on ``device`` from the observations (num_obs, 2).

    ``constants``: ``noise_sd``, ``substeps``, ``gamma_scale`` where they
    differ from the reference's (0.5, 5, 3.0).
    """
    return FHNModel(_tensor(data, device), **constants)


def rmhmc_state_from_numpy(
    position: np.ndarray,
    logp: np.ndarray,
    geo: dict | None = None,
    device: str | torch.device = "cuda",
) -> RMHMCState:
    """``RMHMCState`` from the JAX state's fields.

    ``geo`` is None (the port rebuilds the geometry lazily) or a dict of the
    ``_Geometry`` fields (``logp, grad, metric, cache, chol, inv,
    half_logdet``), e.g. ``state.geo._asdict()`` of a JAX ``RMHMCState``.
    """
    g = None
    if geo is not None:
        g = _Geometry(**{name: _tensor(geo[name], device) for name in _Geometry._fields})
    return RMHMCState(_tensor(position, device), _tensor(logp, device), g)


def _fields(state: Any) -> Mapping[str, Any]:
    return state._asdict() if hasattr(state, "_asdict") else state


def state_from_numpy(state_type: type, fields: Any, device: str | torch.device = "cuda"):
    """A port sampler state of ``state_type`` from the JAX state's fields.

    ``state_type`` is a flat state NamedTuple of the port: ``HMCState``,
    ``MALAState``, ``AMHState``, ``MMALAState``, ``IWLSState``,
    ``GibbsState``, ``StochVolState``, ``LGCJointState``, ``PHMCState``,
    ``PMALAState`` or ``DualAveragingState``.  ``fields`` is the JAX state
    (a NamedTuple of arrays) or a dict of its fields, by the same names.
    Each array is copied with its dtype (float32 stays float32, the int32
    counters stay int32).
    """
    f = _fields(fields)
    return state_type(**{name: torch.from_numpy(np.array(f[name])).to(device) for name in state_type._fields})


def adaptive_state_from_numpy(inner_type: type, fields: Any, device: str | torch.device = "cuda") -> AdaptiveState:
    """``AdaptiveState`` from the JAX one: ``inner`` of ``inner_type`` plus the dual-averaging state."""
    f = _fields(fields)
    return AdaptiveState(
        state_from_numpy(inner_type, f["inner"], device),
        state_from_numpy(DualAveragingState, f["da"], device),
    )
