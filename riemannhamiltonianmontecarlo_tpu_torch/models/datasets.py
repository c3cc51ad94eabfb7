"""Dataset loading and preprocessing for the Bayesian logistic-regression zoo.

Reproduces the reference preprocessing contract (``code/main.py:22-41`` and
the MATLAB ``BLR_RMHMC.m:16-32``):

* label column is last; ``heart`` / ``german`` encode labels as {1, 2} and
  are remapped to {0, 1} (``code/main.py:26-27``).
* features standardized column-wise to zero mean / unit variance
  (``code/main.py:37``).
* basis expansion: intercept column of ones prepended (``code/main.py:40-41``);
  ``ripley`` additionally uses a cubic polynomial basis (powers 1..3 of each
  feature, no cross terms -> 1 + 2*3 = 7 coefficients, ``BLR_RMHMC.m:155,171``
  with Polynomial_Order = 3, matching "7 coefficients" in paper Table 7).

The reference checkout ships the CSVs under ``code/data``; this framework
does not bundle them (they are public UCI/Ripley datasets).  ``load_dataset``
searches ``$RHMC_DATA_DIR`` and ``<repo>/data``, and tests fall back to
:func:`synthetic_logreg`.

A NumPy-only copy of ``riemannhamiltonianmontecarlo_tpu/models/datasets.py``
(whose package imports jax); ``synthetic_logreg`` is bit-identical, so both
packages can be fed the same data.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import numpy as np

DATASET_SPECS = {
    # name: (num_features, labels_in_one_two, polynomial_order)
    "australian": (14, False, 1),
    "german": (24, True, 1),
    "heart": (13, True, 1),
    "pima": (7, False, 1),
    "ripley": (2, False, 3),
}

_SEARCH_PATHS = (
    os.environ.get("RHMC_DATA_DIR", ""),
    str(Path(__file__).resolve().parents[2] / "data"),
)


class Dataset(NamedTuple):
    X: np.ndarray  # (N, D) design matrix incl. basis expansion
    t: np.ndarray  # (N,) labels in {0, 1}
    name: str


def find_data_file(filename: str) -> Path | None:
    """``filename`` in ``$RHMC_DATA_DIR`` or ``<repo>/data``, or None."""
    for base in _SEARCH_PATHS:
        if base and (Path(base) / filename).exists():
            return Path(base) / filename
    return None


def _find_csv(name: str) -> Path:
    p = find_data_file(f"{name}.csv")
    if p is not None:
        return p
    raise FileNotFoundError(
        f"dataset '{name}' not found; searched {_SEARCH_PATHS}. "
        "Set RHMC_DATA_DIR or use synthetic_logreg()."
    )


def polynomial_basis(X: np.ndarray, order: int) -> np.ndarray:
    """[1, X, X^2, ..., X^order] column blocks (no cross terms)."""
    n = X.shape[0]
    cols = [np.ones((n, 1), dtype=X.dtype)]
    for k in range(1, order + 1):
        cols.append(X**k)
    return np.hstack(cols)


def preprocess(raw: np.ndarray, *, one_two_labels: bool, poly_order: int, name: str = "") -> Dataset:
    t = raw[:, -1].astype(np.float64)
    if one_two_labels:
        t = t - 1.0
    X = raw[:, :-1].astype(np.float64)
    X = (X - X.mean(axis=0)) / X.std(axis=0)
    XX = polynomial_basis(X, poly_order)
    return Dataset(XX, t, name)


def load_dataset(name: str, path: str | os.PathLike | None = None) -> Dataset:
    """Load one of the five reference datasets with reference preprocessing."""
    if name not in DATASET_SPECS:
        raise KeyError(f"unknown dataset '{name}'; options: {sorted(DATASET_SPECS)}")
    _, one_two, poly = DATASET_SPECS[name]
    csv = Path(path) if path is not None else _find_csv(name)
    raw = np.loadtxt(csv, delimiter=",")
    return preprocess(raw, one_two_labels=one_two, poly_order=poly, name=name)


def synthetic_logreg(
    seed: int = 0, n: int = 400, d: int = 8, *, w_scale: float = 1.5
) -> Dataset:
    """Synthetic logistic-regression data with a known generating weight.

    Standardized Gaussian features + intercept, labels from the true
    logistic model -- used by tests when the reference CSVs are absent and
    for posterior-concentration checks (the reference's known-truth pattern,
    cf. StochVol/FHN data generation, SURVEY.md section 4.5).
    """
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d - 1))
    X = (X - X.mean(0)) / X.std(0)
    XX = np.hstack([np.ones((n, 1)), X])
    w_true = rng.normal(size=d) * w_scale
    p = 1.0 / (1.0 + np.exp(-XX @ w_true))
    t = (rng.uniform(size=n) < p).astype(np.float64)
    return Dataset(XX, t, f"synthetic-{seed}")
