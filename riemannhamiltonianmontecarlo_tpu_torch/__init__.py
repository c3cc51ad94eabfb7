"""PyTorch / CUDA port of the Riemann-manifold MCMC framework.

The port of ``riemannhamiltonianmontecarlo_tpu`` (JAX on a TPU) to PyTorch
with hand-written CUDA kernels for NVIDIA Hopper.  It keeps the JAX
package's sub-package layout and function names, so each module has an
obvious counterpart; the JAX package is the reference the port is tested
against.  The port imports ``torch`` and ``numpy``, never ``jax``.

Ported so far (the main path: Bayesian logistic regression sampled by
RMHMC):

* :mod:`.models` -- ``LogisticRegression`` (an ``nn.Module``), datasets;
* :mod:`.ops` -- chain-batched small-matrix linalg, dispatching 3-D CUDA
  batches to the hand-written Cholesky kernels of ``ops/hopper_linalg.py``;
* :mod:`.samplers` -- ``rmhmc`` (pure ``transition(state, noise)`` plus a
  ``step(generator, state)`` that draws the noise);
* :mod:`.parallel` -- the chain runner;
* :mod:`.diagnostics` -- Geyer ESS and split R-hat (host NumPy);
* :mod:`.utils` -- MAP + jitter initialization;
* :mod:`.interop` -- the JAX package's arrays (as NumPy) to port objects.
"""

__version__ = "0.1.0"

from riemannhamiltonianmontecarlo_tpu_torch import _precision  # noqa: F401  (first: fp32 matmuls)
from riemannhamiltonianmontecarlo_tpu_torch import (
    diagnostics,
    interop,
    models,
    ops,
    parallel,
    samplers,
    utils,
)

__all__ = [
    "models",
    "samplers",
    "ops",
    "parallel",
    "diagnostics",
    "utils",
    "interop",
    "__version__",
]
