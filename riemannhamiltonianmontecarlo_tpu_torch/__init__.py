"""PyTorch / CUDA port of the Riemann-manifold MCMC framework.

The port of ``riemannhamiltonianmontecarlo_tpu`` (JAX on a TPU) to PyTorch
with hand-written CUDA kernels for NVIDIA Hopper.  It keeps the JAX
package's sub-package layout and function names, so each module has an
obvious counterpart; the JAX package is the reference the port is tested
against.  The port imports ``torch`` and ``numpy``, never ``jax``.

The four workloads are ported (Bayesian logistic regression with every
sampler, stochastic volatility, log-Gaussian Cox with known and with unknown
hyperparameters, FitzHugh-Nagumo):

* :mod:`.models` -- ``LogisticRegression`` (an ``nn.Module``), datasets,
  ``StochVolModel``, ``LGCModel``, ``LGCJointModel``, ``FHNModel``;
* :mod:`.ops` -- chain-batched small-matrix linalg, dispatching 3-D CUDA
  batches to the hand-written Cholesky kernels of ``ops/hopper_linalg.py``;
  the FitzHugh-Nagumo sensitivity kernel of ``ops/fhn_sens.py``; the
  truncated-normal and GIG samplers of the Gibbs sampler;
* :mod:`.samplers` -- ``rmhmc``, ``hmc``, ``mala``, ``metropolis``,
  ``mmala``, ``iwls``, ``gibbs``, ``stochvol``, ``phmc``, ``pmala`` and
  ``lgc_joint`` (each a pure
  ``transition(state, noise)`` plus a ``step(generator, state)`` that draws
  the noise);
* :mod:`.parallel` -- the chain runner, its checkpointed form
  (``run_checkpointed``) and dual-averaging adaptation;
* :mod:`.diagnostics` -- Geyer ESS, split R-hat (host NumPy and on the
  device) and Geweke z;
* :mod:`.utils` -- reference presets, MAP + jitter initialization,
  checkpoint / resume of state trees;
* :mod:`.interop` -- the JAX package's arrays (as NumPy) to port objects;
* ``experiments`` (imported on its own) -- the experiment layer and its
  CLI, ``python -m riemannhamiltonianmontecarlo_tpu_torch.experiments``;
  ``tools.run_lgc_joint`` -- the joint LGC run in resumable segments.
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
