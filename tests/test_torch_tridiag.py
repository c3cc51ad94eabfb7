"""Port parity: the batched tridiagonal ops against the JAX package's.

The same numpy-seeded diagonally dominant PD systems go through both
``ops.tridiag`` modules at T in {7, 64, 2000}.  Tolerance: atol 1e-5 times
the scale of the reference output (max |ref|), float32 on both sides with
the same operations in the same order; the bidiagonal factor is a
length-T recurrence and the PCR solve ceil(log2 T) rounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riemannhamiltonianmontecarlo_tpu.ops import tridiag as jtri
from riemannhamiltonianmontecarlo_tpu_torch.ops import tridiag as ttri

torch.set_num_threads(1)
BATCH = 4


def system(t: int):
    rng = np.random.default_rng(t)
    off = (rng.normal(size=(BATCH, t - 1)) * 0.4).astype(np.float32)
    diag = (2.0 + rng.uniform(size=(BATCH, t))).astype(np.float32)
    b = rng.normal(size=(BATCH, t)).astype(np.float32)
    return diag, off, b


def close(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("t", [7, 64, 2000])
def test_torch_tridiag_ops_match_jax(t):
    diag, off, b = system(t)
    jd, jo, jb = jnp.asarray(diag), jnp.asarray(off), jnp.asarray(b)
    td, to, tb = torch.from_numpy(diag), torch.from_numpy(off), torch.from_numpy(b)

    jchol, tchol = jtri.cholesky(jd, jo), ttri.cholesky(td, to)
    assert tchol.ld.shape == (BATCH, t) and tchol.e.shape == (BATCH, t - 1)
    close(tchol.ld, jchol.ld)
    close(tchol.e, jchol.e)
    close(ttri.logdet_from_chol(tchol), jtri.logdet_from_chol(jchol))
    close(ttri.matvec_chol(tchol, tb), jtri.matvec_chol(jchol, jb))
    close(ttri.matvec(td, to, tb), jtri.matvec(jd, jo, jb))
    x = ttri.solve(td, to, tb)
    close(x, jtri.solve(jd, jo, jb))
    # and it solves the system
    close(ttri.matvec(td, to, x), b)


def test_torch_tridiag_factor_reproduces_the_matrix():
    """L L^T == G in float64: ld^2 + e^2 on the diagonal, ld e below it."""
    diag, off, _ = system(50)
    chol = ttri.cholesky(torch.from_numpy(diag).double(), torch.from_numpy(off).double())
    ld, e = chol.ld.numpy(), chol.e.numpy()
    np.testing.assert_allclose(ld**2 + np.pad(e**2, ((0, 0), (1, 0))), diag, rtol=1e-12)
    np.testing.assert_allclose(ld[:, :-1] * e, off, rtol=1e-12)
