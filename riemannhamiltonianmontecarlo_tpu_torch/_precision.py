"""Full fp32 for every contraction that feeds a log density, G or an MH ratio.

The analog of the JAX package's ``jax.lax.Precision.HIGHEST``
(``models/logreg.py:38-41``, ``ops/linalg.py:29-30``): MH acceptance compares
log densities to O(1), and TF32 keeps only about three decimal digits.  The
package's ``__init__`` imports this module before any model or sampler code,
so the settings hold from the first matmul and einsum on.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def set_full_fp32() -> None:
    """Turn TF32 off for cuBLAS and cuDNN and ask for full fp32 matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def tf32_matmuls() -> Iterator[None]:
    """Allow TF32 in cuBLAS matmuls inside the block, and restore the flag after.

    For in-trajectory work only (``samplers/phmc.py`` ``trajectory_precision``):
    whatever feeds an MH test runs outside it, in full fp32.
    """
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def precision_flags() -> dict:
    """The settings as they stand, for logs."""
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


set_full_fp32()
