"""The arithmetic of a reference run.

* ``FLOAT64``: every operation in float64; the judgment.
* ``TF32``: the control of a configuration stated in float32 with TF32 off.
  Elementwise work and factorizations in float32; every contraction (a matrix
  product or an ``einsum``) takes operands rounded to TF32 (10 explicit
  mantissa bits, round to nearest even) and sums in float32, which is what a
  tensor core does when TF32 is allowed.  The rounding is explicit, so the
  control reads the same on any device.
* ``BFLOAT16``: the control of a configuration stated in float32 whose work
  is elementwise (no contraction for TF32 to act on): every tensor in
  bfloat16; the factorizations, which PyTorch has no bfloat16 kernel for, in
  float32 on bfloat16 operands, their results rounded back.
"""

from __future__ import annotations

import torch
from torch import Tensor


def round_tf32(x: Tensor) -> Tensor:
    """float32 -> the nearest value with 10 explicit mantissa bits (ties to even), as float32."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x0FFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2**31, u - 2**32, u)
    return u.to(torch.int32).view(torch.float32).reshape(x.shape)


class Precision:
    def __init__(self, name: str, dtype: torch.dtype, contract_round=None, factor_dtype: torch.dtype | None = None):
        self.name = name
        self.dtype = dtype
        self._round = contract_round
        self._factor_dtype = factor_dtype or dtype

    def t(self, x) -> Tensor:
        """An input in this precision: a new tensor, outside inference mode."""
        with torch.inference_mode(False):
            return torch.as_tensor(x).detach().to(self.dtype).clone()

    def ein(self, eq: str, *xs: Tensor) -> Tensor:
        if self._round is not None:
            xs = tuple(self._round(x) for x in xs)
        return torch.einsum(eq, *xs)

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self._round is not None:
            a, b = self._round(a), self._round(b)
        return torch.matmul(a, b)

    def cholesky(self, a: Tensor) -> Tensor:
        """Lower factor; NaN in a chain whose matrix is not positive definite."""
        l, info = torch.linalg.cholesky_ex(a.to(self._factor_dtype))
        l = torch.where((info != 0)[..., None, None], torch.nan, l)
        return l.to(self.dtype)

    def tri_solve(self, l: Tensor, b: Tensor, *, upper: bool = False) -> Tensor:
        return torch.linalg.solve_triangular(l.to(self._factor_dtype), b.to(self._factor_dtype),
                                             upper=upper).to(self.dtype)


FLOAT64 = Precision("float64", torch.float64)
TF32 = Precision("tf32", torch.float32, contract_round=round_tf32)
BFLOAT16 = Precision("bfloat16", torch.bfloat16, factor_dtype=torch.float32)
BY_NAME = {p.name: p for p in (FLOAT64, TF32, BFLOAT16)}
