"""The card's published peaks, and the least time each hand-written kernel of the program could take.

Frozen copies of ``chip_smoke.py``'s yardsticks (lines 628-665 and 1038-1052 of the
tree this benchmark was added to): each input byte read once, each output
byte written once, operations counted from the shapes, and the bound the larger
of bytes over the memory's bandwidth and operations over float32's peak.  The
program runs its float32 contractions with TF32 off, so float32 outside the
tensor cores is its ceiling.  A kernel's ``<kernel>_roofline`` is its bound
over its measured time; a share above 100% means that the count is too high or
the time leaves out work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full power limit of 700 W.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def _bound(floats: float, ops: float) -> float:
    return max(1e6 * 4 * floats / HBM_BYTES_PER_S, 1e6 * ops / FP32_OPS_PER_S)


def bound_us(name: str, c: int, d: int) -> float:
    """K1 (``cholesky``), K2 (``chol_solve_logdet``) or K3 (``chol_inv_logdet``) on a (C, D, D) float32 batch.
    Bytes: K1 G in, L out; K2 G and b in, x and log|G| out; K3 G in, L, G^-1 and 1/2 log|G| out.
    Operations: D^3 / 3 a chain for the factor, 2 D^2 more for K2's two substitutions, and for K3 D^3 / 3
    more each for L^-1 and L^-T L^-1."""
    floats = {"cholesky": 2 * c * d * d, "chol_solve_logdet": c * d * d + 2 * c * d + c,
              "chol_inv_logdet": 3 * c * d * d + c}[name]
    ops = c * d**3 / 3 * (3 if name == "chol_inv_logdet" else 1) + (2 * c * d * d if name == "chol_solve_logdet" else 0)
    return _bound(floats, ops)


def bidiag_bound_us(b: int, t: int) -> float:
    """T1 on (B, T): diag and off in, ld and e out (2 B (2 T - 1) floats); a division, a multiply-add and a
    square root a position (3 B (T - 1) + B operations)."""
    return _bound(2 * b * (2 * t - 1), 3 * b * (t - 1) + b)


def pcr_bound_us(b: int, t: int) -> float:
    """T2 on (B, T): diag and b in, x out, off one float a row (3 B T + B floats); 14 operations a position and
    round over ceil(log2 T) rounds, and the last division a position."""
    rounds = (t - 1).bit_length()
    return _bound(3 * b * t + b, b * t * (14 * rounds + 1))


def fixed_point_bound_us(name: str, c: int, n: int, d: int, rounds: int) -> float:
    """K4 (``position_fixed_point``) or K5 (``momentum_fixed_point``), ``rounds`` rounds on C chains and N rows
    of width D.  Bytes: K4 X, w, pm, u0 and dt in, wf out; K5 X, G^-1, c, p, pm0, base and dt in, pm out.
    Operations a chain and round: K4 2 N D for the logits, N D (D + 1) for G's triangle, D^3 / 3 for the
    factor and 2 D^2 for the substitutions; K5 2 D^2 for u = G^-1 pm, 2 N D each for X u and the sum of
    c (x_n u)^2 x_n, and 3 N for the weights."""
    if name == "position_fixed_point":
        floats = n * d + 4 * c * d + c
        ops = c * rounds * (2 * n * d + n * d * (d + 1) + d**3 / 3 + 2 * d * d)
    else:
        floats = n * d + c * d * d + c * n + 4 * c * d + c
        ops = c * rounds * (2 * d * d + 4 * n * d + 3 * n)
    return _bound(floats, ops)
