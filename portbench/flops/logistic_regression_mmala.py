"""BLR mMALA: operations a chain and transition (Girolami & Calderhead 2011, section 5; ``BLR_mMALA.m``).

With N rows and D coefficients, a transition needs the geometry at the
proposal: logits (2 N D), the weights and the log density's terms (13 N), the
gradient (2 N D + N), G's triangle (N D (D + 1)), its factor, L^-1 and G^-1 =
L^-T L^-1 (D^3); the curvature terms' s_n = x_n^T G^-1 x_n on the triangle
(N D (D + 1)) and X^T (c s) (2 N D + N), whose product with G^-1 gives both
the trace vector and sum_e G^-1 dG_e G^-1; the drift's three products with
G^-1 (6 D^2); the proposal's L^-T z (D^2); and the two proposal densities'
quadratic forms (4 D^2).  The current point's geometry is kept from when it
was proposed.
"""


def step_ops(config: dict, traffic: dict) -> float:
    n, d = config["num_data"], config["num_features"] + 1
    tri = n * d * (d + 1)
    geometry = 4 * n * d + 14 * n + tri + d**3
    curvature = tri + 2 * n * d + n
    return geometry + curvature + 11 * d * d
