"""BLR RMHMC: operations a chain and transition (Girolami & Calderhead 2011, section 7; ``BLR_RMHMC.m:222-376``).

With N rows, D coefficients, a trajectory of ceil(u L) leapfrog steps
(``BLR_RMHMC.m``'s ``RandomSteps``; (L + 1) / 2 on average, which is what is
counted, though the program runs all L under a mask) and R fixed-point
rounds, a leapfrog step needs:

* the geometry at its new point: logits X w (2 N D), the weights and the log
  density's terms (13 N), the gradient X^T (t - s) (2 N D + N), G's triangle
  sum_n v_n x_n x_n^T (N D (D + 1)), and its factor, inverse and
  log-determinant (D^3);
* the force's base grad - 1/2 tr(G^-1 dG_d) there: s_n = x_n^T G^-1 x_n on
  the triangle (N D (D + 1)) and X^T (c s) (2 N D + N);
* R + 1 momentum rounds (R implicit, 1 explicit), each u = G^-1 p (2 D^2),
  X u and X^T (c (X u)^2) (4 N D) and the weights (3 N), as
  ``yardstick.bounds.fixed_point_bound_us`` counts K5;
* u0 = G^-1 p (2 D^2);
* R position rounds, each the logits (2 N D), G's triangle (N D (D + 1)), a
  factor (D^3 / 3) and two substitutions (2 D^2), as it counts K4;

and a transition adds the momentum's draw (D^2) and the two Hamiltonians'
quadratic forms (4 D^2).  The start point's geometry is the last accepted
point's, which the algorithm keeps.
"""


def step_ops(config: dict, traffic: dict) -> float:
    n, d = config["num_data"], config["num_features"] + 1
    k = traffic["constants"]
    lf, r = k["num_leapfrog"], k["num_fixed_point"]
    tri = n * d * (d + 1)
    geometry = 4 * n * d + 13 * n + n + tri + d**3
    base = tri + 2 * n * d + n
    momentum_round = 2 * d * d + 4 * n * d + 3 * n
    position_round = 2 * n * d + tri + d**3 / 3 + 2 * d * d
    leapfrog = geometry + base + (r + 1) * momentum_round + 2 * d * d + r * position_round
    return (lf + 1) / 2 * leapfrog + 5 * d * d
