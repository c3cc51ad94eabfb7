"""StochVol RMHMC-within-Gibbs: operations a chain and sweep (``StochVol_RMHMC.m``; Girolami & Calderhead
2011, section 8).

Latent block, T positions and a trajectory of ceil(u L_x) leapfrog steps,
(L_x + 1) / 2 on average (the program runs all L_x under a mask): the
bidiagonal factor of G = iC + I / 2 (3 T) and the momentum L z (3 T); each
step a half-step (2 T), a solve with the factor (forward and backward
substitution, 6 T), the position update (2 T), the gradient s - iC x (4 T for
s, 5 T for iC x, T for the difference) and the other half-step (2 T): 22 T;
the gradient at the start (10 T); the log density at both ends (9 T each) and
the kinetic energy at both ends (a solve and a dot product, 8 T each).

Hyper block, D = 3: the log density and its gradient over the T positions
(16 T) at the start and at each of the (L_h + 1) / 2 leapfrog steps' new points
on average; the
metric and its derivative are analytic in theta and the 3 x 3 algebra is
negligible beside them.
"""


def step_ops(config: dict, traffic: dict) -> float:
    t = config["num_obs"]
    k = traffic["constants"]
    latent = 3 * t + 3 * t + 22 * t * (k["latent_num_leapfrog"] + 1) / 2 + 10 * t + 18 * t + 16 * t
    hyper = 16 * t * ((k["hyper_num_leapfrog"] + 1) / 2 + 1)
    return latent + hyper
