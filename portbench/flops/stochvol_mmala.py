"""StochVol mMALA-within-Gibbs: operations a chain and sweep (``StochVol_mMALA.m``; Girolami & Calderhead 2011,
section 8).

Latent block, T positions: the bidiagonal factor of G = iC + I / 2 (3 T); the
drift x + eps/2 G^-1 grad at both ends, each a gradient (10 T), a solve (6 T)
and an update (2 T); the proposal's G^-1 L z (3 T + 6 T + 2 T); both proposal
densities' quadratic forms (8 T each); the log density at both ends (9 T
each).  Hyper block, D = 3: the log density and its gradient over the T
positions (16 T) at the start and at the proposal; the 3 x 3 algebra is
negligible beside them.
"""


def step_ops(config: dict, traffic: dict) -> float:
    t = config["num_obs"]
    latent = 3 * t + 2 * 18 * t + 11 * t + 2 * 8 * t + 2 * 9 * t
    return latent + 2 * 16 * t
