"""K5, BLR RMHMC's momentum fixed point (``momentum_fixed_point_kernel``): a leapfrog step calls it twice on
C chains, N rows, D, once for the implicit half-step's R rounds and once for the explicit half-step's one."""

from portbench.metrics._roofline import share
from portbench.yardstick.bounds import fixed_point_bound_us

PATTERN = r"momentum_fixed_point_kernel"


def read(facts):
    s = facts.shapes
    pair = sum(fixed_point_bound_us("momentum_fixed_point", s["C"], s["N"], s["D"], r) for r in (s["R"], 1))
    return share(facts, PATTERN, lambda calls: calls / 2 * pair)
