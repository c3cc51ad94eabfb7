"""K4, BLR RMHMC's position fixed point (``position_fixed_point_kernel``): R rounds on C chains, N rows, D."""

from portbench.metrics._roofline import share
from portbench.yardstick.bounds import fixed_point_bound_us

PATTERN = r"position_fixed_point_kernel"


def read(facts):
    s = facts.shapes
    return share(facts, PATTERN, lambda calls: calls * fixed_point_bound_us(
        "position_fixed_point", s["C"], s["N"], s["D"], s["R"]))
