"""T2, StochVol's tridiagonal solve by cyclic reduction (``pcr_solve`` kernels) on C chains of T."""

from portbench.metrics._roofline import share
from portbench.yardstick.bounds import pcr_bound_us

PATTERN = r"pcr_solve"


def read(facts):
    s = facts.shapes
    return share(facts, PATTERN, lambda calls: calls * pcr_bound_us(s["C"], s["T"]))
