"""K3, RMHMC's geometry (``chol_inv_logdet_kernel``): factor, inverse and log-determinant of G on (C, D, D)."""

from portbench.metrics._roofline import share
from portbench.yardstick.bounds import bound_us

PATTERN = r"chol_inv_logdet_kernel"


def read(facts):
    s = facts.shapes
    return share(facts, PATTERN, lambda calls: calls * bound_us("chol_inv_logdet", s["C"], s["D"]))
