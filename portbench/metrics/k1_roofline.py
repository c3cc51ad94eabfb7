"""K1, mMALA's factor of G (``cholesky_kernel``) on (C, D, D)."""

from portbench.metrics._roofline import share
from portbench.yardstick.bounds import bound_us

PATTERN = r"\bcholesky_kernel\b"


def read(facts):
    s = facts.shapes
    return share(facts, PATTERN, lambda calls: calls * bound_us("cholesky", s["C"], s["D"]))
