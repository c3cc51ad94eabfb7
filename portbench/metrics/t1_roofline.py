"""T1, StochVol's bidiagonal factor of the latent metric (``bidiag_scan_kernel``) on C chains of T."""

from portbench.metrics._roofline import share
from portbench.yardstick.bounds import bidiag_bound_us

PATTERN = r"bidiag_scan_kernel"


def read(facts):
    s = facts.shapes
    return share(facts, PATTERN, lambda calls: calls * bidiag_bound_us(s["C"], s["T"]))
