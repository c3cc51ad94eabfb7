"""The share of the device's busy time in the traced steps that cuBLAS's matrix products take, found by
kernel name."""

from portbench.yardstick import trace as tr

PATTERN = r"(?i)gemm|cutlass|xmma|gemv"


def read(facts):
    if facts.trace is None:
        return None
    found = tr.matching(facts.trace.ops, PATTERN)
    if not found:
        return None
    return 100.0 * tr.time_us(found) / tr.busy_us(facts.trace.ops)
