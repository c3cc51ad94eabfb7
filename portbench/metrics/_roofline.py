"""A kernel's roofline share: its calls' bounds over their device time in the traced steps."""

from portbench.yardstick import trace as tr


def share(facts, pattern: str, bound_us_of_calls) -> float | None:
    """``bound_us_of_calls(calls)`` gives the bound of that many calls of the kernel, in microseconds."""
    if facts.trace is None:
        return None
    found = tr.matching(facts.trace.ops, pattern)
    if not found:
        return None
    return 100.0 * bound_us_of_calls(len(found)) / tr.time_us(found)
