"""The share of the traced steps in which no operation ran on the device: 1 - busy / their length, both
read after the profiler's warm segments (``run.TRACE_WARM_SEGMENTS``), from the sync before the traced
steps to the one after."""

from portbench.yardstick import trace as tr


def read(facts):
    if facts.trace is None or not facts.trace.ops:
        return None
    return 100.0 * (1.0 - tr.busy_us(facts.trace.ops) / 1e6 / facts.trace.window_s)
