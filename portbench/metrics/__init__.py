"""One reader a metric: ``read(facts) -> float | None``, ``facts`` a ``portbench.run.Facts``.

A reader that finds nothing to read returns None, and the run leaves the
metric out of its line.  A roofline share is a kernel's bound from its shapes
(``yardstick.bounds``) over its device time in the traced steps, summed over
its calls; it is never 0 and never clipped.
"""
