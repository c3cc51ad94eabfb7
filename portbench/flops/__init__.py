"""The algorithm's operations a chain and step, one file a model family and sampler
(``<model>_<sampler>.py``, ``step_ops(config, traffic) -> float``).

They count the work the published algorithm needs, whatever implements it:
an addition, multiplication, division, square root, exponential or logarithm is
one operation and a multiply-add two; the metric G is symmetric and counted as
its triangle; a tridiagonal factor and solve as the sequential algorithms (a
bidiagonal factor, a forward and a backward substitution), not the program's
cyclic reduction; a quantity the algorithm can keep (the geometry of the
chain's current point) is counted once; a trajectory of ceil(u L) leapfrog
steps, u uniform on (0, 1), as the published samplers draw it, is counted at
its mean length (L + 1) / 2, though the program runs all L under a mask.  ``step_mfu`` is these operations over
the step's time against float32's peak.
"""
