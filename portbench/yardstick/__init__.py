"""Frozen yardsticks: the ESS estimator, the data generators, the card's peaks and the kernels' bounds,
and the reading of a profiler trace.  None of them imports the program."""
