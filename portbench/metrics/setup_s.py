"""Seconds from the harness's first statement to the window's start: imports, loading the program's CUDA
library (building it on a checkout's first run), the data, the chains' start, the burn-in with the step's
capture, and the warm-up of every segment length the window uses."""


def read(facts):
    return facts.setup_s
