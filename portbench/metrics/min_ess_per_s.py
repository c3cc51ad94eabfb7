"""The smallest per-coordinate ESS, summed over chains (``yardstick.ess``, alias-free Geyer in float64, over
every transition of the window), over the window's seconds."""


def read(facts):
    return min(facts.ess) / facts.window_s
