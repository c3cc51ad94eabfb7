"""The smallest per-coordinate ESS, summed over chains, over the window's samples (chains x steps)."""


def read(facts):
    return min(facts.ess) / (facts.chains * facts.steps)
