"""The mean Metropolis-Hastings acceptance probability over the window's transitions and chains, from the
sums the program keeps on the device (for StochVol the mean of the two blocks')."""


def read(facts):
    return facts.accept_rate
