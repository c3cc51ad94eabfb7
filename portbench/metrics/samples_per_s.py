"""Chain transitions completed in the window (chains x steps; a StochVol step is one sweep of both blocks)
over the window's seconds, which end when the device has finished (``torch.cuda.synchronize()``)."""


def read(facts):
    return facts.chains * facts.steps / facts.window_s
