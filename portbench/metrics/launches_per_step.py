"""Device operations (kernels, copies, sets) in the traced steps, over the steps."""


def read(facts):
    if facts.trace is None or not facts.trace.ops:
        return None
    return len(facts.trace.ops) / facts.trace.steps
