"""One module a model family: how the benchmark builds the program's system for a configuration of it,
and the family's plain reference.

A family module gives ``build(config, traffic, seed, device) -> System`` and
``reference(config, traffic, precision, device) -> Reference``.  A ``System``
has the program's ``kernel`` and starting ``state``, ``shapes`` (the sizes the
metric readers need), ``noise(generator, state)`` (the draws of the transition
the generator is at, as a dict) and ``plain(state)`` (the state as the
comparison reads it, a dict of tensors).  A ``Reference`` has ``sweep(plain_in,
noise, follow)``: each block's ``(name, key, Proposal)`` in order, a block
after the first starting from ``follow``'s state (the candidate's) where
given, else from its own.
"""
