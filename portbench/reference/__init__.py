"""The plain reference: the samplers' transitions in plain PyTorch, from the published algorithms.

It imports neither JAX, nor the JAX package, nor anything of the program
(``riemannhamiltonianmontecarlo_tpu_torch``), and takes nothing the program made:
it is handed the data, a chain's state before a transition and the transition's
random draws, and works out the geometry, the trajectory and the
Metropolis-Hastings decision again.  ``precision`` sets the arithmetic: float64
for the judgment, and the controls (TF32 contractions, bfloat16) that show the
comparison fails a lower precision.
"""
