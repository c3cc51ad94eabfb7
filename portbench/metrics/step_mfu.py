"""The whole step's share of float32's peak: the algorithm's operations a chain and step (``flops/``) times
chains and steps, over the untraced window's seconds by the host's clock (the window that ``samples_per_s``
reads), against 67 TFLOP/s."""

from portbench.yardstick.bounds import FP32_OPS_PER_S


def read(facts):
    return 100.0 * facts.step_ops * facts.chains * facts.steps / facts.window_s / FP32_OPS_PER_S
