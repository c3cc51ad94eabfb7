"""Seconds the runner took to warm up and capture the step's CUDA graph (``StepGraph.capture_s``)."""


def read(facts):
    return facts.capture_s
