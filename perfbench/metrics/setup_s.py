"""Seconds from the start of the process to the start of the window:
imports and CUDA, the kernels' build or load, the weights, the trace
and the warm-up serve."""


def read(run):
    return run.setup_s
