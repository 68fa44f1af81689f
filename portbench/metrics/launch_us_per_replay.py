"""The host's time to launch a captured step: the mean ``step.launch`` span
(``CUDAGraph.replay``), in us."""

from portbench.spans import mean_us


def read(x):
    return mean_us(x, "step.launch")
