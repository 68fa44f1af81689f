"""The host's time to fill a captured step's random tape before a replay:
the mean ``step.fill`` span (seed draws, the copy of the seed slots, the
tape's device draws), in us."""

from portbench.spans import mean_us


def read(x):
    return mean_us(x, "step.fill")
