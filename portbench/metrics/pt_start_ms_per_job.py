"""The PT driver's start of a job, in ms: the mean ``pt.start`` span of
``pt.run`` (the start state drawn and put in the engine's layout, its
energies, the load into the captured super-step, and the synchronise before
the job's clock). None for a program without the span."""

from portbench.spans import mean_us


def read(x):
    us = mean_us(x, "pt.start")
    return None if us is None else us * 1e-3
