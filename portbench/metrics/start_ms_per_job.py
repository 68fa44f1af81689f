"""The SA driver's start of a job, in ms: the mean ``sa.start`` span (the
host draw of the start spins, their copy, layout and energy, the load into
the captured chunk and the synchronise before the job's clock)."""

from portbench.spans import mean_us


def read(x):
    us = mean_us(x, "sa.start")
    return None if us is None else us * 1e-3
