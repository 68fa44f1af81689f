"""The SQA driver's host time of one stage, in us: the mean ``sqa.stage``
span (J_perp written into every copy of the time bonds, then the stage's
``sa.anneal`` call, its start, replays, reads and result). None for a
program without the span."""

from portbench.spans import mean_us


def read(x):
    return mean_us(x, "sqa.stage")
