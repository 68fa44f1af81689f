"""The SQA driver's decode of a job, in ms: the mean ``sqa.decode`` span
(every replica's slice energies and action on the card, the least slice of
each, and their read). None for a program without the span."""

from portbench.spans import mean_us


def read(x):
    us = mean_us(x, "sqa.decode")
    return None if us is None else us * 1e-3
