"""The SQA driver's start of a job, in ms: the mean ``sqa.start`` span (the
Trotter problem fetched from the cache with J_perp for stage 0 written, or
built, and every replica's start spins drawn on the card). None for a
program without the span."""

from portbench.spans import mean_us


def read(x):
    us = mean_us(x, "sqa.start")
    return None if us is None else us * 1e-3
