"""The share of the traced window in which the card was idle while the host
was in no span of the program, or only in a root's own time: what the spans
cannot name yet (the drivers' Python between their phases, the benchmark's
code between jobs)."""

from portbench.spans import idle_unspanned_pct


def read(x):
    return idle_unspanned_pct(x)
