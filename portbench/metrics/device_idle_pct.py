"""The share of the traced window in which no operation ran on the card."""

from portbench.readings import idle_pct


def read(x):
    return idle_pct(x)
