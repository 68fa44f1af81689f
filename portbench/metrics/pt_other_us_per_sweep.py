"""The PT driver's own device time per sweep: every kernel but the sweep
kernel (the beta gather, best tracking, the exchange, the energy resync)."""

from portbench.readings import other_us_per


def read(x):
    return other_us_per(x, "sweeps")
