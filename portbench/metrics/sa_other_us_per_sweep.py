"""The SA driver's own device time per sweep: every kernel but the sweep
kernel (energies, best tracking, the schedule, the statistics, the copies)."""

from portbench.readings import other_us_per


def read(x):
    return other_us_per(x, "sweeps")
