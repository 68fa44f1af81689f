"""Device kernels per sweep in the captured steps' replays (what the host
launches and the device runs one after another)."""

from portbench.readings import kernels_per


def read(x):
    return kernels_per(x, "sweeps")
