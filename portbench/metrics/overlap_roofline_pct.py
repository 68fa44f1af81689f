"""The replica overlap kernel's share of its bound: the N real spins of
every replica read once (a byte each), the slots read and the [T, P]
overlaps written, at the card's HBM rate (``reference.overlap_bounds``),
times the window's measurements (one a super-step, ``counts``), over the
kernel's device time. None where the trace holds no overlap kernel (a
program without it, or a cell that measures no overlaps)."""

from portbench.reference.overlap_bounds import overlap_measurement

KERNEL = "replica_overlap_kernel"


def read(x):
    t = x.trace.device_seconds(KERNEL)
    m = x.counts.get("overlap_measurements", 0)
    if t <= 0 or m <= 0:
        return None
    p = x.params
    least = overlap_measurement(x.instance["n"],
                                p["n_replicas"] * p["n_chains"], p["n_chains"])
    return 100.0 * least * m / t
