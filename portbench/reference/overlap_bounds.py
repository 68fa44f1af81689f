"""The least time of the replica overlap kernel's work, on the peaks of
``bounds`` (one H100 SXM at 700 W).

One measurement reads the N real spins of every replica once (a byte each)
and the R slots (4 bytes each), and writes the [T, P] overlaps (4 bytes
each); its operations (a product and an add per spin and pair of chains)
are far below the bytes' time at the card's integer rate, so bytes bound
it."""

from __future__ import annotations

from portbench.reference.bounds import HBM_BYTES_PER_S


def overlap_measurement(n: int, r: int, n_chains: int) -> float:
    """Least seconds of one measurement of C = ``n_chains`` chains of r / C
    replicas over n real spins."""
    t = r // n_chains
    pairs = n_chains * (n_chains - 1) // 2
    return (1.0 * n * r + 4.0 * r + 4.0 * t * pairs) / HBM_BYTES_PER_S
