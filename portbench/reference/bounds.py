"""The least time the card could take for a kernel's work: the table of
peaks and the operation and byte counts of each sweep kernel.

The counts are of the work, not of an implementation: each input byte read
once and each output byte written once, a spin as one byte (+-1 needs no
more), the instance's own spins and edges and never a padding, and the
operations that the arithmetic of the sweep needs, once. So no
implementation, on whatever number of planes, tiles or passes, can run
faster than the bound, and a share above 100% means a miscount.

Peaks: one NVIDIA H100 SXM (80 GB HBM3) from NVIDIA's data sheet, dense
rates at the 700 W limit: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
float32 outside them, 3.35 TB/s of HBM.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def least_seconds(nbytes: float, ops: float, ops_per_s: float):
    """(least seconds, "bytes" or "operations", whichever bounds it)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def dense_sweep(n: int, r: int):
    """One Metropolis sweep of a dense [n, n] float32 J over r replicas:
    the fields, 2 n^2 r operations counted once at the card's fastest rate
    for them (bf16 tensor cores); J read once, the spins read and written
    (a byte each), the field and mask per spin, beta, dE and the count per
    replica."""
    nbytes = 4.0 * n * n + 2.0 * n * r + 8.0 * n + 12.0 * r
    ops = 2.0 * n * n * r
    return least_seconds(nbytes, ops, BF16_FLOPS)


def sparse_sweep(n: int, nnz: int, r: int):
    """One Metropolis sweep of a sparse instance of n spins and nnz
    directed couplings over r replicas: a neighbour index and a value per
    coupling and the field, mask and degree per spin read once, the spins
    read and written (a byte each), beta, dE and the count per replica; a
    multiply and an add per coupling and replica and one compare per spin
    and replica. How the acceptance draws its random numbers (which
    generator, how many rounds) is the implementation's choice and is not
    counted."""
    nbytes = 8.0 * nnz + 12.0 * n + 2.0 * n * r + 12.0 * r
    ops = 2.0 * nnz * r + 1.0 * n * r
    return least_seconds(nbytes, ops, FP32_FLOPS)
