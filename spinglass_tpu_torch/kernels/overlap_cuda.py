"""The replica overlap kernel, ``csrc/replica_overlap.cu``, and its plain
PyTorch twin.

Parallel tempering with ``n_chains`` C independent chains on one ladder of
T slots keeps R = C T replicas (replica j in chain j // T) and a slot per
replica. The spin-glass overlap of two chains at slot t is

    q_ab(t) = (1/N) sum_i s_i^x s_i^y,

x and y the replicas of chains a and b that hold slot t, over the N real
spins. ``overlap_reference`` computes it in plain PyTorch from the spins in
a layout of rows ([rows, R]), a row mask (0 on real spins' rows, negative on
padding) and the slots, as exact integer sums divided once; the kernel
computes the same numbers in one launch and reads the state once. Pairs are
``chain_pairs(C)``: (a, b), a < b, in lexicographic order. The result is
[T, P] float32.

``ReplicaOverlap`` runs the twin for tensors on the CPU and the kernel for
tensors on a CUDA device (a failed build or launch raises, never falls
back); each launch is counted in the launch ledger (``build.LAUNCHES``).
Nothing is built at import.
"""

from __future__ import annotations

import ctypes

import torch

from spinglass_tpu_torch.kernels.build import count_launches

KERNEL = "replica_overlap"
MAX_CHAINS = 8
THREADS = 256
UNROLL = 4            # rows a thread of the kernel loads at once
TARGET_BLOCKS = 528   # four thread blocks per SM of the H100's 132


def chain_pairs(n_chains: int) -> list:
    """The pairs (a, b) of chains, a < b, in the order of the result's
    columns."""
    return [(a, b) for a in range(n_chains) for b in range(a + 1, n_chains)]


def slot_columns(slot: torch.Tensor, n_chains: int) -> torch.Tensor:
    """[C, T] int64: the column of the replica that holds each slot, per
    chain (the inverse of each chain's slot permutation)."""
    t = slot.shape[0] // n_chains
    inv = torch.argsort(slot.reshape(n_chains, t).long(), dim=1)
    return inv + t * torch.arange(n_chains, device=slot.device)[:, None]


def overlap_reference(spins: torch.Tensor, mask: torch.Tensor,
                      slot: torch.Tensor, n_chains: int,
                      n_real: int) -> torch.Tensor:
    """Twin of the kernel: spins [rows, R] (+-1, any dtype), mask [rows],
    slot [R] -> q [T, P] float32, the integer sums over the rows whose mask
    is not negative divided by ``n_real`` in float64 and rounded once."""
    s = spins[mask.reshape(-1) >= 0].to(torch.int64)
    cols = slot_columns(slot, n_chains)
    sums = torch.stack([(s[:, cols[a]] * s[:, cols[b]]).sum(dim=0)
                        for a, b in chain_pairs(n_chains)], dim=1)
    return (sums.double() / n_real).float()


def rows_per_block(ns: int, t: int) -> int:
    """Rows of the state per thread block: enough for TARGET_BLOCKS blocks
    over the rows, and at least one load of UNROLL rows per row group of
    the block."""
    groups = THREADS // min(t, THREADS)
    return max(groups * UNROLL, -(-ns // TARGET_BLOCKS))


def load_kernel() -> ctypes.CDLL:
    """Build (first use) and bind the kernel's library."""
    from spinglass_tpu_torch.kernels import build

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = build.load(KERNEL)
    lib.sgt_replica_overlap.argtypes = [p, i, p, p, i, i, i, i, p, p, p, i, p]
    lib.sgt_replica_overlap.restype = ctypes.c_int
    lib.sgt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


class ReplicaOverlap:
    """The overlaps of one layout: ``mask`` [rows] (0 on real spins' rows,
    negative elsewhere), ``n_chains`` chains, ``n_real`` real spins.
    ``self(spins, slot)`` -> q [T, P] float32 for spins [rows, R] in the
    layout (int8 or float32) and slot [R] int32. The kernel's scratch (the
    integer sums and a ticket, left zeroed by every launch) is kept per
    replica count, so one instance serves one stream at a time."""

    kernel_names = (KERNEL,)

    def __init__(self, mask: torch.Tensor, n_chains: int, n_real: int):
        if not 2 <= n_chains <= MAX_CHAINS:
            raise ValueError(f"overlaps need 2 to {MAX_CHAINS} chains, got "
                             f"{n_chains}")
        self.mask = mask.reshape(-1).to(torch.float32).contiguous()
        self.n_chains = n_chains
        self.n_real = int(n_real)
        self.n_pairs = n_chains * (n_chains - 1) // 2
        self._lib = None
        self._scratch = {}

    def __call__(self, spins: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
        ns, r = spins.shape
        if ns != self.mask.shape[0] or r % self.n_chains:
            raise ValueError(f"spins must be [{self.mask.shape[0]}, C T] "
                             f"with C = {self.n_chains}, got {tuple(spins.shape)}")
        if not spins.is_cuda:
            return overlap_reference(spins, self.mask, slot, self.n_chains,
                                     self.n_real)
        dev = spins.device
        spins = spins.contiguous()
        if spins.dtype not in (torch.int8, torch.float32) or \
                slot.dtype != torch.int32 or slot.shape != (r,) or \
                slot.device != dev or self.mask.device != dev:
            raise ValueError("spins must be int8 or float32 and slot [R] "
                             "int32, on the mask's device")
        t = r // self.n_chains
        if self._lib is None:
            self._lib = load_kernel()
        acc, ticket = self._scratch.get(r) or self._scratch.setdefault(
            r, (torch.zeros(t * self.n_pairs, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev)))
        out = torch.empty(t, self.n_pairs, dtype=torch.float32, device=dev)
        slot = slot.contiguous()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._lib.sgt_replica_overlap(
                spins.data_ptr(), spins.element_size(), self.mask.data_ptr(),
                slot.data_ptr(), ns, r, self.n_chains, rows_per_block(ns, t),
                acc.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                self.n_real, stream)
        if err != 0:
            msg = self._lib.sgt_cuda_error_string(err).decode()
            raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} "
                               f"({msg})")
        count_launches({KERNEL: 1})
        return out
