"""The time-to-target latch, ``csrc/pt_latch.cu``, and its plain PyTorch
twin.

``benchmarks.planted.time_to_target`` queues its next captured super-step
before it reads the best energy of the last one, so super-steps may run
after the one that reached the target. The latch, at the end of the
captured super-step, keeps the state of that first hit: on the super-step
whose least best energy first lies at or below the threshold, every tensor
of the state is copied into a snapshot and a device flag is set; later
super-steps of the solve copy nothing. ``latch_reference`` is that rule in
PyTorch; the kernel does it in one launch that returns at once when there
is nothing to copy.

``Latch`` holds the snapshot (one tensor per state tensor), the threshold
(a float64 device scalar, so one captured super-step serves every target)
and the flag; it runs the twin for tensors on the CPU and the kernel for
tensors on a CUDA device (a failed build or launch raises, never falls
back); each launch is counted in the launch ledger (``build.LAUNCHES``).
Nothing is built at import.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from spinglass_tpu_torch.kernels.build import count_launches

KERNEL = "pt_latch"
MAX_LEAVES = 16


def latch_reference(best: torch.Tensor, threshold: torch.Tensor,
                    flag: torch.Tensor, sources: Sequence[torch.Tensor],
                    snapshot: Sequence[torch.Tensor]) -> None:
    """Twin of the kernel: if ``flag[0]`` is 0 and ``best`` (0-d float32)
    <= ``threshold`` (0-d float64), each source is copied into its snapshot
    tensor and ``flag[0]`` set to 1, in place."""
    if int(flag[0]) == 0 and bool(best.double() <= threshold):
        with torch.no_grad():
            for src, dst in zip(sources, snapshot):
                dst.copy_(src)
        flag[0] = 1


def load_kernel() -> ctypes.CDLL:
    """Build (first use) and bind the kernel's library."""
    from spinglass_tpu_torch.kernels import build

    p = ctypes.c_void_p
    lib = build.load(KERNEL)
    lib.sgt_pt_latch.argtypes = [p, p, p, p, p, p, ctypes.c_int, p]
    lib.sgt_pt_latch.restype = ctypes.c_int
    lib.sgt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


class Latch:
    """The latch over the state tensors ``like`` (their shapes, types and
    device): ``snapshot`` (a tensor for each), ``threshold`` and ``flag``
    [2] int32 (latched; on the card, the blocks done with a hit's copy).
    ``arm(threshold)`` starts a solve; ``self(best, sources)`` is one
    super-step's latch; ``restore(targets)`` copies the snapshot into
    ``targets``. The threshold starts at -inf: the latch copies nothing
    before it is armed."""

    def __init__(self, like: Sequence[torch.Tensor]):
        if not 1 <= len(like) <= MAX_LEAVES:
            raise ValueError(f"a latch takes 1 to {MAX_LEAVES} tensors, got "
                             f"{len(like)}")
        dev = like[0].device
        if any(t.device != dev for t in like):
            raise ValueError("the latch's tensors must share one device")
        self.device = dev
        self.snapshot = [torch.zeros_like(t, memory_format=torch
                                          .contiguous_format) for t in like]
        self.threshold = torch.full((), -torch.inf, dtype=torch.float64,
                                    device=dev)
        self.flag = torch.zeros(2, dtype=torch.int32, device=dev)
        self._lib = None

    def arm(self, threshold: float) -> None:
        """A new solve to ``threshold``: the flag cleared, nothing latched."""
        self.threshold.fill_(threshold)
        self.flag.zero_()

    def restore(self, targets: Sequence[torch.Tensor]) -> None:
        """The snapshot copied into ``targets`` (stream-ordered)."""
        with torch.no_grad():
            for dst, src in zip(targets, self.snapshot):
                dst.copy_(src)

    def __call__(self, best: torch.Tensor,
                 sources: Sequence[torch.Tensor]) -> None:
        self._check(best, sources)
        if not best.is_cuda:
            latch_reference(best, self.threshold, self.flag, sources,
                            self.snapshot)
            return
        self._launch(best, sources)

    def _check(self, best, sources) -> None:
        if len(sources) != len(self.snapshot) or any(
                s.shape != d.shape or s.dtype != d.dtype or s.device != d.device
                for s, d in zip(sources, self.snapshot)):
            raise ValueError("the latch's sources must match its snapshot: "
                             "one tensor each, same shape, type and device")
        if best.shape != () or best.dtype != torch.float32 or \
                best.device != self.device:
            raise ValueError(f"best must be a 0-d float32 tensor on "
                             f"{self.device}, got {tuple(best.shape)} "
                             f"{best.dtype} on {best.device}")

    def _launch(self, best, sources) -> None:
        """The kernel's launch on the state's device: contiguous sources
        only."""
        if not all(s.is_contiguous() for s in sources):
            raise ValueError("the latch's kernel copies contiguous tensors "
                             "only")
        if self._lib is None:
            self._lib = load_kernel()
        n = len(sources)
        src = (ctypes.c_void_p * n)(*[s.data_ptr() for s in sources])
        dst = (ctypes.c_void_p * n)(*[d.data_ptr() for d in self.snapshot])
        nbytes = (ctypes.c_ulonglong * n)(
            *[s.numel() * s.element_size() for s in sources])
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = self._lib.sgt_pt_latch(
                best.data_ptr(), self.threshold.data_ptr(),
                self.flag.data_ptr(), src, dst, nbytes, n, stream)
        if err != 0:
            msg = self._lib.sgt_cuda_error_string(err).decode()
            raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err} "
                               f"({msg})")
        count_launches({KERNEL: 1})
