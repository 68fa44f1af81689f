"""The sparse sweep kernels K2, K3 and K4 and their plain PyTorch twins.

The counterpart of the Pallas half of ``spinglass_tpu.kernels.sparse``:

* K2, ``csrc/sparse_sweep.cu`` (replaces ``make_single_sweep_call``): one
  whole colour-sorted sweep per launch over spins [NS, R] float32, updated in
  place. Two modes: host thresholds th [NS, R] (already masked), or
  Philox4x32-10 drawn in the kernel from a 64-bit sweep seed with counter
  (sorted row, replica).
* K3, ``csrc/sparse_thresholds.cu`` (replaces ``make_threshold_call``):
  th [NS, R] from the same Philox stream, -inf on padding rows.
* K4, ``csrc/sparse_accept.cu`` (replaces ``make_accept_call``): one
  colour's accept on its fields f [mc, R] (computed outside the kernel):
  the same Philox thresholds, compare, flip in place (int8 or float32
  spins) and dE / count added into [R] buffers.

``SparseKernels.single_sweep``, ``.thresholds`` and ``.accept`` run the
twins, ``single_sweep_reference`` (the per-colour sweep
``kernels.sparse.make_sorted_t_sweep`` on th), ``thresholds_reference``
(``kernel_threshold(philox_uniforms(seed, NS, R), beta)``, masked) and
``accept_reference`` (the same on the colour's rows), only for tensors on
the CPU. For CUDA tensors they launch the kernel or raise: a failed build or
launch is an exception, never a fallback. Each launch adds one to
``SparseKernels.sweep_launches``, ``threshold_launches`` or
``accept_launches``, and nothing else does. The kernels and the twins use
the clamped Glauber threshold of ``metropolis_cuda.kernel_threshold``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from spinglass_tpu_torch.kernels.metropolis_cuda import (kernel_threshold,
                                                         philox_uniforms)
from spinglass_tpu_torch.kernels.sweeps import canonical_rule

SWEEP_KERNEL = "sparse_sweep"
THRESHOLD_KERNEL = "sparse_thresholds"
ACCEPT_KERNEL = "sparse_accept"


def default_tile(r: int) -> int:
    """Replica columns per K2 thread block: the largest power of two that
    still gives about 128 thread blocks (one per SM), at least 2 and at most
    32. Measured on the H100 at NS=10240: R=128 76 us/sweep at 2 against 97
    at 1 and 99 at 4; R=256 98 at 2 against 196 at 1; R=1024 205 at 8
    against 277 at 4 and 346 at 16."""
    tile = 2
    while tile < 32 and tile * 2 * 128 <= r:
        tile *= 2
    return tile


def thresholds_reference(mask: torch.Tensor, beta: torch.Tensor, seed: int,
                         r: int, rule: str, row0: int = 0) -> torch.Tensor:
    """Twin of K3: th [NS, R] for sweep seed ``seed``; mask [NS] or [NS, 1]
    is 0 on real rows and -inf on padding rows. ``row0`` is the sorted row
    of mask's first entry (a colour's slice)."""
    mask = mask.reshape(-1, 1)
    u = philox_uniforms(seed, mask.shape[0], r, device=mask.device, row0=row0)
    beta = torch.broadcast_to(torch.as_tensor(beta, dtype=torch.float32,
                                              device=mask.device), (r,))
    th = kernel_threshold(u, beta[None, :], rule)
    return torch.where(mask < 0, torch.full_like(th, -torch.inf), th)


def single_sweep_reference(groups, spins_t: torch.Tensor, th: torch.Tensor):
    """Twin of K2: the per-colour sweep on thresholds th [NS, R]; updates
    ``spins_t`` in place like the kernel. Returns (spins_t, dE[R] float32,
    n_accepted[R] int32)."""
    from spinglass_tpu_torch.kernels.sparse import make_sorted_t_sweep

    return make_sorted_t_sweep(groups)(spins_t, th)


def accept_reference(f: torch.Tensor, spins_t: torch.Tensor, off: int,
                     mask: torch.Tensor, beta: torch.Tensor, seed: int,
                     rule: str, de: torch.Tensor, cnt: torch.Tensor) -> None:
    """Twin of K4: one colour's rows off .. off+mc-1 of spins_t [NS, R]
    (int8 or float32) accept on their fields f [mc, R] and K3's thresholds
    for ``seed`` restricted to those rows; flips land in spins_t, and dE
    and the count are added into de [R] and cnt [R]."""
    from spinglass_tpu_torch.kernels.sparse import accept_colour

    mc, r = f.shape
    th = thresholds_reference(mask.reshape(-1)[off:off + mc], beta, seed, r,
                              rule, row0=off)
    accept_colour(spins_t, off, f, th, de, cnt)


def _bind(lib: ctypes.CDLL, fn: str, argtypes) -> ctypes.CDLL:
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    lib.sgt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels():
    """Build (first use) and bind the K2 and K3 libraries."""
    from spinglass_tpu_torch.kernels import build

    build.build_many([SWEEP_KERNEL, THRESHOLD_KERNEL])
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    k2 = _bind(build.load(SWEEP_KERNEL), "sgt_sparse_sweep",
               [p, p, p, p, p, p, i, p, p, p, u64, p, p, i, i, i, i, i, p])
    k3 = _bind(build.load(THRESHOLD_KERNEL), "sgt_sparse_thresholds",
               [p, p, u64, p, i, i, i, p])
    return k2, k3


def load_accept_kernel() -> ctypes.CDLL:
    """Build (first use) and bind the K4 library."""
    from spinglass_tpu_torch.kernels import build

    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    return _bind(build.load(ACCEPT_KERNEL), "sgt_sparse_accept",
                 [p, p, i, p, p, u64, p, p, i, i, i, i, p])


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.sgt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


class SparseKernels:
    """K2 and K3 for one colour-sorted layout (``kernels.sparse.build_sorted_t``).

    ``mask`` [NS, 1] is 0 on real rows and -inf on padding rows. ``groups``
    (device buckets) and ``tables`` (``build_single_tables``' idx, val, h and
    per-row degree) are needed by K2 only; without them ``single_sweep``
    raises. Tensors live on the problem's device.
    """

    def __init__(self, mask: torch.Tensor, rule: str, groups=None,
                 tables: Optional[dict] = None):
        self.mask = mask.contiguous()
        self.rule = canonical_rule(rule)
        self.groups = groups
        self.tables = tables
        if tables is not None:
            spans = [off for off, _, _ in groups]
            spans.append(groups[-1][0] + groups[-1][1] if groups else 0)
            if any(off + size != nxt for (off, size, _), nxt
                   in zip(groups, spans[1:])):
                raise ValueError("colour spans must be contiguous")
            self.spans = torch.as_tensor(np.asarray(spans, np.int32),
                                         device=mask.device)
        self.sweep_launches = 0       # K2 launches made by this instance
        self.threshold_launches = 0   # K3 launches made by this instance
        self.accept_launches = 0      # K4 launches made by this instance
        self._libs = None             # built and bound at the first launch
        self._accept_lib = None

    def _beta(self, beta, r: int) -> torch.Tensor:
        beta = torch.as_tensor(beta, dtype=torch.float32, device=self.mask.device)
        return torch.broadcast_to(beta, (r,)).contiguous()

    def _lib(self, which: int) -> ctypes.CDLL:
        if self._libs is None:
            self._libs = load_kernels()
        return self._libs[which]

    def single_sweep(self, spins_t: torch.Tensor, beta, *,
                     seed: Optional[int] = None,
                     th: Optional[torch.Tensor] = None):
        """K2: one sweep over spins_t [NS, R] float32, in place, with the
        in-kernel Philox stream of ``seed`` or the thresholds ``th``.
        Returns (spins_t, dE[R] float32, n_accepted[R] int32)."""
        if self.tables is None:
            raise ValueError("this layout has no single-sweep tables")
        if (seed is None) == (th is None):
            raise ValueError("give exactly one of seed and th")
        ns, r = spins_t.shape
        if not spins_t.is_cuda:
            if th is None:
                th = thresholds_reference(self.mask, self._beta(beta, r), seed,
                                          r, self.rule)
            return single_sweep_reference(self.groups, spins_t, th)
        t = self.tables
        if (spins_t.dtype != torch.float32 or not spins_t.is_contiguous()
                or ns != t["idx"].shape[0] or spins_t.device != self.mask.device):
            raise ValueError(f"spins_t must be contiguous float32 "
                             f"[{t['idx'].shape[0]}, R] on {self.mask.device}")
        if th is not None and (th.shape != spins_t.shape or th.device != spins_t.device
                               or th.dtype != torch.float32 or not th.is_contiguous()):
            raise ValueError("th must be contiguous float32 like spins_t")
        if seed is not None and not 0 <= seed < 2 ** 64:
            raise ValueError(f"seed {seed} is not a 64-bit unsigned value")
        lib = self._lib(0)
        beta = self._beta(beta, r)
        de = torch.empty(r, dtype=torch.float32, device=spins_t.device)
        cnt = torch.empty(r, dtype=torch.int32, device=spins_t.device)
        with torch.cuda.device(spins_t.device):
            stream = torch.cuda.current_stream(spins_t.device).cuda_stream
            err = lib.sgt_sparse_sweep(
                t["idx"].data_ptr(), t["val"].data_ptr(), t["deg"].data_ptr(),
                t["h"].data_ptr(), self.mask.data_ptr(), self.spans.data_ptr(),
                len(self.spans) - 1, spins_t.data_ptr(),
                None if th is None else th.data_ptr(), beta.data_ptr(),
                0 if seed is None else seed, de.data_ptr(), cnt.data_ptr(),
                ns, t["idx"].shape[1], r, default_tile(r),
                0 if self.rule == "metropolis" else 1, stream)
        _check(lib, err, SWEEP_KERNEL)
        self.sweep_launches += 1
        return spins_t, de, cnt

    def thresholds(self, beta, seed: int, r: int) -> torch.Tensor:
        """K3: th [NS, R] float32 for sweep seed ``seed``."""
        if not self.mask.is_cuda:
            return thresholds_reference(self.mask, self._beta(beta, r), seed, r,
                                        self.rule)
        if not 0 <= seed < 2 ** 64:
            raise ValueError(f"seed {seed} is not a 64-bit unsigned value")
        lib = self._lib(1)
        beta = self._beta(beta, r)
        ns = self.mask.shape[0]
        th = torch.empty(ns, r, dtype=torch.float32, device=self.mask.device)
        with torch.cuda.device(th.device):
            stream = torch.cuda.current_stream(th.device).cuda_stream
            err = lib.sgt_sparse_thresholds(
                self.mask.data_ptr(), beta.data_ptr(), seed, th.data_ptr(), ns,
                r, 0 if self.rule == "metropolis" else 1, stream)
        _check(lib, err, THRESHOLD_KERNEL)
        self.threshold_launches += 1
        return th

    def accept(self, f: torch.Tensor, spins_t: torch.Tensor, off: int,
               beta: torch.Tensor, seed: int, de: torch.Tensor,
               cnt: torch.Tensor) -> None:
        """K4: one colour's rows off .. off+mc-1 of spins_t [NS, R] (int8 or
        float32, in place) accept on their fields f [mc, R] float32 with the
        Philox thresholds of ``seed``; dE and the count are added into de
        [R] float32 and cnt [R] int32. beta is [R] float32."""
        if not spins_t.is_cuda:
            accept_reference(f, spins_t, off, self.mask, beta, seed, self.rule,
                             de, cnt)
            return
        ns, r = spins_t.shape
        mc = f.shape[0]
        dev = spins_t.device
        if (spins_t.dtype not in (torch.int8, torch.float32)
                or not spins_t.is_contiguous() or ns != self.mask.shape[0]
                or dev != self.mask.device):
            raise ValueError(f"spins_t must be contiguous int8 or float32 "
                             f"[{self.mask.shape[0]}, R] on {self.mask.device}")
        if not (0 <= off and off + mc <= ns and f.shape == (mc, r)):
            raise ValueError(f"rows {off}..{off + mc} or fields {tuple(f.shape)} "
                             f"do not fit spins [{ns}, {r}]")
        for name, t, dtype in (("f", f, torch.float32), ("beta", beta, torch.float32),
                               ("de", de, torch.float32), ("cnt", cnt, torch.int32)):
            if t.device != dev or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous {dtype} on {dev}")
        if beta.shape != (r,) or de.shape != (r,) or cnt.shape != (r,):
            raise ValueError(f"beta, de and cnt must have shape [{r}]")
        if not 0 <= seed < 2 ** 64:
            raise ValueError(f"seed {seed} is not a 64-bit unsigned value")
        if self._accept_lib is None:
            self._accept_lib = load_accept_kernel()
        lib = self._accept_lib
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.sgt_sparse_accept(
                f.data_ptr(), spins_t.data_ptr(), spins_t.element_size(),
                self.mask.data_ptr(), beta.data_ptr(), seed, de.data_ptr(),
                cnt.data_ptr(), off, mc, r,
                0 if self.rule == "metropolis" else 1, stream)
        _check(lib, err, ACCEPT_KERNEL)
        self.accept_launches += 1
