"""The sparse sweep kernels K2, K3 and K4 and their plain PyTorch twins.

The counterpart of the Pallas half of ``spinglass_tpu.kernels.sparse``:

* K2, ``csrc/sparse_sweep.cu`` (replaces ``make_single_sweep_call``): one
  whole colour-sorted sweep per launch over spins [NS, R] float32 (+-1),
  updated in place. A thread block keeps its tile of replica columns in
  shared memory as int8 for the whole sweep and gathers there
  (``default_tile`` says which shapes fit; beyond them the wrapper
  raises). Two modes: host thresholds th [NS, R]
  (already masked), or Philox4x32-10 drawn in the kernel from a 64-bit
  sweep seed: the sparse stream, counter (sorted row, replica >> 2), four
  uniforms per run of the rounds (``metropolis_cuda.philox_uniforms4``).
* K3, ``csrc/sparse_thresholds.cu`` (replaces ``make_threshold_call``):
  th [NS, R] from the same Philox stream, -inf on padding rows.
* K4, ``csrc/sparse_accept.cu`` (replaces ``make_accept_call`` and the
  per-colour gathers around it): one colour's fields, the same Philox
  thresholds, compare, flip in place (int8 or float32 spins) and dE /
  count added into [R] buffers. ``accept_gather`` has the kernel gather the
  fields itself from K2's slot tables and the spin array (any NS and R);
  ``accept`` hands it fields f [mc, R] computed outside.

``SparseKernels.single_sweep``, ``.thresholds``, ``.accept`` and
``.accept_gather`` run the twins, ``single_sweep_reference`` (the
per-colour sweep ``kernels.sparse.make_sorted_t_sweep`` on th),
``thresholds_reference`` (``kernel_threshold(philox_uniforms4(seed, NS, R),
beta)``, masked), ``accept_reference`` (the same on the colour's rows) and
``accept_gather_reference`` (slot-ordered fields, then ``accept_reference``),
only for tensors on the CPU. For CUDA tensors they launch the kernel or
raise: a failed build or launch is an exception, never a fallback. Each
launch is counted under its kernel's name in the launch ledger
(``build.LAUNCHES``). The kernels and the twins use
the clamped Glauber threshold of ``metropolis_cuda.kernel_threshold``.
Every ``seed`` is a host int or a seed slot (``metropolis_cuda.seed_arg``):
the kernels take it by value or read it from the card's memory.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from spinglass_tpu_torch.kernels.build import count_launches
from spinglass_tpu_torch.kernels.metropolis_cuda import (kernel_threshold,
                                                         philox_uniforms4,
                                                         seed_arg)
from spinglass_tpu_torch.kernels.sweeps import canonical_rule

SWEEP_KERNEL = "sparse_sweep"
THRESHOLD_KERNEL = "sparse_thresholds"
ACCEPT_KERNEL = "sparse_accept"


MAX_TILE = 8              # replica columns per K2 thread block, at most
TILE_SMEM_BYTES = 224 * 1024  # of a block's 227 KB, for the int8 spin tile


def default_tile(r: int, n_sorted: int) -> int:
    """Replica columns per K2 thread block at [n_sorted, r]: the largest
    power of two up to 8 that still gives about 128 thread blocks (one per
    SM), halved until the tile's n_sorted * columns bytes of int8 spins fit
    the block's shared memory (n_sorted <= 28672 at 8 columns, 229376 at
    1). Raises beyond that: the sparse engine sends K2 no such shape (its
    [NS, R] float32 <= 80 MiB rule keeps n_sorted <= 163840). Measured on
    the H100 (700 W) at NS=10240, us/sweep at 1 / 2 / 4 / 8 columns: R=128
    58.6 / 60.6 / 77.5 / 121.8; R=256 111.5 / 68.5 / 78.1 / 121.9; R=1024
    413.0 / 262.3 / 194.7 / 140.7."""
    tile = 1
    while tile < MAX_TILE and tile * 2 * 128 <= r:
        tile *= 2
    while tile > 1 and n_sorted * tile > TILE_SMEM_BYTES:
        tile //= 2
    if n_sorted * tile > TILE_SMEM_BYTES:
        raise ValueError(
            f"sparse_sweep keeps a replica column of all {n_sorted} sorted "
            f"rows in a thread block's shared memory as int8, at most "
            f"{TILE_SMEM_BYTES} rows")
    return tile


def thresholds_reference(mask: torch.Tensor, beta: torch.Tensor, seed,
                         r: int, rule: str, row0: int = 0) -> torch.Tensor:
    """Twin of K3: th [NS, R] for sweep seed ``seed``; mask [NS] or [NS, 1]
    is 0 on real rows and -inf on padding rows. ``row0`` is the sorted row
    of mask's first entry (a colour's slice)."""
    mask = mask.reshape(-1, 1)
    u = philox_uniforms4(seed, mask.shape[0], r, device=mask.device, row0=row0)
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


def ordered_fields(tables: dict, lo: int, hi: int,
                   spins_t: torch.Tensor) -> torch.Tensor:
    """Fields [hi - lo, R] float32 of sorted rows lo .. hi-1, slot by slot:
    f = h, then f += val[:, k] * s[idx[:, k]] for k = 0, 1, ... (padding
    slots add 0), the order in which K2 and K4 sum a row's field.
    ``kernels.sparse._colour_fields`` lets torch.sum pick the order, which
    can differ in the last bit on couplings that are not exact."""
    idx, val = tables["idx"], tables["val"]
    f = tables["h"][lo:hi, None].expand(hi - lo, spins_t.shape[1])
    for k in range(idx.shape[1]):
        f = f + val[lo:hi, k, None] * spins_t[idx[lo:hi, k].long()]
    return f


def single_sweep_ordered(tables: dict, spans, spins_t: torch.Tensor,
                         th: torch.Tensor):
    """K2's arithmetic in plain PyTorch: per colour span the slot-ordered
    fields (``ordered_fields``), then the accept on th. In place; returns
    (spins_t, dE[R] float32, n_accepted[R] int32)."""
    from spinglass_tpu_torch.kernels.sparse import accept_colour

    r = spins_t.shape[1]
    de = torch.zeros(r, dtype=torch.float32, device=spins_t.device)
    cnt = torch.zeros(r, dtype=torch.int32, device=spins_t.device)
    for lo, hi in zip(spans[:-1], spans[1:]):
        accept_colour(spins_t, lo, ordered_fields(tables, lo, hi, spins_t),
                      th[lo:hi], de, cnt)
    return spins_t, de, cnt


def accept_reference(f: torch.Tensor, spins_t: torch.Tensor, off: int,
                     mask: torch.Tensor, beta: torch.Tensor, seed,
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


def accept_gather_reference(tables: dict, spins_t: torch.Tensor, off: int,
                            mc: int, mask: torch.Tensor, beta: torch.Tensor,
                            seed, rule: str, de: torch.Tensor,
                            cnt: torch.Tensor) -> None:
    """Twin of K4's gather mode: the slot-ordered fields of rows off ..
    off+mc-1 from spins_t itself, then ``accept_reference``."""
    accept_reference(ordered_fields(tables, off, off + mc, spins_t), spins_t,
                     off, mask, beta, seed, rule, de, cnt)


ACCEPT_COLS = 128  # replica columns per K4 thread block


def accept_rows_per_block(mc: int, r: int) -> int:
    """Rows of a colour that one K4 thread block of 8 warps takes: 16 below
    4 column blocks of 128 replicas, 32 below 16, else 64, doubled where a
    colour would have more than 65535 row blocks. A block pays a fixed price
    (its thresholds' -0.5 / beta, its partial sums, a fence and a ticket),
    so few rows per block lose to it and many leave the card's SMs idle.
    Measured on the H100 (700 W) on the 10k bench graph (~1460 rows per
    colour, int8 spins), us per sweep of 7 launches at 8 / 16 / 32 / 64 /
    128 rows: R=4096 475 / 342 / 285 / 279 / 297; R=1024 161 / 117 / 100 /
    121 / 168; R=128 76 / 60 / 70 / 98 / 163."""
    col_blocks = -(-r // ACCEPT_COLS)
    rows = 16 if col_blocks < 4 else 32 if col_blocks < 16 else 64
    while -(-mc // rows) > 65535:
        rows *= 2
    return rows


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
               [p, p, p, p, p, p, i, p, p, p, u64, p, p, p, i, i, i, i, i, p])
    k3 = _bind(build.load(THRESHOLD_KERNEL), "sgt_sparse_thresholds",
               [p, p, u64, p, p, i, i, i, p])
    return k2, k3


def load_accept_kernel() -> ctypes.CDLL:
    """Build (first use) and bind the K4 library."""
    from spinglass_tpu_torch.kernels import build

    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    ints = ctypes.POINTER(ctypes.c_int)
    lib = _bind(build.load(ACCEPT_KERNEL), "sgt_sparse_accept",
                [p, p, p, p, p, i, i, p, i, p, p, u64, p, p, p, p, p, p, i,
                 i, i, i, i, p])
    return _bind(lib, "sgt_sparse_accept_sweep",
                 [p, p, p, p, i, i, p, i, p, p, u64, p, p, p, p, p, p,
                  ints, ints, i, i, i, p])


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.sgt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


class SparseKernels:
    """K2, K3 and K4 for one colour-sorted layout
    (``kernels.sparse.build_sorted_t``).

    ``mask`` [NS, 1] is 0 on real rows and -inf on padding rows. ``groups``
    (device buckets) and ``tables`` (``build_single_tables``' idx, val, h and
    per-row degree) are needed by K2 and by K4's gather mode; without them
    ``single_sweep`` and ``accept_gather`` raise. Spins are +-1. Tensors
    live on the problem's device. K4's scratch is kept per replica count and
    reused by every launch, so one instance serves one stream at a time.
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
            self.span_list = spans
            self.spans = torch.as_tensor(np.asarray(spans, np.int32),
                                         device=mask.device)
            # K2 reads the slot tables transposed, [kmax, NS]: a warp's 32
            # rows then read one 128-byte line per slot (K4's warp owns one
            # row and reads its slots from the row-major tables)
            self._idx_t = tables["idx"].t().contiguous()
            self._val_t = tables["val"].t().contiguous()
        self._libs = None             # built and bound at the first launch
        self._accept_lib = None
        self._accept_scratch = {}     # R -> (dE partials, count partials, tickets)
        self._accept_rows = {}        # R -> K4's rows per block, per colour

    def _beta(self, beta, r: int) -> torch.Tensor:
        beta = torch.as_tensor(beta, dtype=torch.float32, device=self.mask.device)
        return torch.broadcast_to(beta, (r,)).contiguous()

    def _lib(self, which: int) -> ctypes.CDLL:
        if self._libs is None:
            self._libs = load_kernels()
        return self._libs[which]

    def single_sweep(self, spins_t: torch.Tensor, beta, *,
                     seed=None,
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
        seed, seed_ptr = (0, None) if seed is None else seed_arg(
            seed, spins_t.device)
        tile = default_tile(r, ns)
        lib = self._lib(0)
        beta = self._beta(beta, r)
        de = torch.empty(r, dtype=torch.float32, device=spins_t.device)
        cnt = torch.empty(r, dtype=torch.int32, device=spins_t.device)
        with torch.cuda.device(spins_t.device):
            stream = torch.cuda.current_stream(spins_t.device).cuda_stream
            err = lib.sgt_sparse_sweep(
                self._idx_t.data_ptr(), self._val_t.data_ptr(),
                t["deg"].data_ptr(), t["h"].data_ptr(), self.mask.data_ptr(),
                self.spans.data_ptr(), len(self.spans) - 1,
                spins_t.data_ptr(), None if th is None else th.data_ptr(),
                beta.data_ptr(), seed, seed_ptr, de.data_ptr(),
                cnt.data_ptr(), ns, t["idx"].shape[1], r, tile,
                0 if self.rule == "metropolis" else 1, stream)
        _check(lib, err, SWEEP_KERNEL)
        count_launches({SWEEP_KERNEL: 1})
        return spins_t, de, cnt

    def thresholds(self, beta, seed, r: int) -> torch.Tensor:
        """K3: th [NS, R] float32 for sweep seed ``seed``."""
        if not self.mask.is_cuda:
            return thresholds_reference(self.mask, self._beta(beta, r), seed, r,
                                        self.rule)
        seed, seed_ptr = seed_arg(seed, self.mask.device)
        lib = self._lib(1)
        beta = self._beta(beta, r)
        ns = self.mask.shape[0]
        th = torch.empty(ns, r, dtype=torch.float32, device=self.mask.device)
        with torch.cuda.device(th.device):
            stream = torch.cuda.current_stream(th.device).cuda_stream
            err = lib.sgt_sparse_thresholds(
                self.mask.data_ptr(), beta.data_ptr(), seed, seed_ptr,
                th.data_ptr(), ns,
                r, 0 if self.rule == "metropolis" else 1, stream)
        _check(lib, err, THRESHOLD_KERNEL)
        count_launches({THRESHOLD_KERNEL: 1})
        return th

    def accept(self, f: torch.Tensor, spins_t: torch.Tensor, off: int,
               beta: torch.Tensor, seed, de: torch.Tensor,
               cnt: torch.Tensor) -> None:
        """K4 on given fields: one colour's rows off .. off+mc-1 of spins_t
        [NS, R] (int8 or float32, in place) accept on their fields f [mc, R]
        float32 with the Philox thresholds of ``seed``; dE and the count are
        added into de [R] float32 and cnt [R] int32. beta is [R] float32."""
        if not spins_t.is_cuda:
            accept_reference(f, spins_t, off, self.mask, beta, seed, self.rule,
                             de, cnt)
            return
        mc, r = f.shape[0], spins_t.shape[1]
        if (f.shape != (mc, r) or f.device != spins_t.device
                or f.dtype != torch.float32 or not f.is_contiguous()):
            raise ValueError(f"f must be contiguous float32 [mc, {r}] on "
                             f"{spins_t.device}, got {tuple(f.shape)}")
        self._launch_accept(f, spins_t, off, mc, beta, seed, de, cnt)

    def accept_gather(self, spins_t: torch.Tensor, off: int, mc: int,
                      beta: torch.Tensor, seed, de: torch.Tensor,
                      cnt: torch.Tensor) -> None:
        """K4 in gather mode: as ``accept``, but the kernel computes the
        fields of rows off .. off+mc-1 itself from the slot tables and
        spins_t (slots in order, as K2). The rows must be one colour, or
        any set of rows of which none is a neighbour of another."""
        if self.tables is None:
            raise ValueError("this layout has no slot tables to gather from")
        if not spins_t.is_cuda:
            accept_gather_reference(self.tables, spins_t, off, mc, self.mask,
                                    beta, seed, self.rule, de, cnt)
            return
        self._launch_accept(None, spins_t, off, mc, beta, seed, de, cnt)

    def accept_sweep(self, spins_t: torch.Tensor, beta: torch.Tensor,
                     seed):
        """A whole sweep through K4 in gather mode: ``accept_gather`` for
        every colour span in order, in place. On a CUDA device the colours'
        launches are made from one call into the library (one K4 launch per
        non-empty colour, each counted). beta is [R] float32. Returns
        (spins_t, dE[R] float32, n_accepted[R] int32)."""
        if self.tables is None:
            raise ValueError("this layout has no slot tables to gather from")
        r = spins_t.shape[1]
        dev = spins_t.device
        spans = self.span_list
        if not spins_t.is_cuda:
            de = torch.zeros(r, dtype=torch.float32, device=dev)
            cnt = torch.zeros(r, dtype=torch.int32, device=dev)
            for lo, hi in zip(spans[:-1], spans[1:]):
                if hi > lo:
                    accept_gather_reference(self.tables, spins_t, lo, hi - lo,
                                            self.mask, beta, seed, self.rule,
                                            de, cnt)
            return spins_t, de, cnt
        de = torch.empty(r, dtype=torch.float32, device=dev)
        cnt = torch.empty(r, dtype=torch.int32, device=dev)
        seed, seed_ptr = self._check_accept(spins_t, spans[0],
                                            spans[-1] - spans[0], beta, seed,
                                            de, cnt)
        if r not in self._accept_rows:
            self._accept_rows[r] = [accept_rows_per_block(max(hi - lo, 1), r)
                                    for lo, hi in zip(spans[:-1], spans[1:])]
        rows = self._accept_rows[r]
        scratch = self._scratch(r, max(
            -(-(hi - lo) // n) for lo, hi, n in zip(spans[:-1], spans[1:], rows)))
        n_colors = len(spans) - 1
        lib, t = self._accept_lib, self.tables
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.sgt_sparse_accept_sweep(
                t["idx"].data_ptr(), t["val"].data_ptr(),
                t["deg"].data_ptr(), t["h"].data_ptr(), spins_t.shape[0],
                t["idx"].shape[1], spins_t.data_ptr(), spins_t.element_size(),
                self.mask.data_ptr(), beta.data_ptr(), seed, seed_ptr,
                de.data_ptr(), cnt.data_ptr(), *(b.data_ptr() for b in scratch),
                (ctypes.c_int * len(spans))(*spans),
                (ctypes.c_int * n_colors)(*rows), n_colors, r,
                0 if self.rule == "metropolis" else 1, stream)
        _check(lib, err, ACCEPT_KERNEL)
        count_launches({ACCEPT_KERNEL: sum(hi > lo for lo, hi
                                           in zip(spans[:-1], spans[1:]))})
        return spins_t, de, cnt

    def _check_accept(self, spins_t, off: int, mc: int, beta, seed, de,
                      cnt):
        """Raises on what K4 does not take; builds it at first use. Returns
        the seed's (value, address), ``seed_arg``."""
        ns, r = spins_t.shape
        dev = spins_t.device
        if (spins_t.dtype not in (torch.int8, torch.float32)
                or not spins_t.is_contiguous() or ns != self.mask.shape[0]
                or dev != self.mask.device):
            raise ValueError(f"spins_t must be contiguous int8 or float32 "
                             f"[{self.mask.shape[0]}, R] on {self.mask.device}")
        if not (0 <= off and 1 <= mc and off + mc <= ns):
            raise ValueError(f"rows {off}..{off + mc} do not fit spins "
                             f"[{ns}, {r}]")
        for name, t, dtype in (("beta", beta, torch.float32),
                               ("de", de, torch.float32),
                               ("cnt", cnt, torch.int32)):
            if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                    or t.shape != (r,)):
                raise ValueError(f"{name} must be contiguous {dtype} [{r}] "
                                 f"on {dev}")
        seed_words = seed_arg(seed, dev)
        if self._accept_lib is None:
            self._accept_lib = load_accept_kernel()
        return seed_words

    def _scratch(self, r: int, row_blocks: int):
        """K4's per-block partial sums [row_blocks, R] (dE, counts) and its
        zeroed ticket counters, kept per replica count."""
        scratch = self._accept_scratch.get(r)
        if scratch is None or scratch[0].shape[0] < row_blocks:
            dev = self.mask.device
            scratch = (torch.empty(row_blocks, r, dtype=torch.float32, device=dev),
                       torch.empty(row_blocks, r, dtype=torch.int32, device=dev),
                       torch.zeros(-(-r // ACCEPT_COLS), dtype=torch.int32,
                                   device=dev))
            self._accept_scratch[r] = scratch
        return scratch

    def _launch_accept(self, f: Optional[torch.Tensor], spins_t: torch.Tensor,
                       off: int, mc: int, beta: torch.Tensor, seed,
                       de: torch.Tensor, cnt: torch.Tensor) -> None:
        seed, seed_ptr = self._check_accept(spins_t, off, mc, beta, seed, de,
                                            cnt)
        ns, r = spins_t.shape
        lib = self._accept_lib
        rows = accept_rows_per_block(mc, r)
        scratch = self._scratch(r, -(-mc // rows))
        t = self.tables
        gather = f is None
        with torch.cuda.device(spins_t.device):
            stream = torch.cuda.current_stream(spins_t.device).cuda_stream
            err = lib.sgt_sparse_accept(
                None if gather else f.data_ptr(),
                t["idx"].data_ptr() if gather else None,
                t["val"].data_ptr() if gather else None,
                t["deg"].data_ptr() if gather else None,
                t["h"].data_ptr() if gather else None,
                ns, t["idx"].shape[1] if gather else 0,
                spins_t.data_ptr(), spins_t.element_size(),
                self.mask.data_ptr(), beta.data_ptr(), seed, seed_ptr,
                de.data_ptr(), cnt.data_ptr(), *(b.data_ptr() for b in scratch),
                off, mc, r,
                rows, 0 if self.rule == "metropolis" else 1, stream)
        _check(lib, err, ACCEPT_KERNEL)
        count_launches({ACCEPT_KERNEL: 1})
