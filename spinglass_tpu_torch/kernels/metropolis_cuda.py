"""Fused whole-sweep dense Metropolis/Glauber: K1 and its variants K5-K7.

The counterpart of ``spinglass_tpu.kernels.metropolis_pallas``. Each kernel
runs one exact sequential-equivalent sweep over dense J per launch, on spins
in [Np, R] ("nr") layout, updated in place, and has a plain PyTorch twin
here that expresses the same algorithm:

* K1 ``csrc/metropolis_sweep.cu`` (``_make_kernel``), twin
  ``fused_sweep_reference``: the blocked algorithm of
  ``kernels.sweeps.blocked_sweep`` in [Np, R] layout;
* K5 ``csrc/metropolis_pipelined.cu`` (``_make_kernel_pipe``), twin
  ``pipelined_sweep_reference``: block b+1's fields are computed before
  block b's flips and repaired with ``J[b+1, b] @ ds_b``;
* K6 ``csrc/metropolis_interleaved.cu`` (``_make_kernel_interleaved``), twin
  ``interleaved_sweep_reference``: the replicas split into chains with
  private fields, stepped in interleaved order;
* K7 ``csrc/metropolis_folded.cu`` (``_make_kernel_folded``), twin
  ``folded_sweep_reference``: immediate corrections inside a micro-block,
  then one delayed ``jbb_od[:, lo:hi] @ ds[lo:hi]`` update of the block.

All are built by ``kernels/build.py``. ``FusedSweep`` picks the variant and
runs its twin only for tensors on the CPU. For a CUDA tensor it launches the
kernel or raises: a failed build or launch is an exception, never a
fallback. Each launch adds one to ``FusedSweep.launches``, and nothing else
does; ``FusedSweep.kernel_name`` names the variant's kernel.

Random numbers. ``FusedSweep.__call__`` takes a 64-bit sweep seed; every
variant draws Philox4x32-10 uniforms from it, keyed by (seed) with counter
(spin, replica), and ``philox_uniforms`` is the same stream in PyTorch, so
the CPU path and every kernel make the same decisions from the same seed.
``sweep_with_uniforms`` takes caller-supplied uniforms instead.

Glauber threshold: the kernels and the twins clamp u at ``GLAUBER_U_MAX``
(0.999999) inside log1p, as the Pallas kernel does;
``kernels.sweeps.accept_threshold`` does not clamp, as in the JAX package.
The two agree for u <= 0.999999.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.kernels.sweeps import canonical_rule

GLAUBER_U_MAX = 0.999999
MICRO = 32  # the folded variant's micro-block (the JAX package's default)
KERNEL_NAME = "metropolis_sweep"            # K1
PIPELINED_KERNEL = "metropolis_pipelined"   # K5
INTERLEAVED_KERNEL = "metropolis_interleaved"  # K6
FOLDED_KERNEL = "metropolis_folded"         # K7
INTERLEAVE_CHAINS = (2, 4)  # chains per warp K6 is built for

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a constant a < 2^32 and an int64
    tensor b of values in [0, 2^32), without overflowing int64."""
    p_lo = a * (b & 0xFFFF)          # < 2^48
    p_hi = a * (b >> 16)             # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding 32-bit words.

    ``counter`` is four broadcastable tensors (or ints), ``key`` two ints.
    Returns the four output words, as the kernel's generator computes them.
    """
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def philox_uniforms(seed: int, n_pad: int, r: int, device="cpu",
                    row0: int = 0) -> torch.Tensor:
    """[n_pad, R] float32 uniforms in (0, 1): the kernels' in-kernel stream
    for sweep seed ``seed`` (counter = (spin, replica, 0, 0)) at spin rows
    row0 .. row0 + n_pad - 1."""
    spin = torch.arange(row0, row0 + n_pad, dtype=torch.int64,
                        device=device)[:, None]
    rep = torch.arange(r, dtype=torch.int64, device=device)[None, :]
    x0 = philox4x32((spin, rep, 0, 0), (seed & _MASK32, seed >> 32))[0]
    return (((x0 >> 9) << 1) | 1).to(torch.float32) * 2.0 ** -24


def kernel_threshold(u: torch.Tensor, beta: torch.Tensor, rule: str) -> torch.Tensor:
    """The kernel's exp-free thresholds th (accept <=> s*f < th); u >= 1 maps
    to -inf. Glauber clamps u at GLAUBER_U_MAX inside log1p."""
    nib = -0.5 / beta
    if canonical_rule(rule) == "metropolis":
        th = torch.log(u) * nib
    else:
        th = (torch.log(u) - torch.log1p(-torch.clamp(u, max=GLAUBER_U_MAX))) * nib
    return torch.where(u < 1.0, th, torch.full_like(th, -torch.inf))


def diag_blocks(j: torch.Tensor, block_size: int) -> torch.Tensor:
    """[Np, Np] -> [Np, B]: stacked diagonal blocks J[bB:(b+1)B, bB:(b+1)B]."""
    n_pad = j.shape[-1]
    nb = n_pad // block_size
    jr = j.reshape(nb, block_size, nb, block_size)
    return jr.diagonal(dim1=0, dim2=2).permute(2, 0, 1).reshape(n_pad, block_size)


def sub_diag_blocks(j: torch.Tensor, block_size: int) -> torch.Tensor:
    """[Np, Np] -> [Np, B]: stacked sub-diagonal blocks J[bB:(b+1)B,
    (b-1)B:bB] (zeros for b = 0), the pipelined variant's repair operand."""
    n_pad = j.shape[-1]
    nb = n_pad // block_size
    jr = torch.roll(j.reshape(nb, block_size, nb, block_size), 1, dims=2)
    sub = jr.diagonal(dim1=0, dim2=2).permute(2, 0, 1).clone()
    sub[0] = 0.0
    return sub.reshape(n_pad, block_size)


def zero_micro_diag(jbb_all: torch.Tensor, block_size: int,
                    micro: int = MICRO) -> torch.Tensor:
    """Zero the [C, C] diagonal micro-blocks of each stacked [B, B] block."""
    keep = 1.0 - np.kron(np.eye(block_size // micro, dtype=np.float32),
                         np.ones((micro, micro), np.float32))
    tiles = np.tile(keep, (jbb_all.shape[0] // block_size, 1))
    return jbb_all * torch.as_tensor(tiles, device=jbb_all.device)


def _sweep_setup(spins_t, mask, beta, u_t, block_size):
    """Checks the block size; returns (beta [R], u_t with u = 2 on masked
    rows, dE accumulator, count accumulator)."""
    n_pad, r = spins_t.shape
    if n_pad % block_size:
        raise ValueError(f"padded N={n_pad} not divisible by block {block_size}")
    beta = torch.broadcast_to(beta.to(torch.float32), (r,))
    u_t = torch.where(mask[:, None] > 0, u_t, torch.full_like(u_t, 2.0))
    de = torch.zeros(r, dtype=torch.float32, device=spins_t.device)
    cnt = torch.zeros(r, dtype=torch.int32, device=spins_t.device)
    return beta, u_t, de, cnt


def _decide_block(sblk, hblk, th, jbb, de, cnt):
    """K1's in-block decisions: spin i of the block decides on its field,
    and an accepted flip corrects every field of the block at once. Updates
    ``sblk`` in place; returns (dE, count)."""
    for i in range(sblk.shape[0]):
        s_i, f_i = sblk[i], hblk[i]
        acc = s_i * f_i < th[i]
        ds = torch.where(acc, -2.0 * s_i, 0.0)
        sblk[i] = s_i + ds
        hblk = hblk + jbb[:, i:i + 1] * ds[None, :]
        de = de - ds * f_i
        cnt = cnt + acc.to(torch.int32)
    return de, cnt


def fused_sweep_reference(j: torch.Tensor, h: torch.Tensor, mask: torch.Tensor,
                          spins_t: torch.Tensor, beta: torch.Tensor,
                          u_t: torch.Tensor, rule: str = "metropolis",
                          block_size: int = 128):
    """Plain PyTorch twin of K1, in [Np, R] layout.

    Updates ``spins_t`` in place, like the kernel, and returns
    (spins_t, dE[R] float32, n_accepted[R] int32) with dE = -sum ds * f over
    the decisions. Rows with mask 0 get u = 2 (never accepted).
    """
    beta, u_t, de, cnt = _sweep_setup(spins_t, mask, beta, u_t, block_size)
    for i0 in range(0, spins_t.shape[0], block_size):
        i1 = i0 + block_size
        hblk = torch.matmul(j[i0:i1], spins_t) + h[i0:i1, None]   # [B, R]
        th = kernel_threshold(u_t[i0:i1], beta[None, :], rule)
        # spins_t[i0:i1] is a view: the flips land in spins_t
        de, cnt = _decide_block(spins_t[i0:i1], hblk, th, j[i0:i1, i0:i1],
                                de, cnt)
    return spins_t, de, cnt


def pipelined_sweep_reference(j, h, mask, spins_t, beta, u_t,
                              rule: str = "metropolis", block_size: int = 128):
    """Plain PyTorch twin of K5, as ``_make_kernel_pipe`` computes: block
    b+1's fields H_pre are taken from spins that do not yet hold block b's
    flips, then repaired with ``J[b+1, b] @ ds_b`` (``sub_diag_blocks``)
    before block b+1 decides. Contract of ``fused_sweep_reference``."""
    beta, u_t, de, cnt = _sweep_setup(spins_t, mask, beta, u_t, block_size)
    n_pad = spins_t.shape[0]
    jsub = sub_diag_blocks(j, block_size)
    h_pre = torch.matmul(j[:block_size], spins_t) + h[:block_size, None]
    ds_prev = None
    for i0 in range(0, n_pad, block_size):
        i1 = i0 + block_size
        hblk = h_pre
        if ds_prev is not None:  # the repair: block b-1's flips
            hblk = hblk + torch.matmul(jsub[i0:i1], ds_prev)
        i2 = i1 + block_size
        if i1 < n_pad:  # the producer's H_pre(b+1), before block b decides
            h_pre = torch.matmul(j[i1:i2], spins_t) + h[i1:i2, None]
        s_old = spins_t[i0:i1].clone()
        th = kernel_threshold(u_t[i0:i1], beta[None, :], rule)
        de, cnt = _decide_block(spins_t[i0:i1], hblk, th, j[i0:i1, i0:i1],
                                de, cnt)
        ds_prev = spins_t[i0:i1] - s_old
    return spins_t, de, cnt


def interleaved_sweep_reference(j, h, mask, spins_t, beta, u_t,
                                rule: str = "metropolis",
                                block_size: int = 128, nchains: int = 2):
    """Plain PyTorch twin of K6, as ``_make_kernel_interleaved`` computes:
    the replica columns split into ``nchains`` chains, each with private
    block fields, and each spin step runs chain 0, chain 1, ... in turn.
    Contract of ``fused_sweep_reference``."""
    beta, u_t, de, cnt = _sweep_setup(spins_t, mask, beta, u_t, block_size)
    r = spins_t.shape[1]
    ends = np.cumsum([0] + [len(c) for c in np.array_split(np.arange(r),
                                                           nchains)])
    chains = [slice(int(a), int(b)) for a, b in zip(ends[:-1], ends[1:])]
    for i0 in range(0, spins_t.shape[0], block_size):
        i1 = i0 + block_size
        th = kernel_threshold(u_t[i0:i1], beta[None, :], rule)
        jbb = j[i0:i1, i0:i1]
        hts = [torch.matmul(j[i0:i1], spins_t[:, c]) + h[i0:i1, None]
               for c in chains]
        for i in range(block_size):
            for ci, c in enumerate(chains):   # the interleave
                s_i, f_i = spins_t[i0 + i, c], hts[ci][i]
                acc = s_i * f_i < th[i, c]
                ds = torch.where(acc, -2.0 * s_i, 0.0)
                spins_t[i0 + i, c] = s_i + ds
                hts[ci] = hts[ci] + jbb[:, i:i + 1] * ds[None, :]
                de[c] = de[c] - ds * f_i
                cnt[c] = cnt[c] + acc.to(torch.int32)
    return spins_t, de, cnt


def folded_sweep_reference(j, h, mask, spins_t, beta, u_t,
                           rule: str = "metropolis", block_size: int = 128,
                           micro: int = MICRO):
    """Plain PyTorch twin of K7, as ``_make_kernel_folded`` computes: inside
    a micro-block of ``micro`` rows an accepted flip corrects the fields of
    the micro-block's later rows (from j+1); after each micro-block one
    delayed update ``jbb_od[:, lo:hi] @ ds[lo:hi]`` carries its flips to
    the rest of the block (diagonal micro-blocks zeroed, so nothing is
    corrected twice). Contract of ``fused_sweep_reference``."""
    if block_size % micro:
        raise ValueError(f"micro {micro} does not divide block {block_size}")
    beta, u_t, de, cnt = _sweep_setup(spins_t, mask, beta, u_t, block_size)
    jbb_all = diag_blocks(j, block_size)
    jbb_od_all = zero_micro_diag(jbb_all, block_size, micro)
    for i0 in range(0, spins_t.shape[0], block_size):
        i1 = i0 + block_size
        ht = torch.matmul(j[i0:i1], spins_t) + h[i0:i1, None]
        th = kernel_threshold(u_t[i0:i1], beta[None, :], rule)
        jbb, jbb_od = jbb_all[i0:i1], jbb_od_all[i0:i1]
        sblk = spins_t[i0:i1]  # view: flips land in spins_t
        dsb = torch.zeros_like(sblk)
        for lo in range(0, block_size, micro):
            hi = lo + micro
            for jj in range(lo, hi):
                s_i, f_i = sblk[jj], ht[jj]
                acc = s_i * f_i < th[jj]
                ds = torch.where(acc, -2.0 * s_i, 0.0)
                sblk[jj] = s_i + ds
                dsb[jj] = ds
                ht[jj + 1:hi] += jbb[jj + 1:hi, jj:jj + 1] * ds[None, :]
                de = de - ds * f_i
                cnt = cnt + acc.to(torch.int32)
            ht = ht + torch.matmul(jbb_od[:, lo:hi], dsb[lo:hi])
    return spins_t, de, cnt


def load_kernel(name: str = KERNEL_NAME) -> ctypes.CDLL:
    """Build (first use) and bind the library of K1 or of one of its
    variants (``csrc/<name>.cu``, entry point ``sgt_<name>``)."""
    from spinglass_tpu_torch.kernels import build

    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    extra = [i] if name in (INTERLEAVED_KERNEL, FOLDED_KERNEL) else []
    fn = getattr(lib, f"sgt_{name}")
    fn.argtypes = ([p, p, p, p, p, p, ctypes.c_ulonglong, p, p, i, i, i, i]
                   + extra + [p])
    fn.restype = i
    lib.sgt_cuda_error_string.argtypes = [i]
    lib.sgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


class FusedSweep:
    """Per-problem fused sweep, [Np, R] spin layout, updated in place.

    ``block_size`` 0 picks 256 when it divides Np, else 128 (the kernels
    take 128 or 256). ``rule`` is metropolis or glauber/heat_bath. The
    variant flags are the JAX package's: ``pipelined`` (K5), ``interleave``
    = 2 or 4 chains (K6; 0 and 1 are the flat K1) and ``folded`` (K7), with
    ``micro`` the folded variant's micro-block. K1, K5 and K6 correct the
    whole block after each flip, so ``micro`` does not change their
    decisions; the folded CUDA kernel is built for micro = 32 and raises
    for any other. Flags that cannot go together raise, as in the JAX
    package; the TPU-only rules (per-chain width % 128 lanes, replica tile
    % 8 for folding) are dropped, since CUDA columns beyond R are masked in
    every kernel. K6's tile is 8 * nchains columns, so the JAX rule
    "replica tile % nchains == 0" holds by construction.
    """

    layout = "nr"

    def __init__(self, problem: IsingProblem, block_size: int = 0,
                 rule: str = "metropolis", micro: int = MICRO,
                 pipelined: bool = False, folded: bool = False,
                 interleave: int = 0):
        n_pad = problem.n_padded
        if not block_size:
            block_size = 256 if n_pad % 256 == 0 else 128
        if block_size not in (128, 256) or n_pad % block_size:
            raise ValueError(
                f"block size {block_size} must be 128 or 256 and divide "
                f"padded N={n_pad}")
        if pipelined and folded:
            raise ValueError(
                "pipelined and folded kernel variants cannot combine — "
                "the pipelined builder has no folded form and silently "
                "running the flat kernel would misattribute measurements")
        if interleave and (pipelined or folded):
            raise ValueError("interleave cannot combine with pipelined/folded")
        if interleave not in (0, 1) + INTERLEAVE_CHAINS:
            raise ValueError(f"interleave must be 0, 1, 2 or 4 chains, got "
                             f"{interleave}")
        if micro < 1 or block_size % micro:
            raise ValueError(f"micro {micro} must divide block {block_size}")
        self.problem = problem
        self.block_size = block_size
        self.rule = canonical_rule(rule)
        self.micro = micro
        self.pipelined = pipelined
        self.folded = folded
        self.interleave = interleave if interleave > 1 else 0
        if pipelined:
            self.kernel_name = PIPELINED_KERNEL
        elif folded:
            self.kernel_name = FOLDED_KERNEL
        elif self.interleave:
            self.kernel_name = INTERLEAVED_KERNEL
        else:
            self.kernel_name = KERNEL_NAME
        self.launches = 0  # kernel launches made by this instance
        self._lib = None  # built and bound at the first CUDA launch

    def __call__(self, spins_t: torch.Tensor, beta, seed: int):
        """One sweep with in-kernel Philox uniforms from the 64-bit ``seed``.
        Returns (spins_t, dE[R] float32, n_accepted[R] int32)."""
        if spins_t.is_cuda:
            return self._launch(spins_t, beta, None, seed)
        n_pad, r = spins_t.shape
        u_t = philox_uniforms(seed, n_pad, r)
        return self.reference(spins_t, beta, u_t)

    def sweep_with_uniforms(self, spins_t: torch.Tensor, beta,
                            uniforms_t: torch.Tensor):
        """One sweep with caller-supplied uniforms [Np, R]."""
        if spins_t.is_cuda:
            return self._launch(spins_t, beta, uniforms_t, 0)
        return self.reference(spins_t, beta, uniforms_t)

    def _beta(self, beta, r: int, device) -> torch.Tensor:
        beta = torch.as_tensor(beta, dtype=torch.float32, device=device)
        return torch.broadcast_to(beta, (r,)).contiguous()

    def reference(self, spins_t, beta, u_t):
        """The variant's plain twin on uniforms ``u_t`` (any device)."""
        p = self.problem
        args = (p.j, p.h, p.active_mask, spins_t,
                self._beta(beta, spins_t.shape[1], spins_t.device), u_t,
                self.rule, self.block_size)
        if self.pipelined:
            return pipelined_sweep_reference(*args)
        if self.folded:
            return folded_sweep_reference(*args, micro=self.micro)
        if self.interleave:
            return interleaved_sweep_reference(*args, nchains=self.interleave)
        return fused_sweep_reference(*args)

    def _launch(self, spins_t, beta, u_t, seed: int):
        p = self.problem
        n_pad, r = spins_t.shape
        dev = spins_t.device
        for name, t in (("J", p.j), ("h", p.h), ("mask", p.active_mask)):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"problem {name} must be contiguous float32 on {dev}")
        if (spins_t.dtype != torch.float32 or not spins_t.is_contiguous()
                or n_pad != p.n_padded):
            raise ValueError(f"spins_t must be contiguous float32 [{p.n_padded}, R]")
        if u_t is not None and (u_t.shape != spins_t.shape or u_t.device != dev
                                or u_t.dtype != torch.float32
                                or not u_t.is_contiguous()):
            raise ValueError("uniforms_t must be contiguous float32 like spins_t")
        if not 0 <= seed < 2 ** 64:
            raise ValueError(f"seed {seed} is not a 64-bit unsigned value")
        if self.folded and self.micro != MICRO:
            raise ValueError(f"the folded CUDA kernel is built for micro="
                             f"{MICRO}, got {self.micro}")
        if self._lib is None:
            self._lib = load_kernel(self.kernel_name)
        lib = self._lib
        beta = self._beta(beta, r, dev)
        de = torch.empty(r, dtype=torch.float32, device=dev)
        cnt = torch.empty(r, dtype=torch.int32, device=dev)
        extra = ([self.interleave] if self.interleave
                 else [self.micro] if self.folded else [])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"sgt_{self.kernel_name}")(
                p.j.data_ptr(), p.h.data_ptr(), p.active_mask.data_ptr(),
                spins_t.data_ptr(), beta.data_ptr(),
                None if u_t is None else u_t.data_ptr(), seed,
                de.data_ptr(), cnt.data_ptr(), n_pad, r, self.block_size,
                0 if self.rule == "metropolis" else 1, *extra, stream)
        if err != 0:
            msg = lib.sgt_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.kernel_name} launch failed: CUDA error "
                               f"{err} ({msg})")
        self.launches += 1
        return spins_t, de, cnt


def blocked_sweep_cuda(problem: IsingProblem, spins: torch.Tensor, beta,
                       uniforms: torch.Tensor, block_size: int = 128,
                       rule: str = "metropolis"):
    """[R, Np] host-uniform sweep with the contract of
    ``kernels.sweeps.blocked_sweep`` (the input spins are not modified).
    Returns (spins [R, Np], dE[R], n_accepted[R])."""
    sweep = FusedSweep(problem, block_size=block_size, rule=rule)
    s_t = spins.t().clone(memory_format=torch.contiguous_format)
    s_t, de, cnt = sweep.sweep_with_uniforms(s_t, beta,
                                             uniforms.t().contiguous())
    return s_t.t().contiguous(), de, cnt
