"""Fused whole-sweep dense Metropolis/Glauber: K1 and its variants K5-K7.

The counterpart of ``spinglass_tpu.kernels.metropolis_pallas``. Each kernel
runs one exact sequential-equivalent sweep over dense J per launch, on spins
in [Np, R] ("nr") layout, updated in place, and has a plain PyTorch twin
here that expresses the same algorithm:

* K1 ``csrc/metropolis_sweep.cu`` (``_make_kernel``), twin
  ``fused_sweep_reference``: the blocked algorithm of
  ``kernels.sweeps.blocked_sweep`` in [Np, R] layout. On the card a replica
  tile of 72 columns is shared by a cluster of 8 thread blocks and the block
  fields come from bf16 tensor-core products of J split exactly into three
  bf16 planes (``bf16_planes``; one plane where J is exact in bf16).
  ``dense_tile`` says which shapes that kernel takes; beyond them the
  one-block float32 kernel runs. ``StackedFusedSweep`` launches K1 over P
  stacked problems at once (problem p on the grid's y axis), the batch
  path's sweep;
* K5 ``csrc/metropolis_pipelined.cu`` (``_make_kernel_pipe``), twin
  ``pipelined_sweep_reference``: block b+1's fields are computed before
  block b's flips and repaired with ``J[b+1, b] @ ds_b``; on the card K1's
  cluster design with the fields and the decisions in warps of their own
  (``pipelined_tile`` says which shapes; beyond them a one-block float32
  kernel);
* K6 ``csrc/metropolis_interleaved.cu`` (``_make_kernel_interleaved``), twin
  ``interleaved_sweep_reference``: the replicas split into chains with
  private fields, stepped in interleaved order; on the card K1's cluster
  design, the chains' columns one per decision warp, stepped side by side
  by the warp schedulers (at K1's shapes, ``dense_tile``; beyond them the
  one-block float32 kernel at 8 columns per chain);
* K7 ``csrc/metropolis_folded.cu`` (``_make_kernel_folded``), twin
  ``folded_sweep_reference``: immediate corrections inside a micro-block,
  then one delayed ``jbb_od[:, lo:hi] @ ds[lo:hi]`` update of the block;
  on the card K1's cluster design, one thread per column deciding a
  micro-block and the delayed update on the tensor cores (``folded_tile``;
  beyond it a one-block float32 kernel). The four dense kernels compute
  one function and share one bound (``dense_sweep_bound``).

All are built by ``kernels/build.py``. ``FusedSweep`` picks the variant and
runs its twin only for tensors on the CPU. For a CUDA tensor it launches the
kernel or raises: a failed build or launch is an exception, never a
fallback. Each launch is counted under ``FusedSweep.kernel_name``, the
variant's kernel, in the launch ledger (``build.LAUNCHES``).

``j_dtype="bfloat16"`` (the JAX package's mode) rounds J once to bfloat16:
every kernel and twin then sweeps on ``j.bfloat16().float()``, diagonal
blocks included, and K1 multiplies one plane.

Random numbers. ``FusedSweep.__call__`` takes a 64-bit sweep seed; every
variant draws Philox4x32-10 uniforms from it, keyed by (seed) with counter
(spin, replica), and ``philox_uniforms`` is the same stream in PyTorch, so
the CPU path and every kernel make the same decisions from the same seed.
The seed is a host int, passed to the kernel by value, or a seed slot: an
int64 tensor of one element on the spins' device, whose address the kernel
reads it from (``seed_arg``). A captured graph (``anneal/graphs.py``)
replays a launch with whatever seed its slot then holds; the twins read a
slot on the CPU with ``int``, and compute on a CUDA slot where it lies.
``sweep_with_uniforms`` takes caller-supplied uniforms instead. The sparse
kernels (``kernels/sparse_cuda.py``) draw ``philox_uniforms4``: the same
generator with counter (sorted row, replica // 4), whose four output words
serve four neighbouring replicas; the Swendsen-Wang kernels
(``kernels/cluster_cuda.py``) ``sw_philox_words``, counter (site, replica //
4, slot, tag), and ``sw_philox_draws`` spells one sweep's draws out.

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
# LAUNCHES, the launch ledger's read-only view, stays importable from here
from spinglass_tpu_torch.kernels.build import LAUNCHES, count_launches  # noqa
from spinglass_tpu_torch.kernels.sweeps import canonical_rule

GLAUBER_U_MAX = 0.999999
MICRO = 32  # the folded variant's micro-block (the JAX package's default)
KERNEL_NAME = "metropolis_sweep"            # K1
PIPELINED_KERNEL = "metropolis_pipelined"   # K5
INTERLEAVED_KERNEL = "metropolis_interleaved"  # K6
FOLDED_KERNEL = "metropolis_folded"         # K7
INTERLEAVE_CHAINS = (2, 4)  # chains per warp K6 is built for
J_DTYPES = ("float32", "bfloat16")
CLUSTER_TILE = (72, 8)   # K1's cluster kernel: replica columns, thread blocks
BLOCK_TILE = (8, 1)      # K1's one-block kernel
PIPELINED_BLOCK_TILE = (8, 1)   # K5's one-block kernel
FOLDED_BLOCK_TILE = (32, 1)     # K7's one-block kernel
SMEM_PER_BLOCK = 232448  # bytes of shared memory a thread block can use (H100)


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


def seed_arg(seed, device):
    """(value, address) of a sweep seed for a kernel launch on ``device``:
    a host int goes by value (address None), a seed slot (an int64 tensor of
    one element on ``device``) by its address. Raises on anything else."""
    if isinstance(seed, torch.Tensor):
        if (seed.dtype != torch.int64 or seed.numel() != 1
                or seed.device != torch.device(device)):
            raise ValueError(f"a seed slot is one int64 on {device}, got "
                             f"{seed.dtype} {tuple(seed.shape)} on "
                             f"{seed.device}")
        return 0, seed.data_ptr()
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is not a 64-bit unsigned value")
    return int(seed), None


def _key(seed):
    """Philox's (k0, k1) of a sweep seed: a host int or a seed slot (read
    with ``int`` on the CPU, kept as a tensor on a CUDA device)."""
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(())) if not seed.is_cuda else seed.reshape(())
    return seed & _MASK32, seed >> 32


def word_uniforms(x: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in (0, 1) from Philox output words (``word_uniform``
    in csrc/philox.cuh)."""
    return (((x >> 9) << 1) | 1).to(torch.float32) * 2.0 ** -24


def philox_uniforms(seed, n_pad: int, r: int, device="cpu",
                    row0: int = 0) -> torch.Tensor:
    """[n_pad, R] float32 uniforms in (0, 1): the kernels' in-kernel stream
    for sweep seed ``seed`` (counter = (spin, replica, 0, 0)) at spin rows
    row0 .. row0 + n_pad - 1. ``seed`` is an int or a seed slot."""
    spin = torch.arange(row0, row0 + n_pad, dtype=torch.int64,
                        device=device)[:, None]
    rep = torch.arange(r, dtype=torch.int64, device=device)[None, :]
    return word_uniforms(philox4x32((spin, rep, 0, 0), _key(seed))[0])


def philox_uniforms4(seed, n_pad: int, r: int, device="cpu",
                     row0: int = 0) -> torch.Tensor:
    """[n_pad, R] float32 uniforms in (0, 1): the sparse kernels' stream
    (K2, K3, K4) for sweep seed ``seed`` at sorted rows row0 .. row0 + n_pad
    - 1. One Philox call per row and group of four replicas, counter (row,
    replica >> 2, 0, 0); output word q is the uniform of replica 4 * group
    + q (``philox_uniform4`` in csrc/philox.cuh)."""
    row = torch.arange(row0, row0 + n_pad, dtype=torch.int64,
                       device=device)[:, None]
    group = torch.arange(-(-r // 4), dtype=torch.int64, device=device)[None, :]
    words = philox4x32((row, group, 0, 0), _key(seed))
    return word_uniforms(torch.stack(words, dim=2).reshape(n_pad, -1)[:, :r])


SW_TAG_BOND, SW_TAG_GHOST, SW_TAG_COIN = 0, 1, 2


def sw_philox_words(seed, r: int, site: torch.Tensor, slot, tag: int
                    ) -> torch.Tensor:
    """int64 words [R, *site's shape] of the Swendsen-Wang stream (C2, C1:
    ``csrc/philox.cuh``) for sweep seed ``seed``: replica 4g + c takes word c
    of Philox counter (site, g, slot, tag). ``site`` is an int64 tensor,
    ``slot`` an int or a tensor broadcast with it."""
    group = torch.arange(-(-r // 4), dtype=torch.int64, device=site.device)
    group = group.reshape(-1, *([1] * site.dim()))
    slot = torch.as_tensor(slot, dtype=torch.int64, device=site.device)
    words = philox4x32((site[None], group, slot[None], tag), _key(seed))
    x = torch.stack(torch.broadcast_tensors(*words), dim=1)   # [G, 4, ...]
    return x.reshape(-1, *x.shape[2:])[:r]


def sw_philox_draws(seed, r: int, n_pad: int, k: int, device="cpu"):
    """One Swendsen-Wang sweep's draws in the Philox mode of C2 and C1, as
    the given mode takes them: u_dir [R, Np, K] (slot q of site i: tag 0 at
    counter (i, r // 4, q)), u_ghost [R, Np] (tag 1) and coins [R, Np] bool
    (tag 2, the word's top bit). Fed to ``SwendsenWang.sweep_with_draws``
    they give what ``SwendsenWang.sweep`` gives under ``seed``, bit for bit:
    both ends of an edge read the lower end's u_dir, and C2 draws that word
    at the lower end's counter."""
    site = torch.arange(n_pad, dtype=torch.int64, device=device)
    u_dir = word_uniforms(sw_philox_words(
        seed, r, site[:, None], torch.arange(k, device=device)[None, :],
        SW_TAG_BOND))
    u_ghost = word_uniforms(sw_philox_words(seed, r, site, 0, SW_TAG_GHOST))
    coins = (sw_philox_words(seed, r, site, 0, SW_TAG_COIN) >> 31) == 1
    return u_dir, u_ghost, coins


def kernel_threshold(u: torch.Tensor, beta: torch.Tensor, rule: str) -> torch.Tensor:
    """The kernel's exp-free thresholds th (accept <=> s*f < th); u >= 1 maps
    to -inf. Glauber clamps u at GLAUBER_U_MAX inside log1p."""
    nib = -0.5 / beta
    if canonical_rule(rule) == "metropolis":
        th = torch.log(u) * nib
    else:
        th = (torch.log(u) - torch.log1p(-torch.clamp(u, max=GLAUBER_U_MAX))) * nib
    return torch.where(u < 1.0, th, torch.full_like(th, -torch.inf))


def bf16_planes(j: torch.Tensor):
    """The exact split of float32 ``j`` that K1 makes in registers:
    hi = bf16(j), mid = bf16(j - hi), lo = bf16(j - hi - mid), each rounded
    to nearest even. Returned as float32 tensors; hi + mid + lo == j bit for
    bit (8 + 8 + 8 mantissa bits)."""
    hi = j.bfloat16().float()
    r = j - hi
    mid = r.bfloat16().float()
    lo = (r - mid).bfloat16().float()
    return hi, mid, lo


def planes_needed(j: torch.Tensor) -> int:
    """1 where ``j`` is exact in bfloat16 (its mid and lo planes are zero:
    +-J, small dyadic grids, J already rounded), else 3."""
    return 1 if bool((j.bfloat16().float() == j).all()) else 3


def plane_fields(j: torch.Tensor, spins_t: torch.Tensor,
                 planes: int = 3) -> torch.Tensor:
    """Plain twin of K1's field phase: J @ s as the float32 sum of the
    planes' products, lo first (spins +-1, so every product is exact).
    ``planes`` = 1 multiplies the hi plane only. [Np, Np] x [Np, R]."""
    hi, mid, lo = bf16_planes(j)
    if planes == 1:
        return torch.matmul(hi, spins_t)
    return (torch.matmul(lo, spins_t) + torch.matmul(mid, spins_t)
            + torch.matmul(hi, spins_t))


def _padded_words(words: int) -> int:
    """``words`` padded to 8 mod 32 (``spin_stride_words`` in
    ``csrc/cluster_sweep.cuh``)."""
    return words + (40 - words % 32) % 32


def _cluster_spin_bytes(n_pad: int) -> int:
    """A cluster block's n_pad / 8 spin rows of the 72-column tile as bf16,
    each column padded to 8 mod 32 words (``csrc/cluster_sweep.cuh``)."""
    rt, cluster = CLUSTER_TILE
    return rt * _padded_words(n_pad // cluster // 2) * 4


def cluster_smem_bytes(n_pad: int, block_size: int) -> int:
    """Dynamic shared memory per thread block of K1's cluster kernel (as
    ``csrc/metropolis_sweep.cu`` lays it out): the block's spin rows, the
    partial fields, two buffers of 32 rows of J's diagonal block and the
    block's fields."""
    rt, cluster = CLUSTER_TILE
    return (_cluster_spin_bytes(n_pad) + rt * block_size * 4
            + 2 * 32 * block_size * 4 + block_size * (rt // cluster) * 4)


def pipelined_smem_bytes(n_pad: int, block_size: int) -> int:
    """Dynamic shared memory per thread block of K5's cluster kernel
    (``csrc/metropolis_pipelined.cu``): K1's spins, partials and fields,
    two buffers of rows of J's diagonal block (32 rows at block 128, 16 at
    256) and the tensor-core repair's ds operand, 16 columns of
    block / 2 bf16 pairs, padded to 8 mod 32 words."""
    rt, cluster = CLUSTER_TILE
    rows = 32 if block_size == 128 else 16
    return (_cluster_spin_bytes(n_pad) + rt * block_size * 4
            + block_size * (rt // cluster) * 4 + 2 * rows * block_size * 4
            + 16 * _padded_words(block_size // 2) * 4)


def folded_smem_bytes(n_pad: int, block_size: int) -> int:
    """Dynamic shared memory per thread block of K7's cluster kernel
    (``csrc/metropolis_folded.cu``): the spin rows and partial fields as
    K1's, the block's diagonal micro-blocks (32 x block floats), its fields,
    spins and thresholds [block][9], and the delayed product's ds operand
    (16 columns of 20 words)."""
    rt, cluster = CLUSTER_TILE
    return (_cluster_spin_bytes(n_pad) + rt * block_size * 4
            + MICRO * block_size * 4 + 3 * block_size * (rt // cluster) * 4
            + 16 * 20 * 4)


def dense_tile(n_pad: int, block_size: int):
    """(replica columns per tile, thread blocks per cluster) of K1 at this
    shape. The cluster kernel, (72, 8), keeps 18 * n_pad bytes of spins per
    block, so it goes up to n_pad = 8320 at block 128 and 4224 at block
    256; beyond that the one-block float32 kernel (8, 1) runs, at any
    n_pad. The replica count does not enter: a block of the cluster kernel
    always decides 9 columns, and 72 is the width at which the H100's 15
    resident clusters of 8 take R = 1024 in one wave (tiles of 64 would be
    16 clusters and two waves)."""
    if cluster_smem_bytes(n_pad, block_size) <= SMEM_PER_BLOCK:
        return CLUSTER_TILE
    return BLOCK_TILE


def pipelined_tile(n_pad: int, block_size: int):
    """K5's tile at this shape: the cluster kernel (72, 8) while
    ``pipelined_smem_bytes`` fits a thread block (n_pad up to 8320 at block
    128, 5632 at 256), else the one-block float32 kernel, 8 columns a block
    (``PIPELINED_BLOCK_TILE``). A dispatch by shape, as ``dense_tile``."""
    if pipelined_smem_bytes(n_pad, block_size) <= SMEM_PER_BLOCK:
        return CLUSTER_TILE
    return PIPELINED_BLOCK_TILE


def folded_tile(n_pad: int, block_size: int):
    """K7's tile at this shape: the cluster kernel (72, 8) while
    ``folded_smem_bytes`` fits a thread block (n_pad up to 8832 at block
    128, 5120 at 256), else the one-block float32 kernel, 32 columns a
    block (``FOLDED_BLOCK_TILE``)."""
    if folded_smem_bytes(n_pad, block_size) <= SMEM_PER_BLOCK:
        return CLUSTER_TILE
    return FOLDED_BLOCK_TILE


# kernel name -> its tile rule. K6's cluster kernel lays out K1's shared
# memory, so K1's rule decides between it and the one-block kernel (whose
# tile FusedSweep widens to 8 columns per chain)
TILE_RULES = {KERNEL_NAME: dense_tile, PIPELINED_KERNEL: pipelined_tile,
              INTERLEAVED_KERNEL: dense_tile, FOLDED_KERNEL: folded_tile}


def cluster_envelope(kernel_name: str, block_size: int) -> int:
    """The largest n_pad (a multiple of ``block_size``) at which the named
    kernel runs its cluster kernel; one block more runs the one-block
    float32 kernel."""
    rule = TILE_RULES[kernel_name]
    n_pad = block_size
    while rule(n_pad + block_size, block_size) == CLUSTER_TILE:
        n_pad += block_size
    return n_pad


# published peaks of one H100 SXM (NVIDIA's data sheet): device memory and
# the bf16 tensor cores
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
DENSE_KERNELS = (KERNEL_NAME, PIPELINED_KERNEL, INTERLEAVED_KERNEL,
                 FOLDED_KERNEL)


def dense_sweep_bound(kernel_name: str, n_pad: int, r: int, planes: int):
    """(least milliseconds the card could take, "bytes" or "operations") for
    one dense sweep at [n_pad, r] by any of K1, K5, K6 and K7: they compute
    one function, so they share one bound, the work's. Bytes: J read once,
    the spins read and written, h, mask, beta, dE and counts. Operations:
    ``planes`` x 2 n_pad^2 r on the bf16 tensor cores (J's exact planes;
    one where J is exact in bf16)."""
    if kernel_name not in DENSE_KERNELS:
        raise ValueError(f"{kernel_name} is not a dense sweep kernel")
    nbytes = 4 * n_pad * n_pad + 8 * n_pad * r + 8 * n_pad + 12 * r
    ops = planes * 2.0 * n_pad * n_pad * r
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


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
    # K1 and K5: planes, cluster; K6: chains, K7: micro, then planes, cluster
    extra = [i, i, i] if name in (INTERLEAVED_KERNEL, FOLDED_KERNEL) else [i, i]
    fn = getattr(lib, f"sgt_{name}")
    fn.argtypes = ([p, p, p, p, p, p, ctypes.c_ulonglong, p, p, p, i, i, i, i]
                   + extra + [p])
    fn.restype = i
    if name == KERNEL_NAME:
        lib.sgt_metropolis_sweep_stacked.argtypes = fn.argtypes[:-1] + [i, p]
        lib.sgt_metropolis_sweep_stacked.restype = i
        lib.sgt_metropolis_sweep_clusters.argtypes = [i, i, i, i, p]
        lib.sgt_metropolis_sweep_clusters.restype = i
    smem = getattr(lib, f"sgt_{name}_smem")  # the cluster kernel's bytes
    smem.argtypes = [i, i]
    smem.restype = ctypes.c_longlong
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
    every kernel. K6's tiles (72 columns, or 8 * nchains in its one-block
    kernel) hold every chain's columns, so the JAX rule "replica tile %
    nchains == 0" needs no check.

    ``j_dtype`` "bfloat16" sweeps on J rounded once to bfloat16 (kept as
    float32 values, diagonal blocks included), as the JAX package's
    ``FusedSweep(j_dtype=jnp.bfloat16)`` does. The spins must be +-1: K1
    keeps them as bf16 in shared memory. ``tile`` is ``dense_tile``'s
    answer for this problem (``pipelined_tile`` and ``folded_tile`` for K5
    and K7, which have cluster kernels of their own; K6's one-block tile is
    8 columns per chain), and ``planes`` the number of bf16 planes of J
    that the cluster kernels multiply (counted once: at construction on the
    card, at first use on the CPU). A problem whose J changes in place
    after the sweep is built (``research.quantum.TrotterProblem``) declares
    ``j_planes = 3``: a count taken from its first J could be 1, and a later
    J would then be swept on its hi plane alone.
    """

    layout = "nr"

    def __init__(self, problem: IsingProblem, block_size: int = 0,
                 rule: str = "metropolis", micro: int = MICRO,
                 pipelined: bool = False, folded: bool = False,
                 interleave: int = 0, j_dtype: str = "float32"):
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
        if j_dtype not in J_DTYPES:
            raise ValueError(f"j_dtype must be one of {J_DTYPES}, got "
                             f"{j_dtype!r}")
        self.problem = problem
        self.j_dtype = j_dtype
        # the couplings every kernel and twin of this sweep reads
        self.j = (problem.j if j_dtype == "float32"
                  else problem.j.bfloat16().to(problem.j.dtype))
        # on the card the planes are counted now: a later sweep must not
        # wait for the device. A problem whose J is rewritten in place
        # between sweeps names its count (``j_planes``) instead
        self._planes = (1 if j_dtype == "bfloat16"
                        else getattr(problem, "j_planes", None)
                        or (planes_needed(self.j) if self.j.is_cuda else None))
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
        self.tile = TILE_RULES[self.kernel_name](n_pad, block_size)
        if self.interleave and self.tile != CLUSTER_TILE:
            self.tile = (8 * self.interleave, 1)  # K6's one-block kernel
        self._lib = None  # built and bound at the first CUDA launch

    def __call__(self, spins_t: torch.Tensor, beta, seed):
        """One sweep with in-kernel Philox uniforms from the 64-bit ``seed``
        (a host int or a seed slot, ``seed_arg``). Returns (spins_t, dE[R]
        float32, n_accepted[R] int32)."""
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

    @property
    def planes(self) -> int:
        """bf16 planes of J that K1's cluster kernel multiplies: 1 where J
        is exact in bfloat16, else 3 (one pass over J, the first time)."""
        if self._planes is None:
            self._planes = planes_needed(self.j)
        return self._planes

    def _beta(self, beta, r: int, device) -> torch.Tensor:
        beta = torch.as_tensor(beta, dtype=torch.float32, device=device)
        return torch.broadcast_to(beta, (r,)).contiguous()

    def reference(self, spins_t, beta, u_t):
        """The variant's plain twin on uniforms ``u_t`` (any device)."""
        p = self.problem
        args = (self.j, p.h, p.active_mask, spins_t,
                self._beta(beta, spins_t.shape[1], spins_t.device), u_t,
                self.rule, self.block_size)
        if self.pipelined:
            return pipelined_sweep_reference(*args)
        if self.folded:
            return folded_sweep_reference(*args, micro=self.micro)
        if self.interleave:
            return interleaved_sweep_reference(*args, nchains=self.interleave)
        return fused_sweep_reference(*args)

    def _launch(self, spins_t, beta, u_t, seed):
        p = self.problem
        n_pad, r = spins_t.shape
        dev = spins_t.device
        for name, t in (("J", self.j), ("h", p.h), ("mask", p.active_mask)):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"problem {name} must be contiguous float32 on {dev}")
        if (spins_t.dtype != torch.float32 or not spins_t.is_contiguous()
                or n_pad != p.n_padded):
            raise ValueError(f"spins_t must be contiguous float32 [{p.n_padded}, R]")
        if u_t is not None and (u_t.shape != spins_t.shape or u_t.device != dev
                                or u_t.dtype != torch.float32
                                or not u_t.is_contiguous()):
            raise ValueError("uniforms_t must be contiguous float32 like spins_t")
        seed, seed_ptr = seed_arg(seed, dev)
        if self.folded and self.micro != MICRO:
            raise ValueError(f"the folded CUDA kernel is built for micro="
                             f"{MICRO}, got {self.micro}")
        if self._lib is None:
            self._lib = load_kernel(self.kernel_name)
        lib = self._lib
        beta = self._beta(beta, r, dev)
        de = torch.empty(r, dtype=torch.float32, device=dev)
        cnt = torch.empty(r, dtype=torch.int32, device=dev)
        # K6's chains or K7's micro, then the planes of J and the cluster
        # size of the tile
        extra = ([self.interleave] if self.interleave else
                 [self.micro] if self.folded else []) + [self.planes,
                                                         self.tile[1]]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"sgt_{self.kernel_name}")(
                self.j.data_ptr(), p.h.data_ptr(), p.active_mask.data_ptr(),
                spins_t.data_ptr(), beta.data_ptr(),
                None if u_t is None else u_t.data_ptr(), seed, seed_ptr,
                de.data_ptr(), cnt.data_ptr(), n_pad, r, self.block_size,
                0 if self.rule == "metropolis" else 1, *extra, stream)
        if err != 0:
            msg = lib.sgt_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.kernel_name} launch failed: CUDA error "
                               f"{err} ({msg})")
        count_launches({self.kernel_name: 1})
        return spins_t, de, cnt


def stacked_seed_arg(seeds, problems: int, device):
    """(value, address, keep) of the per-problem sweep seeds of a stacked
    K1 launch on ``device``: a [P] int64 seed slot there goes by its
    address; P host ints are copied there first (``keep`` is that tensor,
    held until the launch is queued); one problem's int goes by value, as
    ``FusedSweep`` passes it."""
    if isinstance(seeds, torch.Tensor):
        if (seeds.dtype != torch.int64 or seeds.shape != (problems,)
                or seeds.device != torch.device(device)
                or not seeds.is_contiguous()):
            raise ValueError(f"stacked seeds are a contiguous [{problems}] "
                             f"int64 tensor on {device}, got {seeds.dtype} "
                             f"{tuple(seeds.shape)} on {seeds.device}")
        return 0, seeds.data_ptr(), None
    seeds = [int(x) for x in seeds]
    if len(seeds) != problems:
        raise ValueError(f"{len(seeds)} seeds for {problems} problems")
    if problems == 1:
        value, _ = seed_arg(seeds[0], device)
        return value, None, None
    for x in seeds:
        seed_arg(x, device)
    keep = torch.tensor([x - 2 ** 64 if x >= 2 ** 63 else x for x in seeds],
                        dtype=torch.int64, device=device)
    return 0, keep.data_ptr(), keep


def _seed_list(seeds, problems: int) -> list:
    """The per-problem seeds as host ints or 0-d slots (the twins' form)."""
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.reshape(-1)
        if seeds.numel() != problems:
            raise ValueError(f"{seeds.numel()} seeds for {problems} problems")
        return [seeds[p] for p in range(problems)]
    seeds = list(seeds)
    if len(seeds) != problems:
        raise ValueError(f"{len(seeds)} seeds for {problems} problems")
    return seeds


class StackedFusedSweep:
    """K1 over P stacked problems of one padded size, in one launch: the
    port's counterpart of the JAX batch path's ``vmap`` of the blocked sweep
    (``anneal/batch.py``). Problem p is the kernel's ``blockIdx.y``; J is
    [P, Np, Np], h and mask [P, Np], spins [P, Np, R] (updated in place),
    beta [P, R] (or anything that broadcasts to it) and the seeds one per
    problem: a [P] int64 seed slot on the spins' device, or P host ints.
    Problem p makes the decisions of ``FusedSweep`` on its own J, h and mask
    under its seed, bit for bit, and P = 1 is ``FusedSweep``'s launch.
    ``planes`` is counted over the stack (3 if any problem's J needs them)
    unless given; ``tile`` is ``dense_tile``'s answer. On CPU tensors the
    plain twin (``fused_sweep_reference`` per problem) runs; on CUDA tensors
    the kernel launches or raises. Each launch is counted in the ledger."""

    layout = "nr"
    kernel_name = KERNEL_NAME

    def __init__(self, j: torch.Tensor, h: torch.Tensor, mask: torch.Tensor,
                 block_size: int = 128, rule: str = "metropolis",
                 planes=None):
        if j.dim() != 3 or j.shape[1] != j.shape[2]:
            raise ValueError(f"J must be [P, Np, Np], got {tuple(j.shape)}")
        n_problems, n_pad = j.shape[0], j.shape[1]
        if h.shape != (n_problems, n_pad) or mask.shape != (n_problems, n_pad):
            raise ValueError(f"h and mask must be [{n_problems}, {n_pad}]")
        if block_size not in (128, 256) or n_pad % block_size:
            raise ValueError(
                f"block size {block_size} must be 128 or 256 and divide "
                f"padded N={n_pad}")
        if planes not in (None, 1, 3):
            raise ValueError(f"planes must be 1 or 3, got {planes}")
        self.j, self.h, self.mask = j, h, mask
        self.n_problems, self.n_pad = n_problems, n_pad
        self.block_size = block_size
        self.rule = canonical_rule(rule)
        self.tile = dense_tile(n_pad, block_size)
        self._planes = planes
        self._lib = None

    @property
    def planes(self) -> int:
        """bf16 planes of J the cluster kernel multiplies: 1 where every
        problem's J is exact in bfloat16, else 3."""
        if self._planes is None:
            self._planes = planes_needed(self.j)
        return self._planes

    def _beta(self, beta, r: int, device) -> torch.Tensor:
        beta = torch.as_tensor(beta, dtype=torch.float32, device=device)
        return torch.broadcast_to(beta, (self.n_problems, r)).contiguous()

    def __call__(self, spins: torch.Tensor, beta, seeds):
        """One sweep of every problem, problem p's uniforms Philox under
        seed p. Returns (spins, dE [P, R] float32, n_accepted [P, R] int32)."""
        if spins.is_cuda:
            return self._launch(spins, beta, None, seeds)
        seeds = _seed_list(seeds, self.n_problems)
        u = torch.stack([philox_uniforms(sd, self.n_pad, spins.shape[2])
                         for sd in seeds])
        return self.reference(spins, beta, u)

    def sweep_with_uniforms(self, spins: torch.Tensor, beta,
                            uniforms: torch.Tensor):
        """One sweep with caller-supplied uniforms [P, Np, R]."""
        if spins.is_cuda:
            return self._launch(spins, beta, uniforms, None)
        return self.reference(spins, beta, uniforms)

    def reference(self, spins, beta, u):
        """The plain twin: ``fused_sweep_reference`` on each problem in
        turn (any device; the CPU path)."""
        beta = self._beta(beta, spins.shape[2], spins.device)
        des, cnts = [], []
        for p in range(self.n_problems):
            _, de, cnt = fused_sweep_reference(
                self.j[p], self.h[p], self.mask[p], spins[p], beta[p], u[p],
                self.rule, self.block_size)
            des.append(de)
            cnts.append(cnt)
        return spins, torch.stack(des), torch.stack(cnts)

    def _launch(self, spins, beta, u, seeds):
        n_problems, n_pad = self.n_problems, self.n_pad
        dev = spins.device
        for name, t in (("J", self.j), ("h", self.h), ("mask", self.mask)):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"stacked {name} must be contiguous float32 "
                                 f"on {dev}")
        if (spins.dtype != torch.float32 or not spins.is_contiguous()
                or spins.dim() != 3 or spins.shape[:2] != (n_problems, n_pad)):
            raise ValueError(f"spins must be contiguous float32 "
                             f"[{n_problems}, {n_pad}, R]")
        r = spins.shape[2]
        if u is not None and (u.shape != spins.shape or u.device != dev
                              or u.dtype != torch.float32
                              or not u.is_contiguous()):
            raise ValueError("uniforms must be contiguous float32 like spins")
        seed, seed_ptr, keep = ((0, None, None) if u is not None else
                                stacked_seed_arg(seeds, n_problems, dev))
        if self._lib is None:
            self._lib = load_kernel(KERNEL_NAME)
        beta = self._beta(beta, r, dev)
        de = torch.empty(n_problems, r, dtype=torch.float32, device=dev)
        cnt = torch.empty(n_problems, r, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._lib.sgt_metropolis_sweep_stacked(
                self.j.data_ptr(), self.h.data_ptr(), self.mask.data_ptr(),
                spins.data_ptr(), beta.data_ptr(),
                None if u is None else u.data_ptr(), seed, seed_ptr,
                de.data_ptr(), cnt.data_ptr(), n_pad, r, self.block_size,
                0 if self.rule == "metropolis" else 1, self.planes,
                self.tile[1], n_problems, stream)
        if err != 0:
            msg = self._lib.sgt_cuda_error_string(err).decode()
            raise RuntimeError(f"{KERNEL_NAME} (stacked, P={n_problems}) "
                               f"launch failed: CUDA error {err} ({msg})")
        del keep   # freed to this stream: reused only after the launch
        count_launches({KERNEL_NAME: 1})
        return spins, de, cnt


def cluster_occupancy(n_pad: int, r: int, block_size: int,
                      planes: int = 3) -> dict:
    """What the card holds of K1's cluster kernel at this shape: the
    clusters of 8 thread blocks resident at once (the launch has
    ceil(R / 72) of them; fewer resident means it runs in waves) and the
    dynamic shared memory per block. Needs a CUDA device."""
    lib = load_kernel(KERNEL_NAME)
    out = ctypes.c_int(0)
    err = lib.sgt_metropolis_sweep_clusters(n_pad, r, block_size, planes,
                                            ctypes.byref(out))
    if err != 0:
        msg = lib.sgt_cuda_error_string(err).decode()
        raise RuntimeError(f"cluster occupancy query failed: CUDA error "
                           f"{err} ({msg})")
    return {"max_active_clusters": out.value,
            "clusters_launched": -(-r // CLUSTER_TILE[0]),
            "smem_bytes_per_block": int(lib.sgt_metropolis_sweep_smem(
                n_pad, block_size))}


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
