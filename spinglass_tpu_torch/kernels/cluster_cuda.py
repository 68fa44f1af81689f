"""The Swendsen-Wang kernels C2 (bond activation) and C1 (labels and flip),
and their plain PyTorch versions.

Neither has a Pallas counterpart: the JAX package activates the bonds with
array code and labels the clusters with a ``lax.while_loop``
(``spinglass_tpu/core/cluster.py:240-300``). The port's PT super-step runs
the sweep inside a CUDA graph, which cannot branch on the host, so the
labels are found inside one launch; the sources say how, and why the labels
equal the JAX loop's.

* C2, ``csrc/sw_bonds.cu``: ``BondActivation(idx, val, h, active, rev_i,
  rev_k)`` (one ELL problem's operands) called with spins [R, Np] float32
  and beta [R] returns (masks [R, Np, W] int32: bit q % 32 of word q // 32
  is the bond of slot q, W = ceil(K / 32); init [R, Np] int32: -1 where the
  ghost bond is on, the site's index elsewhere, Np on padding). Given mode
  (``u_dir`` [R, Np, K], ``u_ghost`` [R, Np]) or Philox mode (``seed``: an
  int, or a seed slot the kernel reads at launch); ``bonds_reference`` is
  its plain version.
* C1, ``csrc/sw_labels.cu``: ``ClusterLabels().flip(idx, masks, init,
  spins, coins=... | seed=...)`` returns (new spins [R, Np], n_clusters
  [R] int32, labels [R, Np] int32, rounds [R] int32). Its plain versions:
  ``labels_reference`` (the JAX loop) on the unpacked masks and
  ``flip_reference``. ``ClusterLabels()(idx, bond, init)`` labels bool
  bonds [R, Np, K] alone, on the CPU only (the plain sweep's labelling).

The Philox mode's draws are ``metropolis_cuda.sw_philox_draws`` (the
counter layout is in ``csrc/philox.cuh``). For CPU tensors each wrapper runs
its plain version; for CUDA tensors it launches its kernel or raises, and
adds one to ``launches``. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from spinglass_tpu_torch.kernels import metropolis_cuda as mc

KERNEL_NAME = "sw_labels"      # C1
BONDS_KERNEL = "sw_bonds"      # C2
# C1's parent table (n + 1 nodes, csrc/sw_labels.cu): in one block's shared
# memory up to MAX_SHARED_NODES, in chunks of at most MAX_CHUNK_NODES over a
# cluster of at most MAX_CLUSTER blocks, else in device memory. The one
# definition of these limits: they are the most that fits the H100's 227 KiB
# of shared memory per block beside the kernel's union queues, and the
# runtime refuses a larger table when the launch asks for its memory.
MAX_SHARED_NODES, MAX_CHUNK_NODES, MAX_CLUSTER = 53000, 32768, 8
H100_SMS = 132


def labels_reference(idx: torch.Tensor, bond: torch.Tensor,
                     init: torch.Tensor):
    """The JAX labelling loop: min-label propagation over the bonds, then
    pointer jumping (the jump index clamped to Np - 1 as the JAX gather
    clamps it), until no label changes or Np rounds have run. Returns
    (labels [R, Np] int32, rounds: an int); one host read per round."""
    r, n = init.shape
    big = torch.tensor(n, dtype=torch.int32, device=init.device)
    rows = torch.arange(r, device=init.device)[:, None]
    idx = idx.long()
    lab, rounds = init.to(torch.int32), 0
    while rounds < n:
        nb = torch.where(bond, lab[:, idx], big)              # [R, Np, K]
        new = torch.minimum(lab, nb.min(dim=-1).values)
        jump = new[rows, new.clamp(0, n - 1).long()]
        new = torch.where(new >= 0, torch.minimum(new, jump), new)
        changed = bool(torch.any(new != lab))
        lab, rounds = new, rounds + 1
        if not changed:
            break
    return lab, rounds


def pack_bonds(bond: torch.Tensor) -> torch.Tensor:
    """bool bonds [R, Np, K] -> int32 masks [R, Np, ceil(K / 32)], slot q at
    bit q % 32 of word q // 32 (the words' bits as uint32)."""
    r, n, k = bond.shape
    w = -(-k // 32)
    b = torch.zeros(r, n, w * 32, dtype=torch.int64, device=bond.device)
    b[:, :, :k] = bond
    weights = torch.ones(32, dtype=torch.int64, device=bond.device) << \
        torch.arange(32, device=bond.device)
    words = (b.reshape(r, n, w, 32) * weights).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_masks(masks: torch.Tensor, k: int) -> torch.Tensor:
    """int32 masks [R, Np, W] -> bool bonds [R, Np, K]."""
    q = torch.arange(k, device=masks.device)
    return ((masks[:, :, q // 32] >> (q % 32)) & 1).bool()


def bonds_reference(idx, val, h, active, rev_i, rev_k, spins, beta,
                    u_dir=None, u_ghost=None, seed=None):
    """C2's plain version: the bond and ghost activation of
    ``SwendsenWang._sweep`` (JAX) on the given draws, or on the Philox words
    of ``seed`` at each edge's lower end. Returns (masks, init)."""
    r, n = spins.shape
    dev = spins.device
    idx_l = idx.long()
    site = torch.arange(n, dtype=torch.int64, device=dev)
    lower = site[:, None] < idx_l                              # [Np, K]
    if seed is None:
        u_edge = torch.where(lower[None], u_dir,
                             u_dir[:, rev_i.long(), rev_k.long()])
    else:
        slot = torch.arange(idx.shape[1], dtype=torch.int64, device=dev)
        a = torch.where(lower, site[:, None], rev_i.long())
        b = torch.where(lower, slot[None, :], rev_k.long())
        u_edge = mc.word_uniforms(mc.sw_philox_words(seed, r, a, b,
                                                     mc.SW_TAG_BOND))
        u_ghost = mc.word_uniforms(mc.sw_philox_words(seed, r, site, 0,
                                                      mc.SW_TAG_GHOST))
    jss = val[None] * spins[:, :, None] * spins[:, idx_l]
    p_bond = -torch.expm1(-2.0 * beta[:, None, None]
                          * torch.clamp(jss, min=0.0))
    bond = (u_edge < p_bond) & (jss > 0)
    hs = h[None, :] * spins
    p_ghost = -torch.expm1(-2.0 * beta[:, None] * torch.clamp(hs, min=0.0))
    ghost = (u_ghost < p_ghost) & active[None, :]
    start = torch.where(active, site, n).to(torch.int32)
    init = torch.where(ghost, torch.full_like(start, -1)[None], start[None])
    return pack_bonds(bond), init


def flip_reference(spins, labels, init, coins=None, seed=None):
    """C1's flip, plain: every active site (start label < Np) of a cluster
    with label >= 0 flips by its root's coin (``coins`` [R, Np] bool, or
    the Philox coins of ``seed``). Returns (new spins, n_clusters [R]
    int32: the active sites that are their cluster's root)."""
    r, n = spins.shape
    site = torch.arange(n, device=spins.device)
    if coins is None:
        coins = (mc.sw_philox_words(seed, r, site, 0, mc.SW_TAG_COIN)
                 >> 31) == 1
    root_coin = torch.gather(coins, 1, labels.clamp(0, n - 1).long())
    active = init != n
    flip = (labels >= 0) & root_coin & active
    n_clusters = torch.sum((labels == site[None, :]) & active, dim=-1,
                           dtype=torch.int32)
    return torch.where(flip, -spins, spins), n_clusters


def labels_plan(n: int, r: int, sms: int = H100_SMS,
                blocks: Optional[int] = None):
    """Where C1 keeps its parent table: (mode, blocks per replica, log2 of a
    cluster block's node chunk); mode 0 one block's shared memory, 1 a
    cluster's, 2 device memory. ``blocks`` None picks, where the table fits
    one block, the blocks per replica doubled up to 8 while 2 x blocks x R
    <= ``sms`` (R=16: 8, 128 blocks on 132 SMs; R >= 67: 1), else the least
    cluster the table fits, else device memory; 1, 2-8 or 0 (device memory)
    asks for one."""
    nodes = n + 1
    if blocks is None:
        if nodes <= MAX_SHARED_NODES:
            blocks = 1
            while blocks < MAX_CLUSTER and 2 * blocks * r <= sms:
                blocks *= 2
        else:
            blocks = next((b for b in (2, 4, 8)
                           if b * MAX_CHUNK_NODES >= nodes), 0)
    if blocks == 0:
        return 2, 1, 0
    if blocks == 1:
        if nodes > MAX_SHARED_NODES:
            raise ValueError(f"{KERNEL_NAME}: {nodes} nodes exceed one "
                             f"block's {MAX_SHARED_NODES}")
        return 0, 1, 0
    if not 2 <= blocks <= MAX_CLUSTER:
        raise ValueError(f"{KERNEL_NAME}: a cluster holds 2-{MAX_CLUSTER} "
                         f"blocks, got {blocks}")
    shift = max(0, (-(-nodes // blocks) - 1).bit_length())
    if (1 << shift) > MAX_CHUNK_NODES:
        raise ValueError(f"{KERNEL_NAME}: {nodes} nodes exceed {blocks} "
                         f"blocks of {MAX_CHUNK_NODES}")
    return 1, blocks, shift


def _check(name: str, t: torch.Tensor, dtypes, shape, dev) -> None:
    if (t.dtype not in dtypes or tuple(t.shape) != tuple(shape)
            or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {dtypes[0]} "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _load(name: str) -> ctypes.CDLL:
    from spinglass_tpu_torch.kernels import build

    lib = build.load(name)
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    if name == BONDS_KERNEL:
        lib.sgt_sw_bonds.argtypes = [p] * 10 + [u64, p, p, p, i, i, i, p]
        lib.sgt_sw_bonds.restype = ctypes.c_int
    else:
        lib.sgt_sw_labels.argtypes = [p] * 5 + [u64] + [p] * 6 + [i] * 6 + [p]
        lib.sgt_sw_labels.restype = ctypes.c_int
    lib.sgt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sgt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> ctypes.CDLL:
    """Build (first use) and bind C1's library."""
    return _load(KERNEL_NAME)


def load_bonds_kernel() -> ctypes.CDLL:
    """Build (first use) and bind C2's library."""
    return _load(BONDS_KERNEL)


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.sgt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class BondActivation:
    """C2 on one ELL problem's operands, with its launch count (see the
    module docstring). idx [Np, K] int32, val [Np, K] float32, h [Np]
    float32, active [Np] bool, rev_i / rev_k [Np, K] int32 (the lower end's
    slot of each edge, ``core.cluster._ell_reverse_slots``)."""

    def __init__(self, idx, val, h, active, rev_i, rev_k):
        self.idx = idx.to(torch.int32).contiguous()
        self.val = val.to(torch.float32).contiguous()
        self.h = h.to(torch.float32).contiguous()
        self.active = active.to(torch.bool).contiguous()
        self.rev_i = rev_i.to(torch.int32).contiguous()
        self.rev_k = rev_k.to(torch.int32).contiguous()
        self.launches = 0
        self._lib = None

    def __call__(self, spins: torch.Tensor, beta: torch.Tensor,
                 u_dir: Optional[torch.Tensor] = None,
                 u_ghost: Optional[torch.Tensor] = None, seed=None):
        """(masks, init) of one sweep: given mode (u_dir, u_ghost) or
        Philox mode (seed)."""
        if (seed is None) == (u_dir is None) or \
                (u_dir is None) != (u_ghost is None):
            raise ValueError(f"{BONDS_KERNEL}: give u_dir and u_ghost, or a "
                             f"seed")
        if not spins.is_cuda:
            return bonds_reference(self.idx, self.val, self.h, self.active,
                                   self.rev_i, self.rev_k, spins, beta,
                                   u_dir, u_ghost, seed)
        r, n = spins.shape
        k = self.idx.shape[1]
        dev = spins.device
        _check(f"{BONDS_KERNEL}: idx", self.idx, (torch.int32,), (n, k), dev)
        _check(f"{BONDS_KERNEL}: spins", spins, (torch.float32,), (r, n), dev)
        _check(f"{BONDS_KERNEL}: beta", beta, (torch.float32,), (r,), dev)
        if u_dir is not None:
            _check(f"{BONDS_KERNEL}: u_dir", u_dir, (torch.float32,),
                   (r, n, k), dev)
            _check(f"{BONDS_KERNEL}: u_ghost", u_ghost, (torch.float32,),
                   (r, n), dev)
            value, address = 0, None
        else:
            value, address = mc.seed_arg(seed, dev)
        if self._lib is None:
            self._lib = load_bonds_kernel()
        masks = torch.empty(r, n, -(-k // 32), dtype=torch.int32, device=dev)
        init = torch.empty(r, n, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._lib.sgt_sw_bonds(
                self.idx.data_ptr(), self.val.data_ptr(), self.h.data_ptr(),
                self.active.data_ptr(), self.rev_i.data_ptr(),
                self.rev_k.data_ptr(), spins.data_ptr(), beta.data_ptr(),
                _ptr(u_dir), _ptr(u_ghost), value, address, masks.data_ptr(),
                init.data_ptr(), n, k, r, stream)
        _raise_on(self._lib, err, BONDS_KERNEL)
        self.launches += 1
        return masks, init


class ClusterLabels:
    """C1 with its launch count (see the module docstring). ``blocks``
    fixes where the parent table lives (``labels_plan``); None lets the
    shapes pick."""

    def __init__(self, blocks: Optional[int] = None):
        self.launches = 0
        self.blocks = blocks
        self._lib = None

    def __call__(self, idx: torch.Tensor, bond: torch.Tensor,
                 init: torch.Tensor):
        """Labels alone from bool bonds [R, Np, K]: (labels, rounds), by
        the plain loop; CPU tensors only (on the card, ``flip``)."""
        if init.is_cuda:
            raise ValueError(f"{KERNEL_NAME}: labels alone run on the CPU; "
                             f"on the card call flip")
        lab, rounds = labels_reference(idx, bond, init)
        return lab, torch.full((init.shape[0],), rounds, dtype=torch.int32)

    def flip(self, idx: torch.Tensor, masks: torch.Tensor, init: torch.Tensor,
             spins: torch.Tensor, coins: Optional[torch.Tensor] = None,
             seed=None):
        """Labels and the flip: (new spins, n_clusters, labels, rounds)."""
        if (seed is None) == (coins is None):
            raise ValueError(f"{KERNEL_NAME}: give coins or a seed")
        if not spins.is_cuda:
            r = spins.shape[0]
            labels, rounds = labels_reference(
                idx, unpack_masks(masks, idx.shape[1]), init)
            new, n_clusters = flip_reference(spins, labels, init, coins, seed)
            return (new, n_clusters, labels,
                    torch.full((r,), rounds, dtype=torch.int32))
        return self._launch(idx, masks, init, spins, coins, seed)

    def _launch(self, idx, masks, init, spins, coins, seed):
        r, n = init.shape
        k = idx.shape[1]
        dev = init.device
        _check(f"{KERNEL_NAME}: idx", idx, (torch.int32,), (n, k), dev)
        _check(f"{KERNEL_NAME}: masks", masks, (torch.int32,),
               (r, n, -(-k // 32)), dev)
        _check(f"{KERNEL_NAME}: init", init, (torch.int32,), (r, n), dev)
        _check(f"{KERNEL_NAME}: spins", spins, (torch.float32,), (r, n), dev)
        out = torch.empty_like(spins)
        value, address = 0, None
        if coins is not None:
            _check(f"{KERNEL_NAME}: coins", coins, (torch.bool, torch.uint8),
                   (r, n), dev)
        else:
            value, address = mc.seed_arg(seed, dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        mode, blocks, shift = labels_plan(n, r, sms, self.blocks)
        scratch = (torch.empty(r, n + 1, dtype=torch.int32, device=dev)
                   if mode == 2 else None)
        if self._lib is None:
            self._lib = load_kernel()
        labels = torch.empty(r, n, dtype=torch.int32, device=dev)
        n_clusters = torch.empty(r, dtype=torch.int32, device=dev)
        rounds = torch.empty(r, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._lib.sgt_sw_labels(
                idx.data_ptr(), masks.data_ptr(), init.data_ptr(),
                spins.data_ptr(), _ptr(coins), value, address, out.data_ptr(),
                labels.data_ptr(), n_clusters.data_ptr(), rounds.data_ptr(),
                _ptr(scratch), n, k, r, mode, blocks, shift, stream)
        _raise_on(self._lib, err, KERNEL_NAME)
        self.launches += 1
        return out, n_clusters, labels, rounds
