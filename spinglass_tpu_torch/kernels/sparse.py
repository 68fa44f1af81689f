"""Sparse (ELL / padded-neighbour-list) problems and sweep engines.

The counterpart of the non-Pallas half of ``spinglass_tpu.kernels.sparse``.
For 10k+ spins with sparse J a dense [N, N] product wastes O(N^2) traffic on
zeros. The ELL layout stores, per spin, a fixed K = max-degree list of
(neighbour index, coupling), padded with self-loops of value 0, and local
fields become a gather and a K-reduction

    f[r, i] = sum_k val[i, k] * s[r, idx[i, k]] + h[i].

Sweeps are coloured: a greedy colouring of a sparse graph needs at most
max_degree + 1 colours, and each colour updates at once, exactly.

Two engines (``anneal.engines.make_engine`` picks):

* ``SortedSparseTEngine`` (layout "nr", spins [NS, R] in a colour-sorted
  order): on a CUDA device it runs the whole sweep in the K2 kernel when the
  replica count is a multiple of 128 and [NS, R] float32 fits
  ``SINGLE_VMEM_SPIN_BYTES`` (the JAX package's rule, kept: it is where K2
  measured fastest), and every other shape through
  ``make_sorted_t_sweep_fused``: the fused per-colour kernel K4, which
  gathers its own fields (the fastest of three ways measured at R=4096).
  ``accept_kernel="fused"`` asks for K4, ``"none"`` for the threshold path:
  thresholds from the K3 kernel and the per-colour sweep
  ``make_sorted_t_sweep`` in plain PyTorch, which is also what runs on the
  CPU. Kernels and twins are in ``kernels/sparse_cuda.py``.
* ``SortedSparseEngine`` (layout "rn", spins [R, Np]): the per-colour sweep
  in plain PyTorch, for narrow replica counts and CPU problems. It has no
  kernel in the JAX package either.

The host-side layout functions (``build_ell``, ``build_sorted_buckets``,
``build_sorted_t``, ``build_single_tables``) are numpy, and give the JAX
package's arrays entry for entry; the engines move their output to the
problem's device.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from spinglass_tpu_torch.core import topology
from spinglass_tpu_torch.core.problem import (IsingProblem, resolve_device,
                                              round_up)
from spinglass_tpu_torch.kernels.sparse_cuda import SparseKernels
from spinglass_tpu_torch.core.rng import device_uniforms, draw_seed
from spinglass_tpu_torch.kernels.sweeps import accept_threshold, canonical_rule

KS_BLOCK = 256  # the TPU kernel streamed its per-step degree table in
# blocks of this many steps; build_single_tables pads ks to it, as JAX does


def build_ell(rows, cols, vals, n_pad: int, k: int):
    """Symmetric COO (both directions) -> (idx [Np, K] int32, val [Np, K]
    float32, max_degree). Each row keeps its entries in COO order, as the
    JAX package's native C++ routine does; empty slots point at the row
    itself with value 0."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    idx = np.tile(np.arange(n_pad, dtype=np.int32)[:, None], (1, k))
    val = np.zeros((n_pad, k), np.float32)
    ok = (rows >= 0) & (rows < n_pad)
    rows, cols, vals = rows[ok], cols[ok], vals[ok]
    order = np.argsort(rows, kind="stable")
    r_s = rows[order]
    counts = np.bincount(r_s, minlength=n_pad)
    pos = np.arange(len(r_s)) - (np.cumsum(counts) - counts)[r_s]
    keep = pos < k
    idx[r_s[keep], pos[keep]] = cols[order][keep].astype(np.int32)
    val[r_s[keep], pos[keep]] = vals[order][keep].astype(np.float32)
    return idx, val, int(counts.max(initial=0))


@dataclass(frozen=True)
class EllProblem:
    """ELL-format sparse Ising problem on one device.

    idx [Np, K] int32 neighbour indices (self-index on padding slots),
    val [Np, K] float32 couplings (0 on padding), h [Np], active_mask [Np]."""

    idx: torch.Tensor
    val: torch.Tensor
    h: torch.Tensor
    active_mask: torch.Tensor
    n_spins: int

    @property
    def n_padded(self) -> int:
        return self.idx.shape[0]

    @property
    def max_degree(self) -> int:
        return self.idx.shape[1]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @staticmethod
    def from_coo(n_spins: int, rows, cols, vals, h=None,
                 max_degree: Optional[int] = None, device=None) -> "EllProblem":
        """Dense-free constructor from symmetric COO (both directions
        present): the path for 10k+ sparse instances. ``device`` None is
        the card (``core.problem.resolve_device``)."""
        device = resolve_device(device)
        n_pad = round_up(n_spins)
        rows = np.asarray(rows, np.int64)
        degs = np.bincount(rows, minlength=n_pad)
        k = int(max_degree or max(int(degs.max()), 1))
        idx, val, _ = build_ell(rows, cols, vals, n_pad, k)
        h_full = np.zeros(n_pad, np.float32)
        if h is not None:
            h_full[:n_spins] = np.asarray(h, np.float32)
        mask = np.zeros(n_pad, np.float32)
        mask[:n_spins] = 1.0
        return EllProblem(idx=torch.as_tensor(idx, device=device),
                          val=torch.as_tensor(val, device=device),
                          h=torch.as_tensor(h_full, device=device),
                          active_mask=torch.as_tensor(mask, device=device),
                          n_spins=n_spins)

    @staticmethod
    def from_problem(problem: IsingProblem,
                     max_degree: Optional[int] = None) -> "EllProblem":
        """Convert a dense IsingProblem (host side, once per problem); the
        result lives on the problem's device."""
        n = problem.n_spins
        j = problem.j[:n, :n].cpu().numpy()
        degs = (j != 0).sum(axis=1)
        k = int(max_degree or max(int(degs.max()), 1))
        rows, cols = np.nonzero(j)
        idx, val, _ = build_ell(rows, cols, j[rows, cols], problem.n_padded, k)
        dev = problem.device
        return EllProblem(idx=torch.as_tensor(idx, device=dev),
                          val=torch.as_tensor(val, device=dev),
                          h=problem.h, active_mask=problem.active_mask,
                          n_spins=n)


def ell_from_terms(n_spins: int, terms, max_degree: Optional[int] = None,
                   device=None) -> EllProblem:
    """Compile a terms object (``quad_i``, ``quad_j``, ``quad_v``, ``lin_i``,
    ``lin_v`` arrays) straight into an EllProblem: the dense-free encode
    path. Duplicate (i, j) terms stay separate ELL slots; the gather-reduce
    sums them, so fields and energies match the dense scatter-add."""
    qi = np.asarray(terms.quad_i, np.int64)
    qj = np.asarray(terms.quad_j, np.int64)
    qv = np.asarray(terms.quad_v, np.float64)
    rows = np.concatenate([qi, qj])
    cols = np.concatenate([qj, qi])
    vals = np.concatenate([qv, qv])
    h = np.zeros(n_spins, np.float64)
    if len(terms.lin_i):
        np.add.at(h, np.asarray(terms.lin_i, np.int64),
                  np.asarray(terms.lin_v, np.float64))
    return EllProblem.from_coo(n_spins, rows, cols, vals, h,
                               max_degree=max_degree, device=device)


def sparse_local_fields(ell: EllProblem, spins: torch.Tensor) -> torch.Tensor:
    """[R, Np] -> [R, Np]: gather neighbours, multiply, reduce K."""
    gathered = spins[:, ell.idx.long()].to(torch.float32)     # [R, Np, K]
    return torch.sum(gathered * ell.val, dim=-1) + ell.h


def sparse_energy(ell: EllProblem, spins: torch.Tensor) -> torch.Tensor:
    """E = -1/2 s.f_J - h.s  (f_J excludes h)."""
    f_j = sparse_local_fields(ell, spins) - ell.h
    s32 = spins.to(torch.float32)
    return -0.5 * torch.sum(s32 * f_j, dim=-1) - torch.sum(s32 * ell.h, dim=-1)


def _coloring(ell: EllProblem, max_colors: int) -> np.ndarray:
    """Balanced greedy colouring of an EllProblem's coupling graph."""
    idx = ell.idx.cpu().numpy()
    val = ell.val.cpu().numpy()
    rows_l, cols_l = np.nonzero(val)
    return topology.greedy_coloring_coo(
        rows_l.astype(np.int64), idx[rows_l, cols_l].astype(np.int64),
        ell.n_spins, max_colors=max_colors, balanced=True)


def _ell_and_colors(problem, max_colors: int):
    if isinstance(problem, EllProblem):
        return problem, _coloring(problem, max_colors)
    ell = EllProblem.from_problem(problem)
    n = problem.n_spins
    j_np = problem.j[:n, :n].cpu().numpy()
    rows, cols = (a.astype(np.int64) for a in np.nonzero(j_np))
    return ell, topology.greedy_coloring_coo(rows, cols, n,
                                             max_colors=max_colors,
                                             balanced=True)


def _split_by_degree(cl, degs, n_buckets: int):
    """A colour class sorted by descending degree, split at degree quantiles
    into at most ``n_buckets`` pieces; neighbours with the same max degree
    merged."""
    cl = cl[np.argsort(-degs[cl], kind="stable")]
    splits = [s for s in np.array_split(cl, min(n_buckets, len(cl))) if len(s)]
    merged = [splits[0]]
    for s in splits[1:]:
        if degs[s].max(initial=0) == degs[merged[-1]].max(initial=0):
            merged[-1] = np.concatenate([merged[-1], s])
        else:
            merged.append(s)
    return merged


def _compact_rows(idx_np, val_np, nodes, k: int):
    """The nodes' ELL rows with their non-zeros moved to the front (stable)
    and cut at k slots: (idx [m, k], val [m, k])."""
    rows_val = val_np[nodes]
    rows_idx = idx_np[nodes]
    colorder = np.argsort(rows_val == 0, axis=1, kind="stable")
    v_c = np.take_along_axis(rows_val, colorder, axis=1)[:, :k]
    i_c = np.take_along_axis(rows_idx, colorder, axis=1)[:, :k]
    return i_c, v_c


# ---------------------------------------------------------------------------
# Sorted sliced-ELL sweep, [R, N] layout
# ---------------------------------------------------------------------------

class SortedBucket:
    """One degree bucket of one colour class in the colour-sorted layout:
    positions [off, off+m), neighbour lists padded to this bucket's own max
    degree k. ``idx`` [m, k] sorted positions, ``val`` [m, k], ``h`` [m]."""

    def __init__(self, off: int, idx, val, h):
        self.off = int(off)
        self.m = int(idx.shape[0])
        self.k = int(idx.shape[1])
        self.idx, self.val, self.h = idx, val, h


def build_sorted_buckets(ell: EllProblem, colors: np.ndarray,
                         n_buckets: int = 4):
    """Host-side layout of the [R, N] sorted sweep.

    Returns (perm [Np], inv_perm [Np], buckets, color_groups): ``perm`` maps
    sorted position -> original index; each colour class is sorted by
    descending degree and split at degree quantiles; ``color_groups`` lists
    (offset, size, [bucket, ...]) per colour. Bucket arrays are numpy."""
    colors = np.asarray(colors)
    idx_np = ell.idx.cpu().numpy()
    val_np = ell.val.cpu().numpy()
    h_np = ell.h.cpu().numpy().astype(np.float32)
    n_pad = ell.n_padded
    degs = (val_np != 0).sum(axis=1)

    order, spans = [], []
    c_count = int(colors.max()) + 1 if colors.size else 1
    pos = 0
    for c in range(c_count):
        cl = np.nonzero(colors == c)[0]
        if len(cl) == 0:
            continue
        for nodes in _split_by_degree(cl, degs, n_buckets):
            order.append(nodes)
            spans.append((pos, nodes, c))
            pos += len(nodes)
    covered = np.concatenate(order) if order else np.zeros(0, np.int64)
    rest = np.setdiff1d(np.arange(n_pad), covered)
    perm = np.concatenate([covered, rest]).astype(np.int64)
    inv_perm = np.empty(n_pad, np.int64)
    inv_perm[perm] = np.arange(n_pad)

    buckets, bucket_colors = [], []
    for start, nodes, c in spans:
        k_b = max(int(degs[nodes].max(initial=1)), 1)
        idx_c, val_b = _compact_rows(idx_np, val_np, nodes, k_b)
        idx_b = np.where(val_b != 0, inv_perm[idx_c],
                         inv_perm[nodes][:, None]).astype(np.int64)
        buckets.append(SortedBucket(start, idx_b,
                                    np.ascontiguousarray(val_b, np.float32),
                                    h_np[nodes]))
        bucket_colors.append(c)

    color_groups = []
    prev_c = None
    for b, c in zip(buckets, bucket_colors):
        if color_groups and c == prev_c:
            off, size, bs = color_groups[-1]
            color_groups[-1] = (off, size + b.m, bs + [b])
        else:
            color_groups.append((b.off, b.m, [b]))
        prev_c = c
    return perm, inv_perm, buckets, color_groups


def _groups_on(groups, device):
    """The same colour groups with each bucket's arrays as tensors on
    ``device`` (idx int64 for indexing)."""
    out = []
    for off, size, bs in groups:
        out.append((off, size, [type(b)(b.off,
                                        torch.as_tensor(np.asarray(b.idx, np.int64),
                                                        device=device),
                                        torch.as_tensor(np.asarray(b.val, np.float32),
                                                        device=device),
                                        torch.as_tensor(np.asarray(b.h, np.float32),
                                                        device=device))
                                for b in bs]))
    return out


def make_sorted_sweep(color_groups, rule: str = "metropolis"):
    """The [R, Np] sorted sliced-ELL sweep over device colour groups.

    spins [R, Np] in the SORTED layout; the spin at sorted position p
    consumes uniforms[:, p]. Per colour, the degree buckets all gather from
    the same spin state (one independent set) and the colour's flips apply
    as one contiguous slice update. Returns new spins (the input is not
    modified), dE[R] and n_accepted[R]."""

    def sweep(spins, beta, uniforms):
        r = spins.shape[0]
        beta = torch.broadcast_to(torch.as_tensor(beta, dtype=torch.float32,
                                                  device=spins.device), (r,))
        th = accept_threshold(uniforms, beta[:, None], rule)
        spins = spins.clone()
        de_acc = torch.zeros(r, dtype=torch.float32, device=spins.device)
        cnt = torch.zeros(r, dtype=torch.int32, device=spins.device)
        for off, mc, bs in color_groups:
            fs = [torch.sum(spins[:, b.idx] * b.val, dim=-1) + b.h for b in bs]
            f = torch.cat(fs, dim=1) if len(fs) > 1 else fs[0]
            s_c = spins[:, off:off + mc]
            sf = s_c * f
            acc = sf < th[:, off:off + mc]
            spins[:, off:off + mc] = torch.where(acc, -s_c, s_c)
            de_acc = de_acc + 2.0 * torch.sum(torch.where(acc, sf, 0.0), dim=-1)
            cnt = cnt + torch.sum(acc, dim=-1, dtype=torch.int32)
        return spins, de_acc, cnt

    return sweep


# ---------------------------------------------------------------------------
# Transposed aligned sorted sliced-ELL, [NS, R] layout
# ---------------------------------------------------------------------------

class TBucket(SortedBucket):
    """One degree bucket of one colour class in the transposed [NS, R]
    sorted layout: rows [off, off+m), m padded to the row alignment (inert
    rows: val 0, h 0, masked thresholds)."""


def build_sorted_t(ell: EllProblem, colors: np.ndarray, n_buckets: int = 12,
                   row_align: int = 8, color_align: int = 32,
                   total_align: int = 256, bucket_order: str = "degree"):
    """Host-side layout of the transposed sorted sweep (numpy in, numpy out).

    Every bucket is padded to ``row_align`` rows and every colour span to
    ``color_align`` rows; ``n_sorted`` is a multiple of ``total_align``.
    ``bucket_order`` is the row order inside each degree bucket: "degree"
    (descending) or "index" (ascending original index).

    Returns (perm [NS] original index per sorted row (-1 padding), inv_map
    [n_padded] sorted position per original row, groups [(off, size,
    [TBucket...])], mask_col [NS, 1] (0 real / -inf padding), n_sorted)."""
    colors = np.asarray(colors)
    idx_np = ell.idx.cpu().numpy()
    val_np = ell.val.cpu().numpy()
    h_np = ell.h.cpu().numpy().astype(np.float32)
    degs = (val_np != 0).sum(axis=1)
    c_count = int(colors.max()) + 1 if colors.size else 1

    def aup(x, a):
        return -(-x // a) * a

    pos = 0
    plan = []  # (span_start, [(bucket_off, nodes, m_pad, k)])
    for c in range(c_count):
        cl = np.nonzero(colors == c)[0]
        if len(cl) == 0:
            continue
        merged = _split_by_degree(cl, degs, n_buckets)
        if bucket_order == "index":
            merged = [np.sort(nodes_b) for nodes_b in merged]
        elif bucket_order != "degree":
            raise ValueError(f"bucket_order must be 'degree' or 'index', "
                             f"got {bucket_order!r}")
        span_start = pos
        buckets = []
        for bi, nodes in enumerate(merged):
            m_pad = aup(len(nodes), row_align)
            if bi == len(merged) - 1:  # colour span up to color_align
                m_pad = (aup(pos - span_start + m_pad, color_align)
                         - (pos - span_start))
            buckets.append((pos, nodes, m_pad,
                            max(int(degs[nodes].max(initial=1)), 1)))
            pos += m_pad
        plan.append((span_start, buckets))
    n_sorted = aup(max(pos, total_align), total_align)

    perm = np.full(n_sorted, -1, np.int64)
    for _, buckets in plan:
        for start, nodes, m_pad, k in buckets:
            perm[start:start + len(nodes)] = nodes
    inv_map = np.zeros(ell.n_padded, np.int64)
    real = perm >= 0
    inv_map[perm[real]] = np.nonzero(real)[0]

    groups = []
    for span_start, buckets in plan:
        bl = []
        span_size = 0
        for start, nodes, m_pad, k in buckets:
            bidx = np.zeros((m_pad, k), np.int32)
            bval = np.zeros((m_pad, k), np.float32)
            bh = np.zeros(m_pad, np.float32)
            m = len(nodes)
            i_c, v_c = _compact_rows(idx_np, val_np, nodes, k)
            bidx[:m] = np.where(v_c != 0, inv_map[i_c], 0)
            bval[:m] = v_c
            bh[:m] = h_np[nodes]
            bl.append(TBucket(start, bidx, bval, bh))
            span_size += m_pad
        groups.append((span_start, span_size, bl))
    mask = np.where(real, 0.0, -np.inf).astype(np.float32)
    return perm, inv_map, groups, mask[:, None], n_sorted


def build_single_tables(groups, n_sorted: int, rps: int = 32):
    """Flatten build_sorted_t's per-colour bucket lists into whole-layout
    row tables (numpy):

      idx_all [NS, KMAX] int32 - neighbour SORTED rows, non-zeros first
      val_all [NS, KMAX] f32   - couplings (0 padding)
      ks      [steps, 1] int32 - the TPU kernel's per-step slot bound (max
                                 degree over each ``rps`` rows, padded to
                                 KS_BLOCK steps), kept for parity with JAX
      h_all   [NS, 1]   f32    - external fields (0 on inert rows)
      kmax
      deg     [NS]      int32  - each row's true degree: K2 loops to it
    """
    kmax = max((b.k for _, _, bs in groups for b in bs), default=1)
    idx_all = np.zeros((n_sorted, kmax), np.int32)
    val_all = np.zeros((n_sorted, kmax), np.float32)
    krow = np.zeros(n_sorted, np.int32)
    h_all = np.zeros((n_sorted, 1), np.float32)
    for _, _, bs in groups:
        for b in bs:
            i0 = b.off
            v = np.asarray(b.val)
            idx_all[i0:i0 + b.m, :b.k] = np.asarray(b.idx)
            val_all[i0:i0 + b.m, :b.k] = v
            krow[i0:i0 + b.m] = (v != 0).sum(axis=1)
            h_all[i0:i0 + b.m, 0] = np.asarray(b.h)
    ks = krow.reshape(n_sorted // rps, rps).max(axis=1)
    n_steps_pad = -(-len(ks) // KS_BLOCK) * KS_BLOCK
    ks = np.pad(ks, (0, n_steps_pad - len(ks)))[:, None]
    return idx_all, val_all, ks.astype(np.int32), h_all, kmax, krow


def _colour_fields(s_t, bs) -> torch.Tensor:
    """Fields [mc, R] float32 of one colour's buckets, all gathered from the
    same spin state (one independent set)."""
    fs = [torch.sum(s_t[b.idx].to(torch.float32) * b.val[:, :, None], dim=1)
          + b.h[:, None] for b in bs]
    return torch.cat(fs, dim=0) if len(fs) > 1 else fs[0]


def accept_colour(s_t, off: int, f, th, de, cnt) -> None:
    """One colour's accept on its fields f [mc, R] and thresholds th
    [mc, R]: rows off .. off+mc-1 of s_t flip in place where s * f < th,
    and dE (2 * sum of s * f over the flips) and the count are added into
    de [R] and cnt [R] in place."""
    mc = f.shape[0]
    s_c = s_t[off:off + mc]
    sf = s_c.to(torch.float32) * f
    acc = sf < th
    s_t[off:off + mc] = torch.where(acc, -s_c, s_c)
    de.add_(2.0 * torch.sum(torch.where(acc, sf, 0.0), dim=0))
    cnt.add_(torch.sum(acc, dim=0, dtype=torch.int32))


def make_sorted_t_sweep(groups):
    """The per-colour transposed sorted sweep over device colour groups:
    spins [NS, R] (int8 or float32), thresholds th [NS, R] float32
    (pre-masked). Per colour the degree buckets all gather from the same
    spin state and the colour's flips apply as one contiguous slice update,
    in place. K2's twin, and the threshold path's sweep. Returns (spins,
    dE[R] float32, n_accepted[R] int32)."""

    def sweep(s_t, th_t):
        r = s_t.shape[1]
        de = torch.zeros(r, dtype=torch.float32, device=s_t.device)
        cnt = torch.zeros(r, dtype=torch.int32, device=s_t.device)
        for off, mc, bs in groups:
            accept_colour(s_t, off, _colour_fields(s_t, bs),
                          th_t[off:off + mc], de, cnt)
        return s_t, de, cnt

    return sweep


def make_sorted_t_sweep_fused(kernels: SparseKernels):
    """The transposed sorted sweep through the fused per-colour kernel K4 in
    its gather mode (``kernels.accept_sweep``): one launch per colour
    computes the colour's fields from the spin state (slots in order, as
    K2), draws its Philox thresholds for the sweep seed, compares, flips in
    place and adds dE / counts; no field or threshold array exists outside
    the kernel. On the CPU it runs the plain version (``ordered_fields`` then
    ``accept_colour``). Under one seed it makes the decisions of
    ``make_sorted_t_sweep`` on K3's thresholds, and of K2. Needs the
    layout's slot tables. sweep(s_t, beta, seed) -> (s_t, dE[R], count[R])."""

    def sweep(s_t, beta, seed):
        beta = torch.broadcast_to(
            torch.as_tensor(beta, dtype=torch.float32, device=s_t.device),
            (s_t.shape[1],)).contiguous()
        return kernels.accept_sweep(s_t, beta, seed)

    return sweep


def _csr(groups, n_sorted: int, device) -> torch.Tensor:
    """The sorted-layout coupling matrix as a CSR tensor (energy only)."""
    rows, cols, vals = [], [], []
    for _, _, bs in groups:
        for b in bs:
            r_l, k_l = np.nonzero(np.asarray(b.val))
            rows.append(b.off + r_l)
            cols.append(np.asarray(b.idx)[r_l, k_l])
            vals.append(np.asarray(b.val)[r_l, k_l])
    rows, cols, vals = (np.concatenate(a) if a else np.zeros(0)
                        for a in (rows, cols, vals))
    order = np.lexsort((cols, rows))
    crow = np.zeros(n_sorted + 1, np.int64)
    np.add.at(crow, rows.astype(np.int64) + 1, 1)
    with warnings.catch_warnings():  # CSR support is marked beta in torch
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(np.cumsum(crow), device=device),
            torch.as_tensor(cols[order].astype(np.int64), device=device),
            torch.as_tensor(vals[order].astype(np.float32), device=device),
            size=(n_sorted, n_sorted), check_invariants=False)


class SortedSparseTEngine:
    """Transposed ([NS, R]) aligned sorted sliced-ELL engine, layout "nr"
    (the ``anneal.engines`` contract). Counterpart of the JAX engine, with
    "the spins lie on a CUDA device" where the JAX package tests for a TPU:

    * ``accept_kernel`` "auto" or "single" (K2 always; on the CPU its twin):
      the single path needs R % 128 == 0 and [NS, R] float32 within
      ``SINGLE_VMEM_SPIN_BYTES``. "auto" on a CUDA device takes K2 there and
      the fused sweep (K4, any R) everywhere else; on the CPU it takes the
      threshold path. "fused" runs ``make_sorted_t_sweep_fused`` (K4 per
      colour on a CUDA device, its plain version on the CPU, where the JAX
      package refuses it for want of its TPU generator); it needs
      R % 128 == 0, as in the JAX package. "none" keeps the threshold path.
    * ``threshold_rng`` "auto" (K3 on a CUDA device when R % 128 == 0),
      "kernel" (K3 always; on the CPU its twin) or "host" (uniforms from the
      generator on the spins' device).
    * ``to_layout`` gives float32 spins at the replica counts K2 takes (it
      keeps them as float32 in memory) and the narrow dtype (int8 by
      default) at every other: ``state_dtype(r)`` says which at ``r``
      replicas. ``spin_dtype`` reads float32 once the single-sweep tables
      are built, as in the JAX package.
    * ``single_rows_per_step`` (8, 16 or 32) is the TPU kernel's row step.
      It is checked as the JAX constructor checks it and changes nothing
      here: K2 has no row step.

    * ``bucket_order`` is ``build_sorted_t``'s row order inside a bucket.

    K2 and K4 update the spins in place; so do their twins. Launches of K2,
    K3 and K4 are counted in ``kernels`` (``launches`` reads them)."""

    layout = "nr"
    name = "sparse_sorted_t"
    # the TPU kernel kept [NS, R] f32 resident in VMEM up to this many bytes.
    # The limit stays on the card, by measurement: beyond it K4 is faster.
    # PT at [10240, 4096] on the H100 (700 W), ms/sweep in turns: K2 with the
    # limit lifted 0.78 (K2 alone 450 us), the fused sweep 0.58 (K4 280 us
    # on int8 spins), the threshold path 5.1-9.1
    SINGLE_VMEM_SPIN_BYTES = 80 * 1024 * 1024

    def __init__(self, problem, rule: str = "metropolis",
                 max_colors: int = 256, n_buckets: int = 12,
                 spin_dtype: torch.dtype = torch.int8,
                 threshold_rng: str = "auto", accept_kernel: str = "auto",
                 bucket_order: str = "degree",
                 single_rows_per_step: int = 32):
        if accept_kernel not in ("auto", "single", "fused", "none"):
            raise ValueError(f"accept_kernel must be auto|single|none|fused, "
                             f"got {accept_kernel!r}")
        if threshold_rng not in ("auto", "kernel", "host"):
            raise ValueError(f"threshold_rng must be auto|kernel|host, "
                             f"got {threshold_rng!r}")
        if single_rows_per_step not in (8, 16, 32):
            raise ValueError("single_rows_per_step must be 8, 16 or 32")
        del single_rows_per_step
        self.problem = problem
        self.rule = canonical_rule(rule)
        self.spin_dtype = spin_dtype
        self._narrow_dtype = spin_dtype  # where K2 is not taken
        ell, colors = _ell_and_colors(problem, max_colors)
        self.ell = ell
        dev = ell.device
        on_cuda = dev.type == "cuda"
        self.n_colors = int(colors.max()) + 1 if colors.size else 1
        (self.perm, self.inv_map, groups_np, mask_np,
         self.n_sorted) = build_sorted_t(ell, colors, n_buckets=n_buckets,
                                         bucket_order=bucket_order)
        self.groups = _groups_on(groups_np, dev)
        self.mask_col = torch.as_tensor(mask_np, device=dev)
        self._perm_gather = torch.as_tensor(np.where(self.perm >= 0, self.perm, 0),
                                            device=dev)
        self._inv_map = torch.as_tensor(self.inv_map, device=dev)
        self._h_sorted = torch.zeros(self.n_sorted, 1, device=dev)
        for off, _, bs in self.groups:
            for b in bs:
                self._h_sorted[b.off:b.off + b.m, 0] = b.h
        self._coupling = _csr(groups_np, self.n_sorted, dev)
        self._accept_kernel = accept_kernel
        self._use_kernel_rng = (threshold_rng == "kernel"
                                or (threshold_rng == "auto" and on_cuda))
        self._use_single = (accept_kernel == "single"
                            or (accept_kernel == "auto" and on_cuda))
        # instances whose [NS, 128] f32 spins exceed the budget can never
        # take the single path in auto mode
        if (accept_kernel == "auto" and self._use_single
                and self.n_sorted * 128 * 4 > self.SINGLE_VMEM_SPIN_BYTES):
            self._use_single = False
        tables = None
        if self._use_single:
            self.spin_dtype = torch.float32
        # on a CUDA device "auto" runs K4 wherever K2 is not taken
        self._use_fused = (accept_kernel == "fused"
                           or (accept_kernel == "auto" and on_cuda))
        if self._use_single or self._use_fused:
            idx_all, val_all, _, h_all, _, deg = build_single_tables(
                groups_np, self.n_sorted)
            tables = {"idx": torch.as_tensor(idx_all, device=dev),
                      "val": torch.as_tensor(val_all, device=dev),
                      "deg": torch.as_tensor(deg, device=dev),
                      "h": torch.as_tensor(h_all[:, 0], device=dev)}
        self.kernels = SparseKernels(self.mask_col, self.rule, self.groups,
                                     tables)
        self._sweep = make_sorted_t_sweep(self.groups)
        self._sweep_fused = (make_sorted_t_sweep_fused(self.kernels)
                             if tables is not None else None)

    @property
    def launches(self) -> dict:
        """K2, K3 and K4 launches made through this engine."""
        return {"sparse_sweep": self.kernels.sweep_launches,
                "sparse_thresholds": self.kernels.threshold_launches,
                "sparse_accept": self.kernels.accept_launches}

    def _single_fits(self, r: int) -> bool:
        return self.n_sorted * r * 4 <= self.SINGLE_VMEM_SPIN_BYTES

    def _takes_single(self, r: int) -> bool:
        return self._use_single and r % 128 == 0 and self._single_fits(r)

    # -- layout ------------------------------------------------------------
    def state_dtype(self, r: int) -> torch.dtype:
        """The dtype of the [NS, r] state ``to_layout`` gives at ``r``
        replicas: float32 where K2 takes the sweep, else the narrow dtype."""
        return torch.float32 if self._takes_single(r) else self._narrow_dtype

    def to_layout(self, spins_rn: torch.Tensor) -> torch.Tensor:
        """[R, Np] -> [NS, R] sorted rows, as a new contiguous tensor."""
        s_t = spins_rn[:, self._perm_gather].t()
        return s_t.to(self.state_dtype(spins_rn.shape[0])).contiguous()

    def from_layout(self, spins_t: torch.Tensor) -> torch.Tensor:
        """[NS, R] -> [R, Np] float32; padding spins restored to +1."""
        s_rn = spins_t[self._inv_map].t().to(torch.float32)
        return torch.where(self.ell.active_mask[None, :] > 0, s_rn,
                           torch.ones_like(s_rn))

    # -- energy (exact, in the transposed layout) --------------------------
    def energy(self, spins_t: torch.Tensor) -> torch.Tensor:
        s32 = spins_t.to(torch.float32)
        f_j = self._coupling @ s32
        return (-0.5 * torch.sum(s32 * f_j, dim=0)
                - torch.sum(self._h_sorted * s32, dim=0))

    # -- sweeps ------------------------------------------------------------
    def _thresholds(self, r: int, beta, generator: torch.Generator,
                    device) -> torch.Tensor:
        beta = torch.broadcast_to(torch.as_tensor(beta, dtype=torch.float32,
                                                  device=device), (r,))
        if self._use_kernel_rng and r % 128 == 0:
            return self.kernels.thresholds(beta, draw_seed(generator), r)
        u = device_uniforms(generator, (self.n_sorted, r), device)
        th = accept_threshold(u, beta[None, :], self.rule)
        return torch.where(self.mask_col < 0, torch.full_like(th, -torch.inf), th)

    def sweep(self, spins_t: torch.Tensor, beta, generator: torch.Generator):
        r = spins_t.shape[1]
        if self._accept_kernel in ("single", "fused") and r % 128 != 0:
            raise ValueError(
                f"accept_kernel='fused'/'single' needs replica count % 128 "
                f"== 0 (got {r}); falling back silently would run the wrong "
                f"code path")
        if self._takes_single(r):
            if spins_t.is_cuda:
                return self.kernels.single_sweep(spins_t, beta,
                                                 seed=draw_seed(generator))
            # CPU: host thresholds and the kernel's twin, as the JAX
            # package runs its interpret mode
            th = self._thresholds(r, beta, generator, spins_t.device)
            return self.kernels.single_sweep(spins_t, beta, th=th)
        if self._use_fused:
            return self._sweep_fused(spins_t, beta, draw_seed(generator))
        th = self._thresholds(r, beta, generator, spins_t.device)
        return self._sweep(spins_t, th)

    def sweep_with_uniforms(self, spins_t: torch.Tensor, beta,
                            uniforms_t: torch.Tensor):
        """Deterministic-uniform entry (tests): sorted row p consumes
        uniforms_t[p, :]. On the single path this drives K2's
        host-threshold mode (its twin on the CPU); K4 draws its own
        uniforms, so wherever ``sweep`` would take the fused sweep this runs
        the threshold path, as the JAX engine does."""
        r = spins_t.shape[1]
        beta = torch.broadcast_to(torch.as_tensor(beta, dtype=torch.float32,
                                                  device=spins_t.device), (r,))
        th = accept_threshold(uniforms_t, beta[None, :], self.rule)
        th = torch.where(self.mask_col < 0, torch.full_like(th, -torch.inf), th)
        if self._takes_single(r):
            return self.kernels.single_sweep(spins_t, beta, th=th.contiguous())
        return self._sweep(spins_t, th)


class SortedSparseEngine:
    """Sorted sliced-ELL engine in the [R, Np] layout ("rn"), plain PyTorch.

    Per-bucket K = that bucket's max degree; the colour-sorted layout makes
    spin reads and writes contiguous slices, so only the neighbour gather
    remains. State lives in the sorted layout between sweeps; ``to_layout``
    / ``from_layout`` convert at the run boundary."""

    layout = "rn"
    name = "sparse_sorted"

    def __init__(self, problem, rule: str = "metropolis",
                 max_colors: int = 256, n_buckets: int = 4):
        self.problem = problem
        self.rule = canonical_rule(rule)
        ell, colors = _ell_and_colors(problem, max_colors)
        self.ell = ell
        dev = ell.device
        self.n_colors = int(colors.max()) + 1 if colors.size else 1
        (self.perm, self.inv_perm, _,
         groups_np) = build_sorted_buckets(ell, colors, n_buckets=n_buckets)
        self.color_groups = _groups_on(groups_np, dev)
        self._perm = torch.as_tensor(self.perm, device=dev)
        self._inv_perm = torch.as_tensor(self.inv_perm, device=dev)
        idx_np = ell.idx.cpu().numpy()
        self.ell_sorted = EllProblem(
            idx=torch.as_tensor(self.inv_perm[idx_np[self.perm]].astype(np.int32),
                                device=dev),
            val=ell.val[self._perm], h=ell.h[self._perm],
            active_mask=ell.active_mask[self._perm], n_spins=ell.n_spins)
        self._sweep = make_sorted_sweep(self.color_groups, rule=self.rule)

    def energy(self, spins: torch.Tensor) -> torch.Tensor:
        return sparse_energy(self.ell_sorted, spins)

    def to_layout(self, spins_rn: torch.Tensor) -> torch.Tensor:
        return spins_rn[:, self._perm].contiguous()

    def from_layout(self, spins: torch.Tensor) -> torch.Tensor:
        return spins[:, self._inv_perm]

    def sweep(self, spins, beta, generator: torch.Generator):
        uniforms = device_uniforms(generator, spins.shape, spins.device)
        return self._sweep(spins, beta, uniforms)

    def sweep_with_uniforms(self, spins, beta, uniforms_sorted):
        """Deterministic-uniform entry for tests (uniforms in the sorted
        layout: sorted position p consumes uniforms[:, p])."""
        return self._sweep(spins, beta, uniforms_sorted)

