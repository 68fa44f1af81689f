"""Model-parallel sweeps: the coupling matrix sharded over the ranks.

The counterpart of ``spinglass_tpu.distributed.model_sharded``: the exact
formulations for instances whose J exceeds one device's memory. Each rank
holds its shard of J on its device:

* blocked_sweep_sharded — J **row-sharded** (``shard_problem_rows``); for
  each block of B spins every rank multiplies its rows into partial fields
  [R, B], one ``all_reduce`` completes them, a second assembles the block's
  [B, B] couplings from the rank that owns its rows, and the sequential
  decisions run replicated on identical uniforms (identical spins on every
  rank). Exact sequential-equivalent Metropolis / Glauber; per sweep
  2 x n_blocks all-reduces, whatever J's size. On the card the whole sweep
  (Np / B blocks of a few kernels per spin) is captured once per shape as a
  CUDA graph with its all-reduces inside, and replayed.
* colored_sweep_sharded — spins and J **column-sharded**
  (``shard_problem_cols``); per colour one ``all_gather`` of the +-1 spins
  and the fields of the rank's columns, and ``all_reduce``s of dE and the
  counts. Exact for proper colourings.

Decisions compare s * f with ``accept_threshold``, as ``kernels.sweeps``
does, so on the same uniforms both equal ``kernels.sweeps.blocked_sweep``
/ ``colored_sweep`` on one device (bit for bit where the fields are exact,
e.g. +-J). No kernel of the port runs here: the JAX functions are XLA
loops, and the partial fields are ``torch.matmul``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.distributed import multihost
from spinglass_tpu_torch.distributed.pt_sharded import gather_replicas
from spinglass_tpu_torch.kernels.sweeps import (_as_replica_beta,
                                                accept_threshold,
                                                canonical_rule, decide_block)


def make_mesh(device=None, axis: str = "spin"):
    """A 1-D ``DeviceMesh`` over every rank, axis ``axis``."""
    return multihost.replica_mesh(device, axis)


@dataclass(frozen=True)
class RowShard:
    """This rank's rows of J: ``j_rows`` [Np / W, Np] (rows ``row0`` ...),
    with h and the mask whole (they are [Np])."""

    j_rows: torch.Tensor
    h: torch.Tensor
    active_mask: torch.Tensor
    n_spins: int
    row0: int

    @property
    def n_padded(self) -> int:
        return self.j_rows.shape[1]

    @property
    def device(self) -> torch.device:
        return self.j_rows.device


@dataclass(frozen=True)
class ColumnShard:
    """This rank's columns of J: ``j_cols`` [Np, Np / W] (columns ``col0``
    ...), with the columns' h and mask."""

    j_cols: torch.Tensor
    h: torch.Tensor
    active_mask: torch.Tensor
    n_spins: int
    n_padded: int
    col0: int

    @property
    def device(self) -> torch.device:
        return self.j_cols.device


def _split(n_pad: int, mesh) -> Tuple[int, int, int]:
    rank, world = mesh.get_local_rank(), mesh.size()
    if n_pad % world:
        raise ValueError(f"padded N={n_pad} must divide over {world} devices")
    per = n_pad // world
    return rank, world, per


def shard_problem_rows(problem: IsingProblem, mesh,
                       axis: str = "spin") -> RowShard:
    """This rank's rows of J (h and the mask whole), on the problem's
    device."""
    rank, _, per = _split(problem.n_padded, mesh)
    r0 = rank * per
    return RowShard(j_rows=problem.j[r0:r0 + per].contiguous(),
                    h=problem.h, active_mask=problem.active_mask,
                    n_spins=problem.n_spins, row0=r0)


def shard_problem_cols(problem: IsingProblem, mesh,
                       axis: str = "spin") -> ColumnShard:
    """This rank's columns of J, h and the mask."""
    rank, _, per = _split(problem.n_padded, mesh)
    c0 = rank * per
    return ColumnShard(j_cols=problem.j[:, c0:c0 + per].contiguous(),
                       h=problem.h[c0:c0 + per].contiguous(),
                       active_mask=problem.active_mask[c0:c0 + per].contiguous(),
                       n_spins=problem.n_spins, n_padded=problem.n_padded,
                       col0=c0)


def local_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's columns of an [..., Np] tensor (spins, uniforms,
    colour masks)."""
    rank, _, per = _split(x.shape[-1], mesh)
    return x[..., rank * per:(rank + 1) * per].contiguous()


def _blocked_body(shard: RowShard, group, spins, beta, uniforms,
                  block_size: int, rule: str):
    """The eager sharded blocked sweep (``kernels.sweeps.blocked_sweep``
    with the fields of each block all-reduced from the row shards)."""
    r, n_pad = spins.shape
    rows_per = shard.j_rows.shape[0]
    row0 = shard.row0
    beta = _as_replica_beta(beta, r, spins.device)
    spins = spins.clone()
    de_acc = torch.zeros(r, dtype=torch.float32, device=spins.device)
    cnt = torch.zeros(r, dtype=torch.int32, device=spins.device)
    s_local = spins[:, row0:row0 + rows_per]   # view: follows the updates
    for i0 in range(0, n_pad, block_size):
        i1 = i0 + block_size
        # partial fields from the rank's rows: H[r, k] = sum_{i in my rows}
        # s[r, i] J[i, i0 + k]
        hblk = torch.matmul(s_local, shard.j_rows[:, i0:i1])
        dist.all_reduce(hblk, group=group)
        hblk = hblk + shard.h[i0:i1]
        # the block's rows live wholly on one rank (rows_per % B == 0): the
        # owner contributes them, the all-reduce assembles [B, B]
        owner = row0 <= i0 < row0 + rows_per
        jbb = (shard.j_rows[i0 - row0:i1 - row0, i0:i1].clone() if owner
               else torch.zeros(block_size, block_size, dtype=hblk.dtype,
                                device=hblk.device))
        dist.all_reduce(jbb, group=group)
        de_acc, cnt = decide_block(
            spins[:, i0:i1], hblk, jbb,
            accept_threshold(uniforms[:, i0:i1], beta[:, None], rule),
            shard.active_mask[i0:i1] > 0, de_acc, cnt)
    return spins, de_acc, cnt


# (shard object, key) -> the captured sweep, and (problem object, group) ->
# its row shard; ``graphs.clear_caches`` clears them
BLOCKED_CACHE = graphs.StepCache("model_sharded_sweeps")
ROW_SHARDS = graphs.StepCache("model_sharded_rows")


def _captured_blocked(shard: RowShard, group, spins, beta, uniforms,
                      block_size: int, rule: str):
    """The sweep as a captured step on the card: inputs copied into its
    static state, one replay. Kept per (shard, shapes, block, rule)."""
    r = spins.shape[0]
    beta = _as_replica_beta(beta, r, spins.device).contiguous()
    key = (tuple(spins.shape), block_size, rule, id(group))
    step = BLOCKED_CACHE.get(shard, key)
    state = {"spins": spins, "beta": beta, "uniforms": uniforms}
    if step is None:
        def sweep(st):
            s, de, cnt = _blocked_body(shard, group, st["spins"], st["beta"],
                                       st["uniforms"], block_size, rule)
            return dict(st, spins=s), (s, de, cnt)

        step = graphs.CapturedStep(sweep, graphs.clone(state),
                                   torch.Generator())
        BLOCKED_CACHE.put(shard, key, step)
    step.load(state)
    s, de, cnt = step.replay()
    return s.clone(), de.clone(), cnt.clone()


def blocked_sweep_sharded(problem, mesh, spins: torch.Tensor, beta,
                          uniforms: torch.Tensor, *, block_size: int = 128,
                          rule: str = "metropolis", axis: str = "spin"
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact blocked-sequential sweep with J row-sharded over the ranks.

    ``problem``: this rank's ``RowShard`` (or an ``IsingProblem``, sharded
    here); spins / uniforms [R, Np] the same on every rank. Returns
    (spins, dE[R], n_accepted[R]), the same on every rank and equal to
    ``kernels.sweeps.blocked_sweep`` on one device (bit for bit where the
    fields are exact). Raises ``ValueError`` unless Np divides over the
    ranks into row shards that are multiples of ``block_size``."""
    rule = canonical_rule(rule)
    r, n_pad = spins.shape
    world = mesh.size()
    rows_per = n_pad // world
    if n_pad % world or rows_per % block_size:
        raise ValueError(
            f"padded N={n_pad} must divide over {world} devices into row "
            f"shards that are multiples of block_size={block_size}")
    group = mesh.get_group()
    with graphs.DRIVER_LOCK:
        shard = problem
        if not isinstance(problem, RowShard):   # one shard per problem
            shard = ROW_SHARDS.get(problem, id(group))
            if shard is None:
                shard = shard_problem_rows(problem, mesh, axis)
                ROW_SHARDS.put(problem, id(group), shard)
        if spins.is_cuda:
            return _captured_blocked(shard, group, spins, beta, uniforms,
                                     block_size, rule)
        return _blocked_body(shard, group, spins, beta, uniforms, block_size,
                             rule)


def colored_sweep_sharded(problem, mesh, color_masks: torch.Tensor,
                          spins_sharded: torch.Tensor, beta,
                          uniforms_sharded: torch.Tensor, *,
                          rule: str = "metropolis", axis: str = "spin"
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coloured sweep with spins and J column-sharded over the ranks.

    ``problem``: this rank's ``ColumnShard`` (or an ``IsingProblem``);
    ``spins_sharded`` / ``uniforms_sharded`` [R, Np / W] this rank's
    columns; ``color_masks`` [C, Np] (or this rank's [C, Np / W]). Each
    colour all-gathers the spins (R * Np values, the only traffic besides
    the [R] sums) and updates the rank's columns. Returns (the rank's spins
    [R, Np / W], dE[R], n_accepted[R]); dE and the counts are the same on
    every rank."""
    rule = canonical_rule(rule)
    shard = (problem if isinstance(problem, ColumnShard)
             else shard_problem_cols(problem, mesh, axis))
    group, world = mesh.get_group(), mesh.size()
    per = shard.j_cols.shape[1]
    if color_masks.shape[-1] != per:
        color_masks = local_columns(color_masks, mesh)
    r = spins_sharded.shape[0]
    beta = _as_replica_beta(beta, r, spins_sharded.device)
    active = shard.active_mask > 0
    th = accept_threshold(uniforms_sharded, beta[:, None], rule)
    s_local = spins_sharded
    de_acc = torch.zeros(r, dtype=torch.float32, device=s_local.device)
    cnt = torch.zeros(r, dtype=torch.int32, device=s_local.device)
    for mask in color_masks:
        s_full = gather_replicas(s_local, group, world)   # [R, Np]
        f = torch.matmul(s_full, shard.j_cols) + shard.h
        sf = s_local * f
        acc = (sf < th) & (mask > 0)[None, :] & active[None, :]
        s_local = torch.where(acc, -s_local, s_local)
        sums = torch.stack([torch.sum(torch.where(acc, 2.0 * sf, 0.0), dim=-1),
                            torch.sum(acc, dim=-1, dtype=torch.float32)])
        dist.all_reduce(sums, group=group)
        de_acc = de_acc + sums[0]
        cnt = cnt + sums[1].to(torch.int32)
    return s_local, de_acc, cnt
