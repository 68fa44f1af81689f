"""Parallel tempering with the replicas sharded over the ranks of a group.

The counterpart of ``spinglass_tpu.distributed.pt_sharded``. The JAX module
shards the replica axis over a device mesh and lets GSPMD move the [R]
energy and slot vectors; here each rank of a ``torch.distributed`` group
(``multihost.initialize``, a 1-D ``DeviceMesh``) holds its replica shard
[R/W] and runs the sweeps on it through ``make_engine``'s engine, picked for
the rank's replica count (K1 dense, K2 or K4 sparse on the card). Once per
super-step one ``all_gather_into_tensor`` collects the shards' [R]
energies (the sweeps' and the exact ones), slots, best energies and
acceptance rates; the exchange pass runs on every rank from the group's
shared generator, and each rank keeps its own slice of the new slots.
Spins never move.

Randomness: every rank holds the same host generator (seeded by
``cfg.seed``) and makes the same host draws; the engines draw through a
``core.rng.ShardStream``: a kernel's seed folded with the rank (rank 0
keeps it, so a one-rank group draws exactly ``pt.run``'s stream, as JAX
folds the device index into the key), a plain sweep's uniforms drawn for all
R replicas and sliced. So on the CPU a W-rank run equals ``pt.run`` bit for
bit, and on the card a one-rank run does.

Entry points:
  make_sharded_pt_step(...)  — the eager sharded super-step, its ``init``,
                               the ladder, the engine and the rank's slice.
  run(...)                   — full sharded PT run mirroring ``pt.run``:
                               the super-step captured with its collective
                               inside (a CUDA graph on the card; eager
                               through the tape on the CPU) and replayed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.anneal import pt as pt_mod
from spinglass_tpu_torch.anneal.engines import (CudaFusedEngine, best_row,
                                                launch_counters, make_engine)
from spinglass_tpu_torch.anneal.pt import PTConfig, PTState
from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.core import rng
from spinglass_tpu_torch.core.cluster import SwendsenWang
from spinglass_tpu_torch.core.problem import random_spins
from spinglass_tpu_torch.distributed import multihost
from spinglass_tpu_torch.kernels import cluster_cuda
from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine


def make_mesh(device=None, axis: str = "replica"):
    """A 1-D ``DeviceMesh`` over every rank (``multihost.replica_mesh``;
    brings up a one-rank group where none is up)."""
    return multihost.replica_mesh(device, axis)


def mesh_rank(mesh) -> tuple:
    """(rank on the mesh's axis, world size, process group) of this rank."""
    return mesh.get_local_rank(), mesh.size(), mesh.get_group()


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``all_gather_into_tensor`` (``all_gather_single``, its newer name,
    where torch has it): ranks' ``x`` concatenated along dim 0 into
    ``out``."""
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, x, group=group)


def gather_replicas(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """[..., n] on every rank -> [..., world * n], rank r's columns at
    [r * n, (r + 1) * n): one ``all_gather_into_tensor``."""
    lead, n = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, n).contiguous()
    out = torch.empty((world * flat.shape[0], n), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, flat, group)
    return out.reshape(world, -1, n).permute(1, 0, 2).reshape(
        lead + (world * n,))


class ShardedEngine:
    """An engine run on this rank's replica shard: its sweeps draw through
    a ``core.rng.ShardStream`` (kernel seeds folded with the rank, plain
    sweeps' uniforms the rank's slice of all R replicas'). Everything else
    is the inner engine's. The plain PyTorch engines take this wrapper
    (the JAX package leaves them to GSPMD); the kernel engines take
    ``ShardedFusedEngine`` and ``ShardedSortedTEngine``."""

    def __init__(self, engine, mesh, axis: str = "replica"):
        self.inner = engine
        self.problem = engine.problem
        self.mesh = mesh
        self.axis = axis
        self.rank, self.world, self.group = mesh_rank(mesh)
        self.layout = engine.layout
        # the replica axis of the engine's layout
        self.replica_dim = 1 if engine.layout == "nr" else 0
        self.name = self._name(engine)
        for attr in ("fused", "kernels"):   # launch counters
            if hasattr(engine, attr):
                setattr(self, attr, getattr(engine, attr))

    def _name(self, engine) -> str:
        return engine.name

    @property
    def launches(self) -> dict:
        return dict(getattr(self.inner, "launches", {}))

    def stream(self, generator) -> rng.ShardStream:
        return rng.ShardStream(generator, self.rank, self.world,
                               self.replica_dim)

    def to_layout(self, spins_rn):
        return self.inner.to_layout(spins_rn)

    def from_layout(self, spins):
        return self.inner.from_layout(spins)

    def energy(self, spins):
        return self.inner.energy(spins)

    def sweep(self, spins, beta, generator):
        return self.inner.sweep(spins, beta, self.stream(generator))

    def gather_envs(self, x: torch.Tensor) -> torch.Tensor:
        """A per-replica vector [R/W] of every rank, joined in rank order
        [R] (``rl.env.observe``'s batch statistics)."""
        return gather_replicas(x, self.group, self.world)

    def sweep_with_uniforms(self, spins, beta, uniforms):
        """One sweep on given uniforms: the inner engine's layout, for this
        rank's replicas, or for all R (then the rank's slice is taken)."""
        d = self.replica_dim
        n = spins.shape[d]
        if uniforms.shape[d] == n * self.world and self.world > 1:
            uniforms = uniforms.narrow(d, self.rank * n, n).contiguous()
        return self.inner.sweep_with_uniforms(spins, beta, uniforms)


class ShardedFusedEngine(ShardedEngine):
    """K1 (``CudaFusedEngine``) on this rank's [Np, R/W] tile; its seed is
    the shared draw folded with the rank (the JAX ``ShardedPallasEngine``,
    whose devices fold their mesh index into the key)."""

    def _name(self, engine) -> str:
        return f"{engine.name}_shard{self.world}"


class ShardedSortedTEngine(ShardedEngine):
    """The transposed sparse engine (K2 or K4 on the card, picked for the
    rank's replica count) on this rank's [NS, R/W] tile."""

    def _name(self, engine) -> str:
        return f"{engine.name}_shard{self.world}"


def make_sharded_engine(problem, cfg: PTConfig, mesh, axis: str = "replica"):
    """``make_engine``'s engine for the rank's R/W replicas, wrapped for
    the shard (``ShardedFusedEngine``, ``ShardedSortedTEngine``, else
    ``ShardedEngine``)."""
    world = mesh.size()
    engine = make_engine(problem, sweep_method=cfg.sweep_method,
                         update_rule=cfg.update_rule,
                         block_size=cfg.block_size,
                         use_kernel=cfg.use_kernel, j_dtype=cfg.j_dtype,
                         r_hint=cfg.n_replicas * cfg.n_chains // world)
    if isinstance(engine, CudaFusedEngine):
        return ShardedFusedEngine(engine, mesh, axis)
    if isinstance(engine, SortedSparseTEngine):
        return ShardedSortedTEngine(engine, mesh, axis)
    return ShardedEngine(engine, mesh, axis)


def make_sharded_pt_step(problem, cfg: PTConfig, mesh,
                         axis: str = "replica", engine=None):
    """Returns (step, init, betas_ladder, engine, shard). ``step(state,
    betas=None) -> (state, stats)`` is one super-step on this rank's
    shard: ``exchange_interval`` sweeps, ``cluster_moves`` Swendsen-Wang
    sweeps, the gather, the exchange pass and the energy resync; its stats
    are ``pt.make_pt_step``'s, from the gathered vectors (the same on every
    rank). ``init(generator=None)`` is the rank's start state (the slice of
    ``pt.init_state``'s). ``shard`` is the rank's slice of the replica axis.
    ``engine`` overrides ``make_sharded_engine``'s choice."""
    rank, world, group = mesh_rank(mesh)
    if cfg.n_replicas % world != 0:
        raise ValueError(
            f"n_replicas={cfg.n_replicas} must divide over {world} devices")
    if engine is None:
        engine = make_sharded_engine(problem, cfg, mesh, axis)
    nr, c = cfg.n_replicas, cfg.n_chains
    r_loc = nr * c // world
    shard = slice(rank * r_loc, (rank + 1) * r_loc)
    temps = pt_mod.temperature_ladder(cfg)
    betas_ladder = torch.as_tensor(1.0 / temps, device=problem.device)
    sw = SwendsenWang(problem) if cfg.cluster_moves > 0 else None

    def step(state: PTState, betas: Optional[torch.Tensor] = None):
        betas = betas_ladder if betas is None else betas
        for _ in range(cfg.exchange_interval):
            state = pt_mod._one_sweep(problem, engine, state, betas)
        if sw is not None:
            gen = state.generator
            state = pt_mod._cluster_moves(
                engine, sw, dataclasses.replace(
                    state, generator=rng.ShardStream(gen, rank, world, 0)),
                betas, cfg.cluster_moves)
            state = dataclasses.replace(state, generator=gen)
        # exact energies (the exchange moves no spin); one gather of the
        # shards' vectors feeds the exchange and the stats
        exact = engine.energy(state.spins)
        g = gather_replicas(torch.stack([
            state.energy, exact, state.slot.to(torch.float32),
            state.best_energy, state.acc_rate]), group, world)
        e_sweeps, e_exact, slot_g, best_g, acc_g = g
        glob = dataclasses.replace(state, slot=slot_g.to(torch.int32),
                                   energy=e_sweeps)
        perm, u = pt_mod._exchange_draws(cfg, state.generator, betas.device)
        if cfg.exchange_method == "all_pairs":
            glob = pt_mod.exchange_step_all_pairs(glob, betas, perm, u,
                                                  n_chains=c)
        else:
            parity = (state.sweep // cfg.exchange_interval) % 2
            glob = pt_mod.exchange_step(glob, betas, parity, u, n_chains=c)
        state = dataclasses.replace(
            state, slot=glob.slot[shard], energy=exact,
            exch_attempts=glob.exch_attempts, exch_accepts=glob.exch_accepts)
        e_c = e_exact.reshape(c, nr)
        inv_c = torch.argsort(glob.slot.reshape(c, nr), dim=1)
        e_by_slot = torch.gather(e_c, 1, inv_c)                # [C, R]
        stats = {
            "best_energy": torch.min(best_g),
            "cold_energy": torch.mean(e_by_slot[:, 0]),
            "mean_acceptance": torch.mean(acc_g),
            "slot_energy": torch.mean(e_by_slot, dim=0),
            "slot_of_replica": glob.slot,
        }
        return state, stats

    step.counters = launch_counters(engine) + (
        [(cluster_cuda.BONDS_KERNEL, sw.bonds, "launches"),
         (cluster_cuda.KERNEL_NAME, sw.labeller, "launches")] if sw else [])

    def init(generator: Optional[torch.Generator] = None) -> PTState:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        dev = problem.device
        spins = random_spins(rng.ShardStream(generator, rank, world, 0),
                             (r_loc, problem.n_padded), problem.active_mask)
        spins = engine.to_layout(spins)
        e = engine.energy(spins)
        slot = torch.arange(nr, dtype=torch.int32, device=dev).repeat(c)
        return PTState(
            spins=spins, slot=slot[shard].contiguous(), energy=e,
            best_energy=e.clone(), best_spins=spins.clone(),
            generator=generator, sweep=0,
            exch_attempts=torch.zeros(nr - 1, dtype=torch.int32, device=dev),
            exch_accepts=torch.zeros(nr - 1, dtype=torch.int32, device=dev),
            acc_rate=torch.zeros(r_loc, dtype=torch.float32, device=dev))

    return step, init, betas_ladder, engine, shard


# (problem object, config, mesh) -> (mesh, betas, engine, captured step)
SHARDED_CACHE = graphs.StepCache("pt_sharded_steps")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@graphs.serialized
def run(problem, cfg: Optional[PTConfig] = None, mesh=None,
        generator: Optional[torch.Generator] = None) -> AnnealResult:
    """Full sharded PT run, the multi-rank ``pt.run``: the sharded
    super-step captured once with its collective inside
    (``pt.capture_super_step``; kept per (problem object, config without
    its seed, mesh) in ``SHARDED_CACHE``) and replayed n_super times; one
    more gather at the end brings the replicas' best energies and the best
    replica's spins to every rank. Every rank returns the same result.
    ``metadata`` has the JAX keys ``n_devices`` and ``exchange_rates``, and
    ``pt.run``'s (``kernel_launches`` are this rank's, this call's)."""
    cfg = cfg or PTConfig()
    mesh = mesh if mesh is not None else make_mesh(problem.device)
    rank, world, group = mesh_rank(mesh)
    n_super = max(1, cfg.n_sweeps // cfg.exchange_interval)
    key = ("run", graphs.config_key(cfg), id(mesh))
    entry = SHARDED_CACHE.get(problem, key)
    step_fn, init = None, None
    if entry is None:
        step_fn, init, betas_ladder, engine, _ = make_sharded_pt_step(
            problem, cfg, mesh)
        counters = step_fn.counters
    else:
        _, betas_ladder, engine, init, captured = entry
        counters = captured.counters
    launches0 = pt_mod._counts(counters)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    _sync(problem.device)
    t0 = time.perf_counter()
    state = init(generator)
    if entry is None:
        captured = pt_mod.capture_super_step(step_fn, engine, state,
                                             record=n_super)
        SHARDED_CACHE.put(problem, key,
                          (mesh, betas_ladder, engine, init, captured))
        capture_s = captured.capture_seconds
    else:
        captured.load(graphs.device_counter(state))
        capture_s = 0.0
    for _ in range(n_super):
        captured.replay(generator)
    st = captured.state
    r_loc = st.best_energy.shape[0]
    row = best_row(engine, st.best_spins, torch.argmin(st.best_energy))
    g = gather_replicas(torch.cat([st.best_energy, row.to(torch.float32)]),
                        group, world).reshape(world, -1)
    replica_best = g[:, :r_loc].reshape(-1)
    best_r = torch.argmin(replica_best)
    dev_out = {
        "best_spins": g[best_r // r_loc, r_loc:],
        "best_energy": torch.min(replica_best),
        "replica_best": replica_best,
        "exch_attempts": st.exch_attempts,
        "exch_accepts": st.exch_accepts,
    }
    out = {k: v.to("cpu", copy=True).numpy() for k, v in dev_out.items()}
    out["hist"] = {k: v.to("cpu", copy=True).numpy()
                   for k, v in captured.history.items()}
    _sync(problem.device)
    total = time.perf_counter() - t0
    launches = pt_mod._counts(counters)
    res = pt_mod._assemble_result(
        problem, cfg, out, betas_ladder, n_super, total, engine,
        {k: v - launches0.get(k, 0) for k, v in launches.items()})
    res.algorithm = f"pt_sharded/{engine.name}x{world}"
    res.metadata["n_devices"] = world
    res.metadata["capture_seconds"] = capture_s
    return res
