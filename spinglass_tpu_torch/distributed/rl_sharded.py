"""Data-parallel PPO over the ranks of a group: envs sharded, learner
replicated.

The counterpart of ``spinglass_tpu.distributed.rl_sharded``. In JAX the
env batch is sharded over the mesh and GSPMD partitions the jitted update:
the rollout runs per device, the permutation of ``ppo.update`` covers all
T x B transitions and the advantages are normalised per minibatch. To keep
that algorithm, each rank here rolls out its own B/W envs
(``make_ppo``'s ``rollout`` through a ``ShardedEngine``), one
``all_gather_into_tensor`` brings the trajectory to every rank along the env
axis in global env order, and ``make_ppo``'s ``learn`` runs replicated on the
gathered batch: every rank draws the same minibatch permutations from the
shared host generator, so the parameters stay equal on every rank without a
gradient all-reduce. (A gradient average over local minibatches would be a
different algorithm.)

Randomness: every rank holds the same host generator; the rollout's draws
(the policy's, the env's, the engine's) go through a
``core.rng.ShardStream``: each device draw is made for all B envs and the
rank keeps its slice, and a kernel seed is folded with the rank. So the
host draws, and with them the learner's generator, advance identically on
every rank, and a W-rank run's actions and rewards are those of the
one-rank ``make_ppo`` run (bit for bit on the CPU, and on the card at one
rank).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from spinglass_tpu_torch.core import rng
from spinglass_tpu_torch.distributed import multihost
from spinglass_tpu_torch.distributed.pt_sharded import (ShardedEngine,
                                                        gather_replicas,
                                                        mesh_rank)
from spinglass_tpu_torch.rl import env as env_mod
from spinglass_tpu_torch.rl import ppo as ppo_mod
from spinglass_tpu_torch.rl.env import EnvConfig


def make_mesh(device=None, axis: str = "batch"):
    """A 1-D ``DeviceMesh`` over every rank, axis ``axis``."""
    return multihost.replica_mesh(device, axis)


def shard_train_state(state: ppo_mod.TrainState, mesh,
                      axis: str = "batch") -> ppo_mod.TrainState:
    """This rank's part of a ``TrainState`` of all B envs: the env fields
    and observations of its envs (their leading axis sliced), the learner
    (parameters, optimizer, generator, update count) whole."""
    rank, world, _ = mesh_rank(mesh)

    def take(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n].clone()

    def walk(s):
        return type(s)(**{f.name: (walk(getattr(s, f.name))
                                   if dataclasses.is_dataclass(getattr(s, f.name))
                                   else take(getattr(s, f.name)))
                          for f in dataclasses.fields(s)})

    return dataclasses.replace(state, env_state=walk(state.env_state),
                               obs=take(state.obs))


def _pack(traj: dict, last_value, best_energy):
    """The rollout's tensors as one float32 [B_local, F] block, env axis
    first (the trajectory's [T, B, ...] transposed), and the recipe that
    splits a gathered block back (``_unpack``)."""
    parts, recipe = [], []

    def add(name, x, env_first):
        flat = x.reshape(x.shape[0], -1)
        parts.append(flat.to(torch.float32))
        recipe.append((name, tuple(x.shape[1:]), x.dtype, flat.shape[1],
                       env_first))

    for k, v in traj.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            add((k, kk), vv.transpose(0, 1), False)
    add(("_last", None), last_value, True)
    add(("_best", None), best_energy, True)
    return torch.cat(parts, dim=1), recipe


def _unpack(block: torch.Tensor, recipe):
    """(trajectory [T, B, ...], last values [B], best energies [B]) of a
    gathered [B, F] block."""
    traj, extra, col = {}, {}, 0
    for (k, kk), shape, dtype, width, env_first in recipe:
        x = block[:, col:col + width].reshape((block.shape[0],) + shape)
        x = x.to(dtype)
        col += width
        if env_first:
            extra[k] = x.contiguous()
        elif kk is None:
            traj[k] = x.transpose(0, 1).contiguous()
        else:
            traj.setdefault(k, {})[kk] = x.transpose(0, 1).contiguous()
    return traj, extra["_last"], extra["_best"]


def make_sharded_ppo(problem, env_cfg: EnvConfig,
                     cfg: Optional[ppo_mod.PPOConfig] = None, mesh=None,
                     axis: str = "batch", engine="auto"):
    """Returns (init_fn, update_fn, model, mesh). ``env_cfg.n_envs`` is the
    global env count and must divide over the ranks; each rank rolls out
    B/W envs through ``make_engine``'s engine for B/W replicas (K1 dense on
    the card; K2 or K4 for an ``EllProblem``), wrapped for the shard.
    ``init_fn(generator=None)`` is the rank's ``TrainState`` (its envs, the
    whole learner); ``update_fn(state)`` one PPO iteration: the rank's
    rollout, the gather, the replicated learning phase. Its metrics are the
    global ones (0-d device tensors), the same on every rank.
    ``update_fn.engine`` is the sharded engine (its launch counters)."""
    mesh = mesh if mesh is not None else make_mesh(problem.device, axis)
    rank, world, group = mesh_rank(mesh)
    if env_cfg.n_envs % world != 0:
        raise ValueError(f"n_envs={env_cfg.n_envs} not divisible by "
                         f"{world} devices")
    cfg = cfg or ppo_mod.PPOConfig()
    local_cfg = dataclasses.replace(env_cfg, n_envs=env_cfg.n_envs // world)
    if engine == "auto":
        engine = env_mod.default_engine(problem, local_cfg)
    if engine is not None:
        engine = ShardedEngine(engine, mesh, axis)
    base_init, base_update, model = ppo_mod.make_ppo(problem, local_cfg, cfg,
                                                     engine=engine)
    rollout, learn = base_update.rollout, base_update.learn

    def stream(generator):
        return rng.ShardStream(generator, rank, world, 0)

    def init_fn(generator: Optional[torch.Generator] = None
                ) -> ppo_mod.TrainState:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        env_state, obs = env_mod.reset(problem, local_cfg, stream(generator),
                                       engine)
        params = ppo_mod.init_params(model, generator, problem.device)
        return ppo_mod.TrainState(params=params,
                                  opt=ppo_mod.make_optimizer(cfg, params),
                                  env_state=env_state, obs=obs,
                                  generator=generator, update=0)

    def update_fn(state: ppo_mod.TrainState):
        gen = state.generator
        state, traj, last_value = rollout(
            dataclasses.replace(state, generator=stream(gen)))
        state = dataclasses.replace(state, generator=gen)
        block, recipe = _pack(traj, last_value, state.env_state.best_energy)
        g_traj, g_last, g_best = _unpack(
            gather_replicas(block.t(), group, world).t(), recipe)
        glob = dataclasses.replace(
            state, env_state=state.env_state.replace(best_energy=g_best))
        glob, metrics = learn(glob, g_traj, g_last)
        state.update = glob.update
        return state, metrics

    update_fn.rollout, update_fn.learn = rollout, learn
    update_fn.engine = engine
    return init_fn, update_fn, model, mesh
