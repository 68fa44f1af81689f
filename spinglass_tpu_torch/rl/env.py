"""Vectorised annealer-as-environment.

The counterpart of ``spinglass_tpu.rl.env``: B annealing trajectories step
in lockstep, the agent controls the temperature schedule, and the
environment is the annealer. Everything is a function of (problem, EnvState,
action, generator) on the problem's device; nothing inside ``reset``,
``step``, ``observe`` or ``auto_reset`` reads a value back to the host, so a
rollout never waits for the device.

Engine plumbing: ``reset``/``step``/``auto_reset`` take the ``engine`` that
``default_engine`` builds once for (problem, cfg) through
``anneal.engines.make_engine``. With it the sweeps run through the fused
dense kernel K1 on the card, or, for an ``EllProblem``, through the sorted
sparse engines (K2 where the env count is a multiple of 128, K4 at every
other count from 16 envs on). ``engine=None`` is the dense blocked sweep in
plain PyTorch and is taken for a problem on the CPU only: for a problem on
the card it raises, so no caller reaches the plain sweep there by leaving the
argument out. ``EnvState.spins`` stays [B, Np] float32; the layout is
converted once per env step around the ``sweeps_per_step`` sweeps.

Randomness: the JAX package's keys become one host ``torch.Generator``,
as in ``anneal.sa`` and ``anneal.pt``. A sweep through an engine draws one seed from it (the
kernels' Philox key); start spins, start temperatures and the plain sweep's
uniforms are drawn on the device from a generator seeded by one such draw.
``step`` also takes explicit ``uniforms`` [sweeps_per_step, B, Np] so that
tests can feed both packages the same numbers. Every draw goes through
``core.rng``, so a step inside a captured PPO update draws through the
update's random tape, the same numbers in the same order. ``auto_reset`` draws and computes a whole fresh state every step and
mixes it in by ``done``.

The kernels update spins in place. Where an action carries a sweep fraction
(``continuous`` and ``hybrid`` modes) the envs whose budget is spent must
keep their spins, so ``step`` copies the state before each gated sweep and
restores those envs' columns afterwards.

Observation (obs_mode="global", default): 16 global features per env
  [E/E0, E_best/E0, dE_last/|E0|, log10(T), acceptance, progress,
   magnetisation, E z-score, plateau fraction, ...]
obs_mode="spins": concat(spins masked to 0 at padding, the 16 globals).
Action modes:
  discrete   - index into TEMP_MULTIPLIERS
  continuous - [temp multiplier in [0.5, 2], sweep fraction in [0.1, 1]]
  hybrid     - {"temp_index": ladder index, "sweep_frac": fraction}
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from spinglass_tpu_torch.core import energy as energy_ops
from spinglass_tpu_torch.core import rng
from spinglass_tpu_torch.core.problem import random_spins
from spinglass_tpu_torch.kernels import sweeps as sweep_kernels
from spinglass_tpu_torch.rl import rewards as reward_mod

TEMP_MULTIPLIERS = np.asarray(
    [0.5, 0.7, 0.8, 0.9, 0.95, 1.05, 1.1, 1.25, 1.5, 2.0], np.float32)
N_ACTIONS = 10
OBS_DIM = 16


@dataclass(frozen=True)
class EnvConfig:
    """Static env parameters (the JAX ``EnvConfig``)."""

    n_envs: int = 64
    sweeps_per_step: int = 10
    max_steps: int = 100
    action_mode: str = "discrete"        # discrete | continuous | hybrid
    obs_mode: str = "global"             # global | spins
    initial_temp: float = 2.0
    init_temp_range: Optional[Tuple[float, float]] = None  # when set, each
    # reset draws the starting temperature log-uniformly per env from this
    # range instead of the fixed initial_temp: the setting where a learned,
    # observation-driven controller beats any fixed geometric schedule
    min_temp: float = 1e-3
    max_temp: float = 50.0
    update_rule: str = "metropolis"
    block_size: int = 128
    plateau_patience: int = 10           # done after this many steps without
    plateau_tolerance: float = 1e-6      # improvement
    reward: reward_mod.RewardConfig = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.reward is None:
            object.__setattr__(self, "reward", reward_mod.RewardConfig())


@dataclass
class EnvState:
    spins: torch.Tensor           # [B, Np] float32
    energy: torch.Tensor          # [B]
    best_energy: torch.Tensor     # [B]
    initial_energy: torch.Tensor  # [B]
    prev_energy: torch.Tensor     # [B]
    temp: torch.Tensor            # [B]
    acc_rate: torch.Tensor        # [B]
    step: torch.Tensor            # [B] int32
    plateau: torch.Tensor         # [B] int32: steps since last improvement
    episode: torch.Tensor         # [B] int32: completed episodes (curriculum)
    reward_state: reward_mod.RewardState
    done: torch.Tensor            # [B] bool

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


def _check_engine(problem, engine) -> None:
    """``engine=None`` selects the plain PyTorch sweep, which is for problems
    on the CPU: on the card the sweeps go through ``default_engine``'s engine
    and its kernels, never around them."""
    if engine is None and problem.device.type == "cuda":
        raise ValueError(
            "the problem is on a CUDA device: pass engine=default_engine("
            "problem, cfg) (built once, reused for every call); engine=None "
            "is the plain PyTorch sweep, for problems on the CPU")


def _env_energy(problem, spins, engine=None):
    """Exact energies of [B, Np] spins, through the engine when given (an
    ``EllProblem`` has no dense J)."""
    if engine is not None:
        return engine.energy(engine.to_layout(spins))
    return energy_ops.energy(problem, spins)


def _fresh_state(problem, cfg: EnvConfig, generator: torch.Generator,
                 engine=None, spins: Optional[torch.Tensor] = None
                 ) -> EnvState:
    _check_engine(problem, engine)
    b = cfg.n_envs
    dev = problem.device
    if spins is None:
        spins = random_spins(rng.device_generator(generator, dev),
                             (b, problem.n_padded), problem.active_mask)
    e = _env_energy(problem, spins, engine)
    if cfg.init_temp_range is not None:
        lo, hi = (float(np.log(t)) for t in cfg.init_temp_range)
        u = rng.device_uniforms(generator, (b,), dev)
        t0 = torch.exp(u * (hi - lo) + lo)
    else:
        t0 = torch.full((b,), cfg.initial_temp, device=dev)
    return EnvState(
        spins=spins,
        energy=e,
        best_energy=e,
        initial_energy=e,
        prev_energy=e,
        temp=t0,
        acc_rate=torch.zeros(b, device=dev),
        step=torch.zeros(b, dtype=torch.int32, device=dev),
        plateau=torch.zeros(b, dtype=torch.int32, device=dev),
        episode=torch.zeros(b, dtype=torch.int32, device=dev),
        reward_state=reward_mod.init_state(cfg.reward, b, dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
    )


def reset(problem, cfg: EnvConfig, generator: torch.Generator,
          engine=None) -> Tuple[EnvState, torch.Tensor]:
    """Fresh trajectories: random spins, initial temperature."""
    state = _fresh_state(problem, cfg, generator, engine)
    return state, observe(problem, cfg, state, engine)


@functools.lru_cache(maxsize=None)
def _ladder(device: torch.device) -> torch.Tensor:
    """TEMP_MULTIPLIERS on ``device``, copied there once: a copy from the
    host inside a step would make the rollout wait for the device."""
    return torch.as_tensor(TEMP_MULTIPLIERS, device=device)


def _decode_action(cfg: EnvConfig, action) -> Tuple[torch.Tensor, torch.Tensor]:
    """action -> (temperature multiplier [B], sweep fraction [B]).

    hybrid: a dict with a ladder index ``temp_index`` [B] and a continuous
    ``sweep_frac`` [B]."""
    if cfg.action_mode == "discrete":
        mult = _ladder(action.device)[action.long()]
        frac = torch.ones_like(mult)
    elif cfg.action_mode == "continuous":
        mult = torch.clamp(action[..., 0], 0.5, 2.0)
        frac = torch.clamp(action[..., 1], 0.1, 1.0)
    elif cfg.action_mode == "hybrid":
        idx = action["temp_index"]
        mult = _ladder(idx.device)[idx.long()]
        frac = torch.clamp(action["sweep_frac"], 0.1, 1.0)
    else:
        raise ValueError(cfg.action_mode)
    return mult, frac


def _uniform_sweep(problem, cfg: EnvConfig, engine, spins, beta, u_rn):
    """One sweep on the caller's uniforms ``u_rn`` [B, Np] (spin i of env b
    consumes u_rn[b, i]), through the blocked engine or the plain
    blocked sweep: the two sweeps that take uniforms in the problem's spin
    order."""
    if engine is None:
        return sweep_kernels.blocked_sweep(problem, spins, beta, u_rn,
                                           block_size=cfg.block_size,
                                           rule=cfg.update_rule)
    if getattr(engine, "name", None) != "blocked":
        raise ValueError(
            f"explicit uniforms need the blocked engine or no engine, got "
            f"{getattr(engine, 'name', engine)!r}")
    return engine.sweep_with_uniforms(spins, beta, u_rn)


def step(problem, cfg: EnvConfig, state: EnvState, action,
         generator: Optional[torch.Generator], engine=None,
         uniforms: Optional[torch.Tensor] = None
         ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One env step: apply the temperature action, run ``sweeps_per_step``
    sweeps at constant temperature, shape the reward.

    With ``engine`` the sweeps run through it (the kernels on the card);
    without, for a problem on the CPU, through the blocked sweep in plain
    PyTorch. ``uniforms`` [sweeps_per_step, B, Np] replace the generator's
    draws (tests).

    Returns (state, obs [B, obs_dim], reward [B], done [B])."""
    _check_engine(problem, engine)
    mult, frac = _decode_action(cfg, action)
    temp = torch.clamp(state.temp * mult, cfg.min_temp, cfg.max_temp)
    beta = 1.0 / temp   # per env, on the device

    # in discrete mode every sweep of every env is active: no gate
    gated = cfg.action_mode != "discrete"
    n_active = torch.round(frac * cfg.sweeps_per_step)
    env_axis_last = engine is not None and engine.layout == "nr"
    spins = engine.to_layout(state.spins) if engine is not None else state.spins
    cnt_acc = torch.zeros(cfg.n_envs, dtype=torch.int32, device=spins.device)
    for i in range(cfg.sweeps_per_step):
        # the engines may write the new spins over the old ones: keep a copy
        # for the envs whose sweep budget is spent
        old = spins.clone() if gated else None
        if uniforms is not None:
            new_spins, _, cnt = _uniform_sweep(problem, cfg, engine, spins,
                                               beta, uniforms[i])
        elif engine is not None:
            new_spins, _, cnt = engine.sweep(spins, beta, generator)
        else:
            u = rng.device_uniforms(generator, spins.shape,
                                              spins.device)
            new_spins, _, cnt = sweep_kernels.blocked_sweep(
                problem, spins, beta, u, block_size=cfg.block_size,
                rule=cfg.update_rule)
        if gated:
            active = i < n_active
            act_b = active[None, :] if env_axis_last else active[:, None]
            spins = torch.where(act_b, new_spins, old)
            cnt_acc = cnt_acc + torch.where(active, cnt, torch.zeros_like(cnt))
        else:
            spins = new_spins
            cnt_acc = cnt_acc + cnt
    # exact energies once per env step (one product / sparse pass); the
    # sweeps' dE sums are not tracked, as this replaces them
    if engine is not None:
        energy = engine.energy(spins)
        spins = engine.from_layout(spins)
    else:
        energy = energy_ops.energy(problem, spins)

    n_sweeps_eff = torch.clamp(n_active, min=1.0)
    acc_rate = cnt_acc.to(torch.float32) / (n_sweeps_eff * problem.n_spins)
    improved = energy < state.best_energy - 1e-9
    best = torch.minimum(state.best_energy, energy)
    plateau = torch.where(improved, torch.zeros_like(state.plateau),
                          state.plateau + 1)
    new_step = state.step + 1

    reward, rstate = reward_mod.compute(
        cfg.reward, state.reward_state,
        energy=energy, prev_energy=state.energy, best_energy=best,
        initial_energy=state.initial_energy, acc_rate=acc_rate,
        temp=temp, step=new_step, max_steps=cfg.max_steps,
        improved=improved, mult=mult, episode=state.episode)
    done = (new_step >= cfg.max_steps) | (plateau >= cfg.plateau_patience)
    new_state = state.replace(
        spins=spins, energy=energy, best_energy=best,
        prev_energy=state.energy, temp=temp, acc_rate=acc_rate,
        step=new_step, plateau=plateau, reward_state=rstate, done=done)
    return new_state, observe(problem, cfg, new_state, engine), reward, done


def obs_dim(problem, cfg: EnvConfig) -> int:
    """Static observation width for (problem, cfg)."""
    if cfg.obs_mode == "spins":
        return int(problem.n_padded) + OBS_DIM
    if cfg.obs_mode == "global":
        return OBS_DIM
    raise ValueError(f"obs_mode must be 'global' or 'spins', "
                     f"got {cfg.obs_mode!r}")


def observe(problem, cfg: EnvConfig, state: EnvState,
            engine=None) -> torch.Tensor:
    """[B, obs_dim] features. obs_mode="global": the 16 global features;
    obs_mode="spins": the spin vector (padding slots zeroed) followed by
    those 16. The energy z-score is over the env batch (population
    statistics: the deviation divides by B); where the envs are sharded
    over ranks (an ``engine`` with ``gather_envs``, ``distributed``'s
    sharded engines) over all ranks' envs, as GSPMD reduces over the whole
    sharded batch in the JAX package."""
    e0 = torch.abs(state.initial_energy) + 1e-8
    de = state.energy - state.prev_energy
    mag = energy_ops.magnetization(problem, state.spins)
    batch = (engine.gather_envs(state.energy)
             if hasattr(engine, "gather_envs") else state.energy)
    zstat = (state.energy - torch.mean(batch)) / (
        torch.std(batch, correction=0) + 1e-8)
    log_t = torch.log10(torch.clamp(state.temp, min=1e-8))
    feats = [
        state.energy / e0,
        state.best_energy / e0,
        de / e0,
        log_t,
        state.acc_rate,
        state.step.to(torch.float32) / cfg.max_steps,
        mag,
        zstat,
        state.plateau.to(torch.float32) / cfg.plateau_patience,
        (state.energy - state.best_energy) / e0,
        torch.tanh(state.energy / e0),
        torch.abs(mag),
        state.acc_rate - 0.44,
        log_t / 3.0,
        torch.ones_like(mag),
        torch.zeros_like(mag),
    ]
    glob = torch.stack(feats, dim=-1)
    if cfg.obs_mode == "spins":
        spins = state.spins.to(torch.float32) * problem.active_mask[None, :]
        return torch.cat([spins, glob], dim=-1)
    return glob


def auto_reset(problem, cfg: EnvConfig, state: EnvState,
               generator: torch.Generator, engine=None,
               spins: Optional[torch.Tensor] = None
               ) -> Tuple[EnvState, torch.Tensor]:
    """Reset only the done trajectories. Every env is reset and the mix is
    picked by ``done`` on the device, so nothing branches on the host; the
    episode counter survives a reset (it counts completed episodes).
    ``spins`` [B, Np] replace the fresh state's drawn start spins (tests)."""
    fresh = _fresh_state(problem, cfg, generator, engine, spins)
    done = state.done
    fresh = fresh.replace(episode=state.episode + done.to(torch.int32))

    def pick(f, s):
        if dataclasses.is_dataclass(s):
            return type(s)(**{fld.name: pick(getattr(f, fld.name),
                                             getattr(s, fld.name))
                              for fld in dataclasses.fields(s)})
        return torch.where(done.reshape((-1,) + (1,) * (s.ndim - 1)), f, s)

    mixed = pick(fresh, state)
    return mixed, observe(problem, cfg, mixed, engine)


def default_engine(problem, cfg: EnvConfig):
    """The env's sweep engine, from ``make_engine``: K1 for a dense problem
    on the card, the sorted sparse engines for an ``EllProblem`` (the env
    count is the replica hint, so on the card the transposed engine and its
    kernels run from 16 envs), the blocked sweep on the CPU."""
    from spinglass_tpu_torch.anneal.engines import make_engine

    return make_engine(problem, update_rule=cfg.update_rule,
                       block_size=cfg.block_size, r_hint=cfg.n_envs)
