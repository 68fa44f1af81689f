"""Controller evaluation: does the trained policy help?

The counterpart of ``spinglass_tpu.rl.evaluate``. The trained PPO controller
is rolled out against two schedule baselines at an equal total sweep budget:

  * random policy: uniform over the temperature-multiplier ladder (a
    zero-drift random walk in log T, which anneals poorly);
  * fixed geometric: the constant multiplier whose per-step ratio best
    matches a geometric schedule from the initial temperature to
    ``target_temp`` over the episode;

and the per-seed mean best energies are compared with Welch's t-test.
Every rollout is a fixed number of env steps without auto-reset, so every
controller gets the same number of sweeps.

A policy is a function (obs [B, obs_dim], host generator) -> actions [B];
it draws through ``core.rng``. An episode runs as the policy's step (its
action, then ``env.step``) captured once (``graphs.CapturedStep``) and
replayed ``n_steps`` times; ``evaluate_controllers`` captures each policy's
step once and loads every seed's start state into it. A captured episode
equals the eager loop of that step (``benchmarks.headline.eager_rollout``)
bit for bit under one seed.

Every entry point takes ``engine="auto"`` by default and builds
``env.default_engine``'s engine once for all its rollouts (the kernels on the
card); pass an engine to share one, or None for the plain PyTorch sweep on a
CPU problem.
"""

from __future__ import annotations

import zlib
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.core.rng import device_generator, randint
from spinglass_tpu_torch.research.validation import welch_t
from spinglass_tpu_torch.rl import env as env_mod
from spinglass_tpu_torch.rl.env import N_ACTIONS, TEMP_MULTIPLIERS, EnvConfig


def make_random_policy():
    """Uniform over the discrete temperature-multiplier ladder."""

    def policy(obs, generator):
        return randint(device_generator(generator, obs.device), N_ACTIONS,
                       (obs.shape[0],), obs.device).to(torch.int32)

    return policy


def geometric_action_index(env_cfg: EnvConfig, target_temp: float,
                           n_steps: Optional[int] = None) -> int:
    """The ladder index whose multiplier best matches the per-step ratio of
    a geometric schedule initial_temp -> target_temp over n_steps."""
    n = n_steps or env_cfg.max_steps
    t0 = env_cfg.initial_temp
    if env_cfg.init_temp_range is not None:
        lo, hi = env_cfg.init_temp_range
        t0 = float(np.sqrt(lo * hi))  # geometric-mean start: the best a
        # fixed schedule can do against a log-uniform randomised start
    ratio = (target_temp / t0) ** (1.0 / max(n, 1))
    return int(np.argmin(np.abs(np.asarray(TEMP_MULTIPLIERS) - ratio)))


def make_geometric_policy(env_cfg: EnvConfig, target_temp: float = 0.05,
                          n_steps: Optional[int] = None):
    """Constant-action policy implementing the geometric baseline."""
    idx = geometric_action_index(env_cfg, target_temp, n_steps)

    def policy(obs, generator):
        return torch.full((obs.shape[0],), idx, dtype=torch.int32,
                          device=obs.device)

    return policy


def make_ppo_policy(model, params, greedy: bool = True):
    """Policy closure over a trained ``ActorCritic``'s parameters (discrete
    mode)."""
    from spinglass_tpu_torch.rl.ppo import make_policy

    sample, _, _ = make_policy("discrete")

    @torch.no_grad()
    def policy(obs, generator):
        dist, _ = functional_call(model, params, (obs,))
        if greedy:
            return torch.argmax(dist["logits"], dim=-1).to(torch.int32)
        return sample(dist, generator).to(torch.int32)

    return policy


def episode_step(problem, env_cfg: EnvConfig, policy: Callable, engine):
    """One step of an evaluation episode on a state {"env_state", "obs",
    "generator"}: the policy's action, then ``env.step`` (no auto-reset).
    Returns (state, None), the form ``graphs.CapturedStep`` replays."""
    def step(st):
        gen = st["generator"]
        action = policy(st["obs"], gen)
        env_state, obs, _, _ = env_mod.step(problem, env_cfg, st["env_state"],
                                            action, gen, engine)
        return {"env_state": env_state, "obs": obs, "generator": gen}, None

    return step


@torch.no_grad()
@graphs.serialized
def _episode(problem, env_cfg: EnvConfig, policy: Callable, engine,
             generator: torch.Generator, n: int, captured=None):
    """One fixed-length episode batch through ``policy``'s captured step:
    the reset drawn from ``generator``, the step captured on it (or its
    start state loaded into ``captured``) and replayed ``n`` times. Returns
    (the captured step, the best energy per env [B], a copy)."""
    env_state, obs = env_mod.reset(problem, env_cfg, generator, engine)
    start = {"env_state": env_state, "obs": obs, "generator": generator}
    if captured is None:
        captured = graphs.CapturedStep(
            episode_step(problem, env_cfg, policy, engine), start, generator)
    else:
        captured.load(start)
    for _ in range(n):
        captured.replay(generator)
    return captured, captured.state["env_state"].best_energy.clone()


def rollout_best_energy(problem, env_cfg: EnvConfig, policy: Callable,
                        generator: torch.Generator, engine="auto",
                        n_steps: Optional[int] = None) -> torch.Tensor:
    """One fixed-length episode batch; returns the best energy per env [B].

    No auto-reset and no early exit on a plateau: every controller gets
    exactly n_steps * sweeps_per_step sweeps."""
    if engine == "auto":
        engine = env_mod.default_engine(problem, env_cfg)
    _, best = _episode(problem, env_cfg, policy, engine, generator,
                       n_steps or env_cfg.max_steps)
    return best


def seed_generator(name: str, seed: int, s: int) -> torch.Generator:
    """The host generator of seed ``s`` of the policy ``name``: its seeds
    are offset by a checksum of its name (the JAX package uses Python's
    ``hash``, which changes from process to process)."""
    offset = zlib.crc32(name.encode()) % 97
    return torch.Generator().manual_seed(seed + 1000 * s + offset)


def evaluate_controllers(problem, env_cfg: EnvConfig, policies: dict,
                         n_seeds: int = 5, seed: int = 0, engine="auto",
                         n_steps: Optional[int] = None):
    """Roll out each named policy over ``n_seeds`` seeds at equal budget
    (``seed_generator``), its episode step captured once for all its seeds.

    Returns (report, results): results maps a name to its per-seed mean best
    energies; the report adds Welch-t comparisons of every other policy
    against the first-listed one."""
    if engine == "auto":
        engine = env_mod.default_engine(problem, env_cfg)
    n = n_steps or env_cfg.max_steps
    results = {}
    for name, policy in policies.items():
        captured, per_seed = None, []
        for s in range(n_seeds):
            captured, e = _episode(problem, env_cfg, policy, engine,
                                   seed_generator(name, seed, s), n, captured)
            per_seed.append(float(torch.mean(e)))
        results[name] = np.asarray(per_seed)

    names = list(policies)
    report = {"mean_best_energy": {k: float(v.mean())
                                   for k, v in results.items()},
              "per_seed": {k: v.tolist() for k, v in results.items()}}
    first = names[0]
    for other in names[1:]:
        t = welch_t(results[first], results[other])
        t["first_better"] = bool(results[first].mean()
                                 < results[other].mean())
        report[f"{first}_vs_{other}"] = t
    return report, results


def learning_report(problem, env_cfg: Optional[EnvConfig] = None,
                    ppo_cfg=None, n_seeds: int = 5,
                    target_temp: float = 0.05, engine="auto",
                    verbose: bool = False) -> dict:
    """Train PPO, then compare the trained, geometric and random
    controllers. The returned dict carries per-seed energies, Welch-t
    p-values and the training throughput (env_steps_per_second)."""
    from spinglass_tpu_torch.rl import ppo as ppo_mod

    env_cfg = env_cfg or EnvConfig()
    ppo_cfg = ppo_cfg or ppo_mod.PPOConfig()
    if engine == "auto":   # one engine for the training and the evaluation
        engine = env_mod.default_engine(problem, env_cfg)
    out = ppo_mod.train(problem, env_cfg, ppo_cfg, verbose=verbose,
                        engine=engine)
    model = ppo_mod.ActorCritic(
        env_mod.obs_dim(problem, env_cfg), action_mode=env_cfg.action_mode,
        n_actions=N_ACTIONS, hidden_sizes=ppo_cfg.hidden_sizes
    ).to(problem.device)
    policies = {
        "trained_ppo": make_ppo_policy(model, out["params"]),
        "geometric": make_geometric_policy(env_cfg, target_temp),
        "random": make_random_policy(),
    }
    report, _ = evaluate_controllers(problem, env_cfg, policies,
                                     n_seeds=n_seeds, engine=engine)
    report["env_steps_per_second"] = out["env_steps_per_second"]
    report["n_updates"] = len(out["history"])
    report["learning_curve"] = [h["mean_best_energy"] for h in out["history"]]
    return report
