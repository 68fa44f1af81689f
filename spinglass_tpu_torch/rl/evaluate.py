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

A policy is a function (obs [B, obs_dim], host generator) -> actions [B].

Every entry point takes ``engine="auto"`` by default and builds
``env.default_engine``'s engine once for all its rollouts (the kernels on the
card); pass an engine to share one, or None for the plain PyTorch sweep on a
CPU problem.
"""

from __future__ import annotations

import math
import zlib
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from spinglass_tpu_torch.core.rng import device_generator
from spinglass_tpu_torch.rl import env as env_mod
from spinglass_tpu_torch.rl.env import N_ACTIONS, TEMP_MULTIPLIERS, EnvConfig


def welch_t(a, b) -> dict:
    """Welch's t-test with a normal-approximation two-sided p-value (the JAX
    package's ``research.validation.welch_t``; it moves there when that
    module is ported)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    va, vb = a.var(ddof=1), b.var(ddof=1)
    na, nb = len(a), len(b)
    se = math.sqrt(va / na + vb / nb) or 1e-12
    t = (a.mean() - b.mean()) / se
    p = math.erfc(abs(t) / math.sqrt(2.0))
    return {"t": float(t), "p_value": float(p)}


def make_random_policy():
    """Uniform over the discrete temperature-multiplier ladder."""

    def policy(obs, generator):
        return torch.randint(0, N_ACTIONS, (obs.shape[0],), device=obs.device,
                             generator=device_generator(generator, obs.device),
                             dtype=torch.int32)

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


@torch.no_grad()
def rollout_best_energy(problem, env_cfg: EnvConfig, policy: Callable,
                        generator: torch.Generator, engine="auto",
                        n_steps: Optional[int] = None) -> torch.Tensor:
    """One fixed-length episode batch; returns the best energy per env [B].

    No auto-reset and no early exit on a plateau: every controller gets
    exactly n_steps * sweeps_per_step sweeps."""
    n = n_steps or env_cfg.max_steps
    if engine == "auto":
        engine = env_mod.default_engine(problem, env_cfg)
    state, obs = env_mod.reset(problem, env_cfg, generator, engine)
    for _ in range(n):
        action = policy(obs, generator)
        state, obs, _, _ = env_mod.step(problem, env_cfg, state, action,
                                        generator, engine)
    return state.best_energy


def evaluate_controllers(problem, env_cfg: EnvConfig, policies: dict,
                         n_seeds: int = 5, seed: int = 0, engine="auto",
                         n_steps: Optional[int] = None):
    """Roll out each named policy over ``n_seeds`` seeds at equal budget.

    Returns (report, results): results maps a name to its per-seed mean best
    energies; the report adds Welch-t comparisons of every other policy
    against the first-listed one. A policy's seeds are offset by a checksum
    of its name (the JAX package uses Python's ``hash``, which changes from
    process to process)."""
    if engine == "auto":
        engine = env_mod.default_engine(problem, env_cfg)
    results = {}
    for name, policy in policies.items():
        offset = zlib.crc32(name.encode()) % 97
        per_seed = []
        for s in range(n_seeds):
            gen = torch.Generator().manual_seed(seed + 1000 * s + offset)
            e = rollout_best_energy(problem, env_cfg, policy, gen,
                                    engine=engine, n_steps=n_steps)
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
