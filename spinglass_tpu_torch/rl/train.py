"""RL training pipeline: curriculum, metrics, checkpoints.

The counterpart of ``spinglass_tpu.rl.train``: an episode loop with a
curriculum over problem sizes, a metrics row per update, JSON metrics and a
checkpoint cadence, around the learners' captured steps. The learner is PPO
(``rl.ppo``, replayed through ``ppo.CapturedUpdates``, one update per read)
by default, or the hybrid DQN (``rl.dqn``, replayed through
``dqn.CapturedSteps``, ``steps_per_dispatch`` steps per read, the remainder
as single steps after the blocks). Each stage starts from the previous
stage's parameters (DQN's target network too).

Checkpoints, every ``checkpoint_interval`` updates: ``params_s{stage}_u{
update}.npz`` (``dqn.save_params``: the JAX package's format),
``metrics.json`` and, for PPO, the full training state (parameters, Adam's
state, env state, observation, generator) through
``utils.checkpoint.save_pytree`` as ``train_state_s{stage}.pt`` (the JAX
package writes its ``save_pytree`` format to ``train_state_s{stage}.npz``).
``resume`` continues PPO from it, and a resumed run equals the
uninterrupted one bit for bit; DQN does not resume, as in the JAX package.

Default problems (no ``problem`` given) are SK glasses built on the card
unless ``device`` names another.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from spinglass_tpu_torch.core import topology
from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.rl import dqn as dqn_mod
from spinglass_tpu_torch.rl import ppo as ppo_mod
from spinglass_tpu_torch.rl.env import EnvConfig
from spinglass_tpu_torch.utils.checkpoint import load_pytree, save_pytree


@dataclass(frozen=True)
class TrainingConfig:
    agent: str = "ppo"                    # ppo | dqn
    n_updates: int = 100
    eval_interval: int = 20               # verbose: print every k-th row
    checkpoint_interval: int = 50
    checkpoint_dir: Optional[str] = None
    resume: bool = False                  # restore the latest PPO state
    curriculum: bool = False
    curriculum_sizes: tuple = (32, 64, 128)
    problem_seed: int = 0
    seed: int = 0


def default_problem(n_spins: int, seed: int = 0, device=None) -> IsingProblem:
    """The SK glass of the pipeline: Gaussian couplings of scale
    1/sqrt(n_spins), on the card unless ``device`` names another."""
    j = topology.fully_connected(n_spins, dist="gaussian",
                                 scale=1.0 / np.sqrt(n_spins), seed=seed)
    return IsingProblem.from_dense(j, device=device)


def _copy_params(dst: dict, src: dict) -> None:
    with torch.no_grad():
        for name, p in dst.items():
            p.copy_(src[name])


def _adam_tree(state: ppo_mod.TrainState) -> list:
    """Adam's state of each parameter, in the parameters' order, zeros where
    it has not stepped yet (on the device where Adam would make them)."""
    opt = state.opt
    step_device = None if opt.defaults.get("capturable") else "cpu"
    out = []
    for p in state.params.values():
        st = opt.state.get(p, {})
        out.append({
            "step": st.get("step", torch.zeros(
                (), device=step_device or p.device)),
            "exp_avg": st.get("exp_avg", torch.zeros_like(p.detach())),
            "exp_avg_sq": st.get("exp_avg_sq", torch.zeros_like(p.detach()))})
    return out


def _full_tree(state: ppo_mod.TrainState) -> dict:
    return {"params": state.params, "adam": _adam_tree(state),
            "env_state": state.env_state, "obs": state.obs,
            "generator": state.generator}


class RLTrainingPipeline:
    """Host-side orchestration around the learners' captured steps."""

    def __init__(self, cfg: Optional[TrainingConfig] = None,
                 env_cfg: Optional[EnvConfig] = None,
                 ppo_cfg: Optional[ppo_mod.PPOConfig] = None,
                 dqn_cfg: Optional[dqn_mod.DQNConfig] = None,
                 problem=None, device=None):
        self.cfg = cfg or TrainingConfig()
        self.env_cfg = env_cfg or EnvConfig()
        self.ppo_cfg = ppo_cfg or ppo_mod.PPOConfig(
            n_updates=self.cfg.n_updates)
        self.dqn_cfg = dqn_cfg or dqn_mod.DQNConfig()
        self.problem = problem
        self.device = device
        self.metrics: list = []

    def _problems(self) -> list:
        if self.problem is not None:
            return [self.problem]
        sizes = self.cfg.curriculum_sizes if self.cfg.curriculum else (64,)
        return [default_problem(n, self.cfg.problem_seed + i, self.device)
                for i, n in enumerate(sizes)]

    def train(self, verbose: bool = False) -> dict:
        if self.cfg.agent not in ("ppo", "dqn"):
            raise ValueError(self.cfg.agent)
        t0 = time.perf_counter()
        problems = self._problems()
        updates_per_stage = max(1, self.cfg.n_updates // len(problems))
        params = None
        env_steps = 0
        for stage, problem in enumerate(problems):
            run = self._ppo_stage if self.cfg.agent == "ppo" else self._dqn_stage
            params, steps = run(stage, problem, params, updates_per_stage,
                                verbose)
            env_steps += steps
        total = time.perf_counter() - t0
        return {
            "params": params,
            "metrics": self.metrics,
            "env_steps_per_second": env_steps / total if total > 0 else 0.0,
            "total_time": total,
        }

    def _ppo_stage(self, stage, problem, params, n, verbose):
        init_fn, update_fn, _ = ppo_mod.make_ppo(problem, self.env_cfg,
                                                 self.ppo_cfg)
        state = init_fn(torch.Generator().manual_seed(self.cfg.seed + stage))
        if params is not None:
            _copy_params(state.params, params)
        u0 = 0
        if self.cfg.resume and self.cfg.checkpoint_dir:
            restored = self._restore_full(stage, state)
            if restored is not None:
                state, u0 = restored
        if u0 >= n:
            return state.params, 0
        captured = ppo_mod.CapturedUpdates(update_fn, state)
        for u in range(u0, n):
            captured.replay()
            self._record(stage, u, captured.read(1)[0], verbose)
            self._maybe_checkpoint(stage, u, captured.state.params,
                                   full_state=captured.state)
        steps = (n - u0) * self.ppo_cfg.rollout_len * self.env_cfg.n_envs
        return captured.state.params, steps

    def _dqn_stage(self, stage, problem, params, n, verbose):
        init_fn, step_fn, _ = dqn_mod.make_dqn(problem, self.env_cfg,
                                               self.dqn_cfg)
        state = init_fn(torch.Generator().manual_seed(self.cfg.seed + stage))
        if params is not None:
            _copy_params(state.params, params)
            _copy_params(state.target_params, params)
        kd = max(1, self.dqn_cfg.steps_per_dispatch)
        captured = dqn_mod.CapturedSteps(step_fn, state, kd)
        u = 0
        while u < n:
            k = kd if kd > 1 and n - u >= kd else 1
            for _ in range(k):
                captured.replay()
            for i, row in enumerate(captured.read(k)):
                self._record(stage, u + i, row, verbose)
            u += k
            self._maybe_checkpoint(stage, u - 1, captured.state.params)
        return captured.state.params, n * self.env_cfg.n_envs

    def _record(self, stage, update, metrics, verbose):
        row = {"stage": stage, "update": update,
               **{k: float(v) for k, v in metrics.items()}}
        self.metrics.append(row)
        if verbose and update % self.cfg.eval_interval == 0:
            print(row)

    def _maybe_checkpoint(self, stage, update, params, full_state=None):
        d = self.cfg.checkpoint_dir
        if d and (update + 1) % self.cfg.checkpoint_interval == 0:
            os.makedirs(d, exist_ok=True)
            dqn_mod.save_params(
                params, os.path.join(d, f"params_s{stage}_u{update}.npz"))
            if full_state is not None:
                save_pytree({"state": _full_tree(full_state),
                             "update": update},
                            os.path.join(d, f"train_state_s{stage}.pt"))
            with open(os.path.join(d, "metrics.json"), "w") as f:
                json.dump(self.metrics, f)

    def _restore_full(self, stage, state: ppo_mod.TrainState):
        """The stage's latest PPO training state loaded into ``state`` (its
        parameters and optimizer, so the optimizer keeps stepping them) and
        the update to continue from; None without a checkpoint."""
        path = os.path.join(self.cfg.checkpoint_dir,
                            f"train_state_s{stage}.pt")
        if not os.path.exists(path):
            return None
        tree = load_pytree({"state": _full_tree(state), "update": 0}, path)
        saved = tree["state"]
        _copy_params(state.params, saved["params"])
        for p, adam in zip(state.params.values(), saved["adam"]):
            state.opt.state[p] = dict(adam)
        update = tree["update"] + 1
        return ppo_mod.TrainState(
            params=state.params, opt=state.opt, env_state=saved["env_state"],
            obs=saved["obs"], generator=saved["generator"],
            update=update), update
