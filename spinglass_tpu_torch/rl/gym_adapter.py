"""Gymnasium adapter for the vectorised annealing environment.

The counterpart of ``spinglass_tpu.rl.gym_adapter``: a single-instance
``gymnasium.Env`` over ``rl.env`` (``n_envs`` forced to 1), so that outside
RL libraries can drive the annealer. Each ``step`` is one eager
``env.step`` on the problem's device (on the card: K1 at R=1 for a dense
problem; for an ``EllProblem`` the engine ``make_engine`` picks at one
replica), and its host reads are the gym API's own: the observation, the
reward, the two flags and ``info``. For throughput use the batched env.

``reset(seed=)`` seeds a host ``torch.Generator``, from which every draw of
the episode is made (``core.rng``). ``SpinGlassEpisode`` is the same
episode without gymnasium (no spaces): the adapter runs its ``reset`` and
``step``.

Termination: a plateau of ``plateau_patience`` steps -> ``terminated`` (the
episode's absorbing state); the step budget -> ``truncated`` (gymnasium's
time-limit convention). The two are independent and may both hold.

``gymnasium`` is imported when this module is, and only then: the rest of
the package never imports this module, and without gymnasium the module
imports, ``SpinGlassEpisode`` runs, and ``SpinGlassGymEnv`` raises
ImportError when built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from spinglass_tpu_torch.rl import env as fenv

try:
    import gymnasium
    from gymnasium import spaces
except ImportError as _e:  # pragma: no cover - gymnasium is optional
    gymnasium = None
    _gym_err = _e


def _require_gym():
    if gymnasium is None:  # pragma: no cover
        raise ImportError(
            "gymnasium is required for SpinGlassGymEnv; the batched env "
            "(spinglass_tpu_torch.rl.env) has no such dependency"
        ) from _gym_err


class SpinGlassEpisode:
    """One annealing episode on a fixed problem, one env (``n_envs`` forced
    to 1), with the gymnasium API's ``reset`` and ``step``: the part of
    ``SpinGlassGymEnv`` that needs no gymnasium (it adds the spaces and
    gymnasium's seeding). ``engine``: "auto" builds ``env.default_engine``'s
    for one env, or pass a sweep engine (None: the plain sweep of a problem
    on the CPU)."""

    def __init__(self, problem, cfg: Optional[fenv.EnvConfig] = None,
                 engine="auto", seed: Optional[int] = None):
        if cfg is None:
            cfg = fenv.EnvConfig(n_envs=1)
        if cfg.n_envs != 1:   # single-env semantics: the batched API
            cfg = dataclasses.replace(cfg, n_envs=1)   # serves n_envs > 1
        self.problem = problem
        self.cfg = cfg
        self._engine = (fenv.default_engine(problem, cfg)
                        if engine == "auto" else engine)
        self._device = problem.device
        self._gen = torch.Generator().manual_seed(0 if seed is None else seed)
        self._state = None

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        if seed is not None:
            self._gen = torch.Generator().manual_seed(seed)
        self._state, obs = fenv.reset(self.problem, self.cfg, self._gen,
                                      self._engine)
        return obs[0].cpu().numpy(), self._info()

    def _action(self, action):
        dev = self._device
        if self.cfg.action_mode == "discrete":
            return torch.tensor([int(action)], dtype=torch.int32, device=dev)
        if self.cfg.action_mode == "continuous":
            return torch.tensor(np.asarray(action, np.float32)[None, :],
                                device=dev)
        return {"temp_index": torch.tensor([int(action["temp_index"])],
                                           dtype=torch.int32, device=dev),
                "sweep_frac": torch.tensor(np.asarray(
                    action["sweep_frac"], np.float32).reshape(1),
                    device=dev)}

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        self._state, obs, reward, _ = fenv.step(
            self.problem, self.cfg, self._state, self._action(action),
            self._gen, self._engine)
        truncated = bool(self._state.step[0] >= self.cfg.max_steps)
        terminated = bool(self._state.plateau[0]
                          >= self.cfg.plateau_patience)
        return (obs[0].cpu().numpy(), float(reward[0]), terminated,
                truncated, self._info())

    def _info(self) -> dict:
        s = self._state
        return {
            "energy": float(s.energy[0]),
            "best_energy": float(s.best_energy[0]),
            "temperature": float(s.temp[0]),
            "acceptance_rate": float(s.acc_rate[0]),
            "step": int(s.step[0]),
        }


class SpinGlassGymEnv(SpinGlassEpisode, gymnasium.Env if gymnasium else object):
    """``gymnasium.Env`` over one annealing episode on a fixed problem.

    Observation: ``Box(-inf, inf, (obs_dim,), float32)``: the env's 16
    global features, with the spins before them for ``obs_mode="spins"``.
    Action (by ``cfg.action_mode``):
      discrete   -> ``Discrete(10)`` temperature-multiplier index
      continuous -> ``Box([0.5, 0.1], [2.0, 1.0])`` (temp mult, sweep frac)
      hybrid     -> ``Dict(temp_index=Discrete(10), sweep_frac=Box)``

    ``engine`` as in ``SpinGlassEpisode``, whose ``reset`` and ``step`` this
    class runs."""

    metadata = {"render_modes": []}

    def __init__(self, problem, cfg: Optional[fenv.EnvConfig] = None,
                 engine="auto", seed: Optional[int] = None):
        _require_gym()
        SpinGlassEpisode.__init__(self, problem, cfg, engine, seed)
        cfg = self.cfg
        self.observation_space = spaces.Box(
            -np.inf, np.inf, (fenv.obs_dim(problem, cfg),), np.float32)
        if cfg.action_mode == "discrete":
            self.action_space = spaces.Discrete(fenv.N_ACTIONS)
        elif cfg.action_mode == "continuous":
            self.action_space = spaces.Box(
                low=np.array([0.5, 0.1], np.float32),
                high=np.array([2.0, 1.0], np.float32))
        elif cfg.action_mode == "hybrid":
            self.action_space = spaces.Dict({
                "temp_index": spaces.Discrete(fenv.N_ACTIONS),
                "sweep_frac": spaces.Box(0.1, 1.0, (1,), np.float32),
            })
        else:
            raise ValueError(cfg.action_mode)

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        gymnasium.Env.reset(self, seed=seed)
        return SpinGlassEpisode.reset(self, seed=seed, options=options)

    def render(self) -> Any:  # pragma: no cover - no render modes
        return None
