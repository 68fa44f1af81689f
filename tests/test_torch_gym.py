"""The port's gymnasium adapter (``spinglass_tpu_torch.rl.gym_adapter``)
against the JAX package's (``tests/unit/test_gym_adapter.py``), on the
CPU."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

gymnasium = pytest.importorskip("gymnasium")

from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.rl.env import EnvConfig as JaxEnvConfig  # noqa: E402
from spinglass_tpu.rl.gym_adapter import \
    SpinGlassGymEnv as JaxGymEnv  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.rl import env as fenv  # noqa: E402
from spinglass_tpu_torch.rl.env import EnvConfig  # noqa: E402
from spinglass_tpu_torch.rl.gym_adapter import SpinGlassGymEnv  # noqa: E402

J = topology.fully_connected(24, dist="gaussian", scale=0.2, seed=3)


@pytest.fixture(scope="module")
def problem():
    return IsingProblem.from_dense(J, device="cpu")


def test_passes_gymnasium_env_checker(problem):
    """gymnasium's own checker: spaces, reset/step signatures, determinism
    under a fixed seed, dtypes."""
    from gymnasium.utils.env_checker import check_env

    env = SpinGlassGymEnv(problem, EnvConfig(n_envs=1, sweeps_per_step=2,
                                             max_steps=6))
    check_env(env, skip_render_check=True)


def test_discrete_episode(problem):
    """An episode to its end (max_steps=5), then the flags: truncated by
    the budget, terminated by a plateau, each on its own; a step before
    reset raises; equal seeds give equal episodes."""
    env = SpinGlassGymEnv(problem, EnvConfig(n_envs=1, sweeps_per_step=2,
                                             max_steps=5), seed=0)
    with pytest.raises(RuntimeError, match="reset"):
        env.step(0)
    runs = []
    for _ in range(2):
        obs, info = env.reset(seed=1)
        assert obs.shape == (16,) and obs.dtype == np.float32
        assert np.isfinite(info["energy"]) and info["step"] == 0
        rows = []
        for t in range(5):
            obs, r, terminated, truncated, info = env.step(t % 10)
            rows.append((obs.tolist(), r, terminated, truncated, info))
            if terminated or truncated:
                break
        runs.append(rows)
    assert runs[0] == runs[1]
    _, _, terminated, truncated, info = runs[0][-1]
    assert truncated and info["step"] == 5
    assert info["best_energy"] <= info["energy"] + 1e-6
    env = SpinGlassGymEnv(problem, EnvConfig(
        n_envs=1, sweeps_per_step=1, max_steps=50, plateau_patience=1),
        seed=0)
    env.reset(seed=2)
    flags = [env.step(0)[2:4] for _ in range(12)]   # cooling by 0.5 freezes
    assert any(term and not trunc for term, trunc in flags)


def test_spaces_equal_the_jax_adapters():
    """The three action modes and both observation modes: the spaces equal
    the JAX adapter's."""
    jp = JaxProblem.from_dense(J)
    tp = IsingProblem.from_dense(J, device="cpu")
    for mode in ("discrete", "continuous", "hybrid"):
        for obs_mode in ("global", "spins"):
            kw = dict(n_envs=1, action_mode=mode, obs_mode=obs_mode,
                      sweeps_per_step=2, max_steps=3)
            tenv = SpinGlassGymEnv(tp, EnvConfig(**kw))
            jenv = JaxGymEnv(jp, JaxEnvConfig(**kw))
            assert tenv.observation_space == jenv.observation_space
            assert tenv.action_space == jenv.action_space, mode


def test_continuous_and_hybrid_steps(problem):
    """A continuous step moves the temperature by its multiplier (2.0 x
    1.5); a hybrid step takes a dict action."""
    env = SpinGlassGymEnv(problem, EnvConfig(
        n_envs=1, action_mode="continuous", sweeps_per_step=2, max_steps=4),
        seed=0)
    env.reset(seed=2)
    obs, r, _, _, info = env.step(np.array([1.5, 0.5], np.float32))
    assert obs.shape == (16,) and np.isfinite(r)
    assert info["temperature"] == pytest.approx(3.0, rel=1e-6)
    env = SpinGlassGymEnv(problem, EnvConfig(
        n_envs=1, action_mode="hybrid", sweeps_per_step=2, max_steps=4))
    env.reset(seed=3)
    obs, r, _, _, info = env.step({"temp_index": 2,
                                   "sweep_frac": np.array([0.5], np.float32)})
    assert info["temperature"] == pytest.approx(2.0 * 0.8, rel=1e-6)


def test_batched_cfg_coerced_to_single(problem):
    env = SpinGlassGymEnv(problem, EnvConfig(n_envs=32, max_steps=3))
    assert env.cfg.n_envs == 1
    obs, _ = env.reset(seed=0)
    assert obs.shape == (16,)


def test_spins_obs_mode_widens_space(problem):
    cfg = EnvConfig(n_envs=1, obs_mode="spins", sweeps_per_step=2,
                    max_steps=3)
    env = SpinGlassGymEnv(problem, cfg, seed=0)
    want = fenv.obs_dim(problem, cfg)
    assert env.observation_space.shape == (want,) == (problem.n_padded + 16,)
    obs, _ = env.reset(seed=1)
    assert obs.shape == (want,)
    assert set(np.unique(obs[:problem.n_spins])) <= {-1.0, 1.0}
    assert not obs[problem.n_spins:problem.n_padded].any()
    obs2, r, term, trunc, info = env.step(0)
    assert obs2.shape == (want,)


def test_episode_core_equals_the_adapter_and_needs_no_gymnasium(problem):
    """``SpinGlassEpisode`` (the adapter's reset and step without
    gymnasium) gives the adapter's episode under one seed; with gymnasium
    unimportable the module still imports, the episode runs and the
    adapter raises ImportError."""
    import os
    import pathlib
    import subprocess
    import sys

    from spinglass_tpu_torch.rl.gym_adapter import SpinGlassEpisode

    cfg = EnvConfig(n_envs=1, sweeps_per_step=2, max_steps=4)
    runs = []
    for cls in (SpinGlassGymEnv, SpinGlassEpisode):
        e = cls(problem, cfg)
        rows = [e.reset(seed=7)[0].tolist()]
        rows += [(o.tolist(), *rest) for o, *rest in
                 (e.step(a) for a in (1, 8, 3, 0))]
        runs.append(rows)
    assert runs[0] == runs[1]
    script = (
        "import sys\n"
        "sys.modules['gymnasium'] = None\n"
        "import numpy as np, torch\n"
        "from spinglass_tpu_torch.core.problem import IsingProblem\n"
        "from spinglass_tpu_torch.rl.env import EnvConfig\n"
        "from spinglass_tpu_torch.rl import gym_adapter as G\n"
        "p = IsingProblem.from_dense(np.ones((8, 8)) - np.eye(8), device='cpu')\n"
        "e = G.SpinGlassEpisode(p, EnvConfig(n_envs=1, max_steps=2))\n"
        "e.reset(seed=0)\n"
        "assert e.step(0)[0].shape == (16,)\n"
        "try:\n"
        "    G.SpinGlassGymEnv(p)\n"
        "except ImportError:\n"
        "    print('refused')\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=240,
                          env=dict(os.environ, PYTHONPATH=str(root),
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "refused"
