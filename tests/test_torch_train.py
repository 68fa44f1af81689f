"""The port's RL training pipeline (``spinglass_tpu_torch.rl.train``) and
``sgt-torch train-rl``, against the JAX package's pipeline tests
(``tests/unit/test_rl.py`` ``TestPipeline``, ``TestRLCheckpointResume``) at
the same small sizes, on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from click.testing import CliRunner  # noqa: E402

from spinglass_tpu.rl import train as jtrain  # noqa: E402
from spinglass_tpu_torch import cli  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.rl import dqn as D  # noqa: E402
from spinglass_tpu_torch.rl import ppo as P  # noqa: E402
from spinglass_tpu_torch.rl import train as T  # noqa: E402
from spinglass_tpu_torch.rl.env import EnvConfig  # noqa: E402

ENV = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=6)
PPO = P.PPOConfig(rollout_len=3, n_epochs=1, n_minibatches=1,
                  hidden_sizes=(16,))
DQN = D.DQNConfig(hidden_sizes=(8,), batch_size=4, buffer_size=32)


def _problem(n=16, seed=0):
    j = topology.fully_connected(n, dist="gaussian", scale=1 / np.sqrt(n),
                                 seed=seed)
    return IsingProblem.from_dense(j, device="cpu")


def test_default_problem_is_the_jax_packages_sk_glass():
    p = T.default_problem(24, seed=3, device="cpu")
    jp = jtrain.default_problem(24, seed=3)
    np.testing.assert_array_equal(p.j.numpy(), np.asarray(jp.j))
    assert p.n_spins == 24 and p.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.default_problem(8)
    assert dataclasses.asdict(T.TrainingConfig()) == dataclasses.asdict(
        jtrain.TrainingConfig())


def test_ppo_pipeline_smoke(tmp_path):
    """The JAX smoke: 2 updates, a checkpoint after each; the JAX file
    names (``params_s0_u{u}.npz``, ``metrics.json``) and the full state."""
    pipe = T.RLTrainingPipeline(
        T.TrainingConfig(agent="ppo", n_updates=2, checkpoint_interval=1,
                         checkpoint_dir=str(tmp_path)),
        env_cfg=ENV, ppo_cfg=PPO, problem=_problem())
    out = pipe.train()
    assert out["env_steps_per_second"] > 0
    assert [(m["stage"], m["update"]) for m in out["metrics"]] == [(0, 0),
                                                                  (0, 1)]
    assert set(out["metrics"][0]) == {"stage", "update", *P.METRIC_KEYS}
    assert sorted(os.listdir(tmp_path)) == [
        "metrics.json", "params_s0_u0.npz", "params_s0_u1.npz",
        "train_state_s0.pt"]
    with open(tmp_path / "metrics.json") as f:
        assert json.load(f) == out["metrics"]
    loaded = D.load_params(out["params"], str(tmp_path / "params_s0_u1.npz"))
    assert all(torch.equal(loaded[k], out["params"][k].detach())
               for k in loaded)


@pytest.mark.parametrize("kd", [1, 2])
def test_dqn_pipeline_smoke(kd):
    """The JAX smoke (2 updates), and steps_per_dispatch: 5 updates at
    k=2 (two blocks, then a single) record the rows of 5 single steps."""
    n = 2 if kd == 1 else 5
    pipe = T.RLTrainingPipeline(
        T.TrainingConfig(agent="dqn", n_updates=n), env_cfg=ENV,
        dqn_cfg=dataclasses.replace(DQN, steps_per_dispatch=kd),
        problem=_problem())
    out = pipe.train()
    assert len(out["metrics"]) == n
    assert set(out["metrics"][0]) == {"stage", "update", *D.METRIC_KEYS}
    if kd > 1:
        one = T.RLTrainingPipeline(
            T.TrainingConfig(agent="dqn", n_updates=n), env_cfg=ENV,
            dqn_cfg=DQN, problem=_problem()).train()
        assert one["metrics"] == out["metrics"]
        assert all(torch.equal(one["params"][k], out["params"][k])
                   for k in out["params"])


@pytest.mark.parametrize("agent", ["ppo", "dqn"])
def test_curriculum_stages_carry_the_parameters(agent, tmp_path,
                                                monkeypatch):
    """curriculum_sizes (8, 12, 16): three stages of n_updates // 3 updates
    on default problems of those sizes (problem_seed + stage); each stage
    starts from the previous stage's last parameters (DQN: its target
    network too), which its checkpoint holds; checkpoints named by stage,
    the full state for PPO only."""
    cfg = T.TrainingConfig(agent=agent, n_updates=7, curriculum=True,
                           curriculum_sizes=(8, 12, 16), problem_seed=4,
                           checkpoint_interval=2,
                           checkpoint_dir=str(tmp_path))
    pipe = T.RLTrainingPipeline(cfg, ENV, PPO, DQN, device="cpu")
    probs = pipe._problems()
    assert [p.n_spins for p in probs] == [8, 12, 16]
    np.testing.assert_array_equal(
        probs[2].j.numpy(), T.default_problem(16, 6, "cpu").j.numpy())
    copies = []
    real = T._copy_params

    def recording(dst, src):
        copies.append({k: v.detach().clone() for k, v in src.items()})
        real(dst, src)
        assert all(torch.equal(dst[k], src[k]) for k in dst)

    monkeypatch.setattr(T, "_copy_params", recording)
    out = pipe.train()
    assert [(m["stage"], m["update"]) for m in out["metrics"]] == [
        (s, u) for s in range(3) for u in range(2)]
    files = sorted(os.listdir(tmp_path))
    assert [f for f in files if f.startswith("params")] == [
        "params_s0_u1.npz", "params_s1_u1.npz", "params_s2_u1.npz"]
    assert ("train_state_s2.pt" in files) == (agent == "ppo")
    per_stage = 2 if agent == "dqn" else 1   # params (and target)
    assert len(copies) == 2 * per_stage
    for i, src in enumerate(copies):
        stage = i // per_stage
        saved = D.load_params(src, str(tmp_path / f"params_s{stage}_u1.npz"))
        assert all(torch.equal(saved[k], src[k]) for k in src)


def _resume_cfg(d, n, resume=False):
    return T.TrainingConfig(agent="ppo", n_updates=n, checkpoint_interval=2,
                            checkpoint_dir=d, seed=3, resume=resume)


def test_ppo_resume_equals_the_uninterrupted_run(tmp_path):
    """A run of 2 updates saves its full state at update 1; a resumed run
    of 4 continues there and equals an uninterrupted run of 4 bit for bit
    (metrics of updates 2-3, parameters). Resumed again after the end, it
    trains nothing and keeps the parameters, as the JAX test asserts."""
    env_cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8)
    cfg = P.PPOConfig(rollout_len=2, n_epochs=1, n_minibatches=1,
                      hidden_sizes=(16,))
    p = _problem()
    full = T.RLTrainingPipeline(_resume_cfg(str(tmp_path / "a"), 4),
                                env_cfg, cfg, problem=p).train()
    d = str(tmp_path / "b")
    T.RLTrainingPipeline(_resume_cfg(d, 2), env_cfg, cfg, problem=p).train()
    pipe = T.RLTrainingPipeline(_resume_cfg(d, 4, resume=True), env_cfg, cfg,
                                problem=p)
    resumed = pipe.train()
    assert [m["update"] for m in resumed["metrics"]] == [2, 3]
    assert resumed["metrics"] == full["metrics"][2:]
    for k, v in full["params"].items():
        assert torch.equal(resumed["params"][k], v), k
    again = T.RLTrainingPipeline(_resume_cfg(d, 4, resume=True), env_cfg, cfg,
                                 problem=p)
    out = again.train()
    assert again.metrics == []
    for k, v in full["params"].items():
        assert torch.equal(out["params"][k], v), k


@pytest.mark.parametrize("agent", ["ppo", "dqn"])
def test_train_rl_command_on_the_cpu(agent, tmp_path):
    """``sgt-torch --device cpu train-rl`` with the JAX command's options:
    exit 0, the rate line, the verbose rows, and the checkpoints."""
    d = str(tmp_path / "ck")
    out = CliRunner().invoke(cli.main, [
        "--device", "cpu", "train-rl", "--agent", agent, "--updates", "2",
        "--envs", "4", "--spins", "12", "--checkpoint-dir", d])
    assert out.exit_code == 0, out.output
    assert "env-steps/s:" in out.output and "'update': 0" in out.output
    assert not os.path.exists(d)   # the interval (50) is not reached
