"""RL controller over the annealer: reward shaping, the vectorised
environment, PPO, the hybrid DQN, the training pipeline and evaluation (the
counterpart of ``spinglass_tpu.rl``; the gymnasium adapter is
``rl.gym_adapter``, imported on its own, as in the JAX package)."""

from spinglass_tpu_torch.rl.env import EnvConfig, EnvState, reset, step, observe
from spinglass_tpu_torch.rl.rewards import RewardConfig
from spinglass_tpu_torch.rl.ppo import PPOConfig, ActorCritic, make_ppo, train
from spinglass_tpu_torch.rl.dqn import (DQNConfig, PrioritizedReplayBuffer,
                                        QNetwork, ReplayBuffer, make_dqn)
from spinglass_tpu_torch.rl.train import TrainingConfig, RLTrainingPipeline
