"""RL controller over the annealer: reward shaping, the vectorised
environment, PPO and its evaluation (the counterpart of
``spinglass_tpu.rl``; DQN, the training pipeline and the gymnasium adapter
are not ported yet)."""
