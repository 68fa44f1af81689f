"""The env's and PPO's own device time per batch env step: every kernel but
the sweep kernel (decode, layouts, energies, rewards, observations, resets,
the policy's passes, GAE, the minibatch steps and Adam)."""

from portbench.readings import other_us_per


def read(x):
    return other_us_per(x, "env_steps")
