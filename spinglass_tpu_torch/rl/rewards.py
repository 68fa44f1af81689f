"""Composable reward shaping for the annealer environment.

The counterpart of ``spinglass_tpu.rl.rewards``, term for term, on device
tensors with a carried normalisation state:

* energy delta with adaptive normalisation;
* acceptance-rate targeting (0.44);
* temperature-schedule conformance: a rapid-change penalty and the deviation
  from the progress-linear schedule T* = 10 (1 - p) + 0.01 p;
* exploration novelty: a per-env hashed count table of visited (energy,
  temperature, action) signatures with a decaying bonus scale;
* convergence bonus and efficiency penalty;

combined with clipping, EMA smoothing and curriculum-stage scaling. Nothing
here reads a value back to the host, and ``compute`` returns a new state:
the caller's state is not modified.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from spinglass_tpu_torch.core.problem import resolve_device

N_NOVELTY_BINS = 256


@dataclass(frozen=True)
class RewardConfig:
    """Weights and shaping knobs (the JAX ``RewardConfig``)."""

    energy_weight: float = 1.0
    acceptance_weight: float = 0.2
    temperature_weight: float = 0.05     # schedule conformance
    exploration_weight: float = 0.02     # novelty bonus
    convergence_weight: float = 0.5
    efficiency_weight: float = 0.05
    target_acceptance: float = 0.44
    exploration_decay: float = 0.995     # per-step decay of the bonus scale
    clip: float = 10.0
    smoothing: float = 0.0               # EMA on the final reward (0 = off)
    norm_decay: float = 0.99             # adaptive |dE| normalisation EMA
    curriculum: bool = False             # episode-staged scaling
    curriculum_stages: int = 5
    difficulty_ramp: float = 1.0


@dataclass
class RewardState:
    de_scale: torch.Tensor        # [B] EMA of |dE| for adaptive normalisation
    reward_ema: torch.Tensor      # [B]
    prev_temp: torch.Tensor       # [B] for the rapid-change penalty
    novelty_counts: torch.Tensor  # [B, N_NOVELTY_BINS] visited-signature table
    novelty_scale: torch.Tensor   # [B] decaying exploration bonus scale


def init_state(cfg: RewardConfig, n_envs: int, device=None) -> RewardState:
    """Fresh reward state for ``n_envs`` envs on ``device`` (None: the card,
    ``core.problem.resolve_device``)."""
    device = resolve_device(device)
    return RewardState(
        de_scale=torch.ones(n_envs, device=device),
        reward_ema=torch.zeros(n_envs, device=device),
        prev_temp=torch.full((n_envs,), -1.0, device=device),
        novelty_counts=torch.zeros(n_envs, N_NOVELTY_BINS, device=device),
        novelty_scale=torch.ones(n_envs, device=device),
    )


def _novelty_bin(energy, initial_energy, temp, mult) -> torch.Tensor:
    """Hashed signature of (normalised energy, temperature, action), int32
    in [0, N_NOVELTY_BINS). Rounds half to even and then truncates to int32,
    as the JAX function does."""
    q_e = torch.round(100.0 * energy / (torch.abs(initial_energy) + 1e-8))
    q_t = torch.round(10.0 * torch.log10(torch.clamp(temp, min=1e-8)))
    q_m = torch.round(10.0 * mult)
    sig = (q_e.to(torch.int32) * 31 + q_t.to(torch.int32) * 17
           + q_m.to(torch.int32) * 7)
    return torch.abs(sig) % N_NOVELTY_BINS


def compute(cfg: RewardConfig, state: RewardState, *, energy, prev_energy,
            best_energy, initial_energy, acc_rate, temp, step, max_steps,
            improved, mult=None, episode=None):
    """Returns (reward [B], new RewardState).

    ``mult``: decoded temperature multiplier (a component of the novelty
    signature); ``episode`` [B]: completed-episode counter for curriculum
    staging. ``best_energy`` is accepted for the JAX signature and unused,
    as there."""
    de = prev_energy - energy  # positive = improvement
    scale = cfg.norm_decay * state.de_scale + (1 - cfg.norm_decay) * torch.abs(de)
    scale = torch.clamp(scale, min=1e-6)
    r_energy = de / scale

    r_accept = -torch.abs(acc_rate - cfg.target_acceptance)

    # penalise >50% per-step temperature changes and the deviation from the
    # progress-linear expected schedule
    progress = step.to(torch.float32) / max_steps
    had_prev = state.prev_temp > 0
    change_rate = torch.abs(temp - state.prev_temp) / torch.clamp(
        state.prev_temp, min=1e-6)
    r_rapid = torch.where(had_prev & (change_rate > 0.5), -change_rate,
                          torch.zeros_like(change_rate))
    expected_temp = 10.0 * (1.0 - progress) + 0.01 * progress
    r_align = -torch.abs(temp - expected_temp) / expected_temp
    r_temp = r_rapid + 0.1 * r_align

    mult_sig = mult if mult is not None else torch.ones_like(temp)
    bins = _novelty_bin(energy, initial_energy, temp, mult_sig).long()
    b_idx = torch.arange(bins.shape[0], device=bins.device)
    count = state.novelty_counts[b_idx, bins]
    r_explore = torch.where(count < 0.5, state.novelty_scale,
                            torch.zeros_like(count))
    # out of place: the caller's table stays as it was
    novelty_counts = state.novelty_counts.index_put(
        (b_idx, bins), torch.ones_like(count), accumulate=True)
    novelty_scale = state.novelty_scale * cfg.exploration_decay

    r_converge = improved.to(torch.float32) * progress

    r_eff = -progress

    reward = (cfg.energy_weight * r_energy
              + cfg.acceptance_weight * r_accept
              + cfg.temperature_weight * r_temp
              + cfg.exploration_weight * r_explore
              + cfg.convergence_weight * r_converge
              + cfg.efficiency_weight * r_eff)

    if cfg.curriculum:
        # the stage advances every 1000 / stages completed episodes
        ep = (episode.to(torch.float32) if episode is not None
              else torch.zeros_like(reward))
        per_stage = max(1000 // cfg.curriculum_stages, 1)
        stage = torch.clamp(torch.div(ep, per_stage, rounding_mode="floor"),
                            max=float(cfg.curriculum_stages - 1))
        reward = reward * (1.0 + stage * cfg.difficulty_ramp
                           / cfg.curriculum_stages)

    reward = torch.clamp(reward, -cfg.clip, cfg.clip)
    if cfg.smoothing > 0:
        reward_ema = (cfg.smoothing * state.reward_ema
                      + (1 - cfg.smoothing) * reward)
        reward = reward_ema
    else:
        reward_ema = reward
    return reward, RewardState(de_scale=scale, reward_ema=reward_ema,
                               prev_temp=temp,
                               novelty_counts=novelty_counts,
                               novelty_scale=novelty_scale)
