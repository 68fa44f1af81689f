"""A plain follower of the RL cell's environment: the annealer as an env,
its temperature actions, rewards, done flags, auto-resets and observations.

The sweeps draw their randomness inside the program's kernels, so no plain
code can replay them: the follower takes from the program only what is
random, each step's spins after the sweeps and their acceptance rate, and,
for the envs that it itself finds done, the fresh spins and start
temperature of the reset; energies are the program's, each judged on its
own against the float64 energy of its spins (``env_energy_gap``). All the
rest it carries itself from the start state: the temperature after each
action, best energy, plateau and step counters, the reward's normalisation
and novelty state, the reward, done, the reset mix and the 16 global
observations.

It works in float32, the precision of the configuration: the reward's
novelty term hashes rounded float32 quantities and its rapid-change penalty
compares a float32 ratio with 0.5, so a follower in another precision would
land on the other side of those edges now and then. Each operation is the
one the reward's definition states, in its order.

Reward (weights in ``spec["reward"]``): the energy drop over an EMA of
|dE|, -|acceptance - target|, a penalty on a temperature change over 50%
plus a tenth of the deviation from T* = 10 (1 - p) + 0.01 p, a bonus for
an unvisited (energy, temperature, action) signature, p where the best
improved, -p; clipped. Done: the step counter at ``max_steps`` or
``plateau_patience`` steps without improvement.
"""

from __future__ import annotations

import torch

LADDER = (0.5, 0.7, 0.8, 0.9, 0.95, 1.05, 1.1, 1.25, 1.5, 2.0)
N_BINS = 256


class Follower:
    """The env's state as the definition carries it, for ``n`` spins."""

    def __init__(self, spec: dict, n: int, spins, energy, temp):
        self.spec, self.r, self.n = spec, spec["reward"], n
        if self.r["smoothing"] or self.r["curriculum"]:
            raise ValueError("the follower states no smoothed or staged "
                             "reward")
        dev = energy.device
        self.ladder = torch.tensor(LADDER, dtype=torch.float32, device=dev)
        b = energy.shape[0]
        self.s = self._fresh(spins, energy, temp,
                             torch.ones(b, dtype=torch.bool, device=dev),
                             None)

    def _fresh(self, spins, energy, temp, done, old):
        """The state after an auto-reset: ``done`` envs fresh from the
        program's draw (spins, their energy, start temperature), the others
        as ``old`` left them."""
        b = energy.shape[0]
        dev = energy.device
        fresh = {"spins": spins[:, : self.n].float(), "energy": energy,
                 "best": energy, "initial": energy, "prev": energy,
                 "temp": temp, "acc": torch.zeros(b, device=dev),
                 "step": torch.zeros(b, device=dev),
                 "plateau": torch.zeros(b, device=dev),
                 "de_scale": torch.ones(b, device=dev),
                 "prev_temp": torch.full((b,), -1.0, device=dev),
                 "counts": torch.zeros(b, N_BINS, device=dev),
                 "nscale": torch.ones(b, device=dev)}
        if old is None:
            return fresh
        return {k: torch.where(done.reshape((-1,) + (1,) * (v.ndim - 1)),
                               v, old[k]) for k, v in fresh.items()}

    def observe(self) -> torch.Tensor:
        """[B, 16] global features."""
        s, sp = self.s, self.spec
        e0 = torch.abs(s["initial"]) + 1e-8
        mag = s["spins"].sum(-1) / self.n
        z = (s["energy"] - s["energy"].mean()) / (
            torch.std(s["energy"], correction=0) + 1e-8)
        log_t = torch.log10(torch.clamp(s["temp"], min=1e-8))
        feats = [s["energy"] / e0, s["best"] / e0,
                 (s["energy"] - s["prev"]) / e0, log_t, s["acc"],
                 s["step"] / sp["max_steps"], mag, z,
                 s["plateau"] / sp["plateau_patience"],
                 (s["energy"] - s["best"]) / e0,
                 torch.tanh(s["energy"] / e0), torch.abs(mag),
                 s["acc"] - 0.44, log_t / 3.0, torch.ones_like(mag),
                 torch.zeros_like(mag)]
        return torch.stack(feats, dim=-1)

    def step(self, action, spins, energy, acc):
        """One env step on the program's action [B], spins [B, >= n] after
        the sweeps, their energies [B] and acceptance rates [B]: returns
        (reward, done, temperature), and leaves the state after the step
        (before the reset) in ``self.s``."""
        s, sp, rc = self.s, self.spec, self.r
        mult = self.ladder[action.long()]
        temp = torch.clamp(s["temp"] * mult, sp["min_temp"], sp["max_temp"])
        improved = energy < s["best"] - 1e-9
        best = torch.minimum(s["best"], energy)
        plateau = torch.where(improved, torch.zeros_like(s["plateau"]),
                              s["plateau"] + 1)
        step = s["step"] + 1

        de = s["energy"] - energy
        scale = (rc["norm_decay"] * s["de_scale"]
                 + (1 - rc["norm_decay"]) * torch.abs(de))
        scale = torch.clamp(scale, min=1e-6)
        r_energy = de / scale
        r_accept = -torch.abs(acc - rc["target_acceptance"])
        progress = step / sp["max_steps"]
        change = torch.abs(temp - s["prev_temp"]) / torch.clamp(
            s["prev_temp"], min=1e-6)
        r_rapid = torch.where((s["prev_temp"] > 0) & (change > 0.5), -change,
                              torch.zeros_like(change))
        expected = 10.0 * (1.0 - progress) + 0.01 * progress
        r_temp = r_rapid + 0.1 * (-torch.abs(temp - expected) / expected)
        q_e = torch.round(100.0 * energy / (torch.abs(s["initial"]) + 1e-8))
        q_t = torch.round(10.0 * torch.log10(torch.clamp(temp, min=1e-8)))
        q_m = torch.round(10.0 * mult)
        sig = (q_e.to(torch.int32) * 31 + q_t.to(torch.int32) * 17
               + q_m.to(torch.int32) * 7)
        bins = (torch.abs(sig) % N_BINS).long()
        rows = torch.arange(bins.shape[0], device=bins.device)
        count = s["counts"][rows, bins]
        r_explore = torch.where(count < 0.5, s["nscale"],
                                torch.zeros_like(count))
        counts = s["counts"].index_put((rows, bins), torch.ones_like(count),
                                       accumulate=True)
        r_converge = improved.to(torch.float32) * progress
        reward = (rc["energy_weight"] * r_energy
                  + rc["acceptance_weight"] * r_accept
                  + rc["temperature_weight"] * r_temp
                  + rc["exploration_weight"] * r_explore
                  + rc["convergence_weight"] * r_converge
                  + rc["efficiency_weight"] * -progress)
        reward = torch.clamp(reward, -rc["clip"], rc["clip"])
        done = (step >= sp["max_steps"]) | (plateau >= sp["plateau_patience"])
        self.s = dict(s, spins=spins[:, : self.n].float(), energy=energy,
                      best=best, prev=s["energy"],
                      temp=temp, acc=acc, step=step, plateau=plateau,
                      de_scale=scale, prev_temp=temp, counts=counts,
                      nscale=s["nscale"] * rc["exploration_decay"])
        return reward, done, temp

    def reset(self, done, spins, energy, temp) -> None:
        """The auto-reset: ``done`` envs take the program's fresh draw."""
        self.s = self._fresh(spins, energy, temp, done, self.s)
