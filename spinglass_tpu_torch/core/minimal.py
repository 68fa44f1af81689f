"""Dependency-free minimal Ising model + annealer (stdlib only), copied from
``spinglass_tpu.core.minimal``: the port imports nothing of the JAX package.

The graceful-degradation fallback: when PyTorch is unavailable (broken
install, exotic platform), `MinimalIsingModel`/`MinimalAnnealer` still solve
small instances with pure-Python Metropolis. Unlike the reference fallback (which recomputed
the FULL energy per proposed move — O(N^2) per flip, minimal_ising.py:150),
this one uses the incremental dE = 2 s_i (J_i . s + h_i)."""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence


class MinimalIsingModel:
    def __init__(self, n_spins: int):
        self.n_spins = n_spins
        self.spins: List[float] = [1.0] * n_spins
        self.j: List[dict] = [dict() for _ in range(n_spins)]  # adjacency
        self.h: List[float] = [0.0] * n_spins

    def set_coupling(self, i: int, k: int, value: float) -> None:
        if i == k:
            return
        self.j[i][k] = value
        self.j[k][i] = value

    def set_field(self, i: int, value: float) -> None:
        self.h[i] = value

    def local_field(self, i: int) -> float:
        return sum(v * self.spins[k] for k, v in self.j[i].items()) + self.h[i]

    def energy(self) -> float:
        e = 0.0
        for i in range(self.n_spins):
            e -= self.h[i] * self.spins[i]
            for k, v in self.j[i].items():
                if k > i:
                    e -= v * self.spins[i] * self.spins[k]
        return e

    def delta_energy(self, i: int) -> float:
        return 2.0 * self.spins[i] * self.local_field(i)

    def flip(self, i: int) -> None:
        self.spins[i] = -self.spins[i]

    def randomize(self, rng: random.Random) -> None:
        self.spins = [rng.choice((-1.0, 1.0)) for _ in range(self.n_spins)]


class MinimalAnnealer:
    """Exponential-schedule Metropolis with incremental energies."""

    def __init__(self, n_sweeps: int = 1000, initial_temp: float = 5.0,
                 final_temp: float = 0.01, seed: int = 42):
        self.n_sweeps = n_sweeps
        self.initial_temp = initial_temp
        self.final_temp = final_temp
        self.seed = seed

    def anneal(self, model: MinimalIsingModel) -> dict:
        rng = random.Random(self.seed)
        model.randomize(rng)
        n = model.n_spins
        energy = model.energy()
        best_energy = energy
        best_spins = list(model.spins)
        alpha = (self.final_temp / self.initial_temp) ** (
            1.0 / max(self.n_sweeps - 1, 1))
        temp = self.initial_temp
        for sweep in range(self.n_sweeps):
            for _ in range(n):
                i = rng.randrange(n)
                de = model.delta_energy(i)
                if de <= 0 or rng.random() < math.exp(-de / temp):
                    model.flip(i)
                    energy += de
            if energy < best_energy:
                best_energy = energy
                best_spins = list(model.spins)
            temp = max(temp * alpha, self.final_temp)
        return {
            "best_energy": best_energy,
            "best_spins": best_spins,
            "final_energy": energy,
            "n_sweeps": self.n_sweeps,
        }


def create_test_problem(n_spins: int = 10, seed: int = 0) -> MinimalIsingModel:
    """Random +-1 coupling instance (reference minimal_ising.py:166-183)."""
    rng = random.Random(seed)
    m = MinimalIsingModel(n_spins)
    for i in range(n_spins):
        for k in range(i + 1, n_spins):
            m.set_coupling(i, k, rng.choice((-1.0, 1.0)))
    return m
