"""Multi-objective annealing with a Pareto archive.

The counterpart of ``spinglass_tpu.research.pareto``: several Ising
objectives over the same spins are scalarised with a spread of weight
vectors; each scalarisation is a new problem on the objectives' device,
annealed by ``sa.anneal`` (K1 on the card; a capture per weight vector),
and the objective vectors of each best solution feed a non-dominated
archive. The archive and the weights are numpy, as in the JAX module."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
from spinglass_tpu_torch.core import energy as energy_ops
from spinglass_tpu_torch.core.problem import IsingProblem


def dominates(a: np.ndarray, b: np.ndarray) -> bool:
    """a dominates b (minimization): a <= b everywhere and < somewhere."""
    return bool(np.all(a <= b) and np.any(a < b))


class ParetoArchive:
    """Non-dominated set (reference ParetoFrontier,
    multi_objective_pareto.py:244-330)."""

    def __init__(self):
        self.objectives: List[np.ndarray] = []
        self.solutions: List[np.ndarray] = []

    def insert(self, objective: np.ndarray, solution: np.ndarray) -> bool:
        obj = np.asarray(objective, float)
        for existing in self.objectives:
            if dominates(existing, obj) or np.array_equal(existing, obj):
                return False
        keep = [i for i, e in enumerate(self.objectives)
                if not dominates(obj, e)]
        self.objectives = [self.objectives[i] for i in keep]
        self.solutions = [self.solutions[i] for i in keep]
        self.objectives.append(obj)
        self.solutions.append(np.asarray(solution))
        return True

    @property
    def front(self) -> np.ndarray:
        return (np.stack(self.objectives) if self.objectives
                else np.zeros((0, 0)))

    def hypervolume_2d(self, ref: Sequence[float]) -> float:
        """2-objective hypervolume against a reference point."""
        if not self.objectives or len(self.objectives[0]) != 2:
            return 0.0
        pts = np.stack(sorted(self.objectives, key=lambda o: o[0]))
        ref = np.asarray(ref, float)
        hv, prev_y = 0.0, ref[1]
        for x, y in pts:
            if x >= ref[0] or y >= prev_y:
                continue
            hv += (ref[0] - x) * (prev_y - y)
            prev_y = y
        return float(hv)


@dataclass(frozen=True)
class MultiObjectiveConfig:
    n_weight_vectors: int = 8
    n_sweeps: int = 300
    n_replicas: int = 16
    seed: int = 42


def weight_vectors(k: int, n_objectives: int, seed: int = 0) -> np.ndarray:
    """Evenly spread simplex weights (2-obj: linspace; else Dirichlet)."""
    if n_objectives == 2:
        w = np.linspace(0.0, 1.0, k)
        return np.stack([w, 1.0 - w], axis=1)
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.ones(n_objectives), size=k)


def combine(problems: Sequence[IsingProblem], weights: np.ndarray
            ) -> IsingProblem:
    """Weighted-sum scalarization of several Ising objectives, in float64
    on the host as in the JAX function, built on the first objective's
    device."""
    n = problems[0].n_spins
    j = np.zeros((n, n))
    h = np.zeros(n)
    for w, p in zip(weights, problems):
        j += w * p.j[:n, :n].double().cpu().numpy()
        h += w * p.h[:n].double().cpu().numpy()
    return IsingProblem.from_dense(j, h, device=problems[0].device)


def optimize(problems: Sequence[IsingProblem],
             cfg: Optional[MultiObjectiveConfig] = None,
             generator: Optional[torch.Generator] = None) -> ParetoArchive:
    """Anneal each scalarization; archive the objective vector of each
    anneal's best spins. With a ``generator`` every anneal draws from it;
    without, anneal k is seeded by ``cfg.seed + k``, as in JAX."""
    cfg = cfg or MultiObjectiveConfig()
    n = problems[0].n_spins
    if any(p.n_spins != n for p in problems):
        raise ValueError("all objectives must share the spin space")
    archive = ParetoArchive()
    ws = weight_vectors(cfg.n_weight_vectors, len(problems), cfg.seed)
    for wi, w in enumerate(ws):
        combined = combine(problems, w)
        res = anneal(combined, SAConfig(
            n_sweeps=cfg.n_sweeps, n_replicas=cfg.n_replicas,
            use_kernel="auto", enable_early_stop=False, seed=cfg.seed + wi),
            generator=generator)
        s = np.ones(problems[0].n_padded, np.float32)
        s[:n] = res.best_spins
        s = torch.as_tensor(s, device=problems[0].device)
        objs = np.asarray([float(energy_ops.energy(p, s)) for p in problems])
        archive.insert(objs, res.best_spins)
    return archive
