"""Problem-template base: encode -> anneal -> decode, with violation accounting.

The counterpart of ``spinglass_tpu.problems.base``. Encoders produce flat
term arrays (``core.constraints``) and build the problem with one
scatter-add (``IsingProblem.from_terms``) on the template's device: the card
unless the caller names one (``core.problem.resolve_device``). ``solve``
runs the port's ``anneal`` (or any annealer callable) there; the result's
best spins come back to the host once, at the end of the run, and decoding
is numpy.
"""

from __future__ import annotations

import abc
import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
from spinglass_tpu_torch.core.constraints import ConstraintCompiler
from spinglass_tpu_torch.core.problem import IsingProblem


@dataclass
class ProblemSolution:
    """Decoded solution."""

    objective_value: float
    variables: dict = field(default_factory=dict)
    is_feasible: bool = True
    constraint_violations: dict = field(default_factory=dict)
    energy: float = 0.0
    metadata: dict = field(default_factory=dict)

    @property
    def n_violations(self) -> int:
        return sum(1 for v in self.constraint_violations.values()
                   if abs(v) > 1e-6)

    def to_json(self) -> str:
        def _clean(x):
            if isinstance(x, np.ndarray):
                return x.tolist()
            if isinstance(x, (np.floating, np.integer)):
                return x.item()
            if isinstance(x, dict):
                return {str(k): _clean(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [_clean(v) for v in x]
            return x

        return json.dumps({
            "objective_value": self.objective_value,
            "variables": _clean(self.variables),
            "is_feasible": self.is_feasible,
            "constraint_violations": _clean(self.constraint_violations),
            "energy": self.energy,
            "metadata": _clean(self.metadata),
        }, indent=2)


class ProblemTemplate(abc.ABC):
    """Abstract problem encoder. ``device`` is where ``encode_to_ising``
    builds the problem (None: the card)."""

    name: str = "problem"

    def __init__(self, *, device=None) -> None:
        self.compiler = ConstraintCompiler()
        self._problem: Optional[IsingProblem] = None
        self.device = device

    @abc.abstractmethod
    def encode_to_ising(self, **params) -> IsingProblem:
        """Compile the instance into an IsingProblem (cached on self)."""

    @abc.abstractmethod
    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        """Map a spin configuration back to problem variables."""

    @abc.abstractmethod
    def generate_random_instance(self, **params) -> None:
        """Populate the instance with random data."""

    def validate_solution(self, solution: ProblemSolution) -> bool:
        return solution.is_feasible

    @property
    def problem(self) -> IsingProblem:
        if self._problem is None:
            raise RuntimeError("call encode_to_ising() first")
        return self._problem

    def solve(self, config: Optional[SAConfig] = None,
              annealer=None, **anneal_kwargs) -> ProblemSolution:
        """encode -> anneal -> decode.

        ``annealer`` may override the solve fn: any callable
        (IsingProblem, config) -> AnnealResult (e.g. pt.run wrapped).
        Extra kwargs pass through to the solver (checkpoint_dir=, resume=).
        ``metadata["anneal"]`` is ``anneal_metadata(result)``."""
        if self._problem is None:
            self.encode_to_ising()
        t0 = time.perf_counter()
        solve_fn = annealer or anneal
        result: AnnealResult = solve_fn(self._problem, config,
                                        **anneal_kwargs)
        sol = self.decode_solution(result.best_spins)
        sol.energy = result.best_energy
        sol.metadata.update({
            "solve_time": time.perf_counter() - t0,
            "anneal": anneal_metadata(result),
        })
        return sol

    def benchmark_instance(self, config: Optional[SAConfig] = None,
                           n_trials: int = 5) -> dict:
        """n-trial statistics, trial t with seed ``config.seed + t``."""
        objectives, times, feasible = [], [], 0
        for t in range(n_trials):
            cfg = config or SAConfig()
            cfg = dataclasses.replace(cfg, seed=cfg.seed + t)
            sol = self.solve(cfg)
            objectives.append(sol.objective_value)
            times.append(sol.metadata["solve_time"])
            feasible += int(sol.is_feasible)
        return {
            "n_trials": n_trials,
            "best_objective": float(np.min(objectives)),
            "mean_objective": float(np.mean(objectives)),
            "std_objective": float(np.std(objectives)),
            "mean_time": float(np.mean(times)),
            "feasibility_rate": feasible / n_trials,
        }


def anneal_metadata(result: AnnealResult) -> dict:
    """A run's summary with the engine that swept, its kernel launches
    (kernel name -> launches in this run; empty for the plain engines) and
    the seconds of its capture (inside ``total_time``; 0 on a repeat call)."""
    return {**result.summary(),
            "engine": result.metadata.get("engine"),
            "capture_seconds": result.metadata.get("capture_seconds", 0.0),
            "kernel_launches": dict(result.metadata.get("kernel_launches",
                                                        {}))}


def spins_to_binary(spins: np.ndarray) -> np.ndarray:
    """{-1,+1} -> {0,1} (x = (1+s)/2)."""
    return (np.asarray(spins) > 0).astype(np.int64)
