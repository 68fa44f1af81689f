"""Lightweight task -> agent assignment; a numpy copy of
``spinglass_tpu.problems.simple_scheduler``.

x_{task,agent} with cardinality-1 per task and cost fields; greedy decode."""

from __future__ import annotations

from typing import Optional

import numpy as np

from spinglass_tpu_torch.core import constraints as C
from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.problems.base import (ProblemSolution, ProblemTemplate,
                                               spins_to_binary)


class SimpleScheduler(ProblemTemplate):
    name = "simple_scheduler"

    def __init__(self, costs: Optional[np.ndarray] = None, *, device=None):
        super().__init__(device=device)
        self.costs = costs  # [n_tasks, n_agents]

    def generate_random_instance(self, n_tasks: int = 8, n_agents: int = 3,
                                 seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        self.costs = rng.uniform(1, 10, (n_tasks, n_agents))

    def encode_to_ising(self, penalty_weight: Optional[float] = None,
                        **params) -> IsingProblem:
        nt, na = self.costs.shape
        if penalty_weight is None:
            penalty_weight = 4.0 * float(self.costs.max())
        flat = np.arange(nt * na)
        obj = C.binary_quadratic_terms(
            lin_i=flat, lin_v=self.costs.ravel() / self.costs.max())
        self.compiler = C.ConstraintCompiler()
        for t in range(nt):
            self.compiler.add(C.CardinalityConstraint(
                name=f"task_{t}", indices=t * na + np.arange(na), k=1,
                weight=penalty_weight))
        terms = C.Terms.concat([obj, self.compiler.compile()])
        self._problem = IsingProblem.from_terms(
            nt * na, terms.quad_i, terms.quad_j, terms.quad_v,
            terms.lin_i, terms.lin_v, device=self.device)
        return self._problem

    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        nt, na = self.costs.shape
        x = spins_to_binary(spins)[: nt * na].reshape(nt, na)
        assignment = {}
        for t in range(nt):
            hits = np.nonzero(x[t])[0]
            assignment[t] = int(hits[0]) if len(hits) else int(
                np.argmin(self.costs[t]))
        total = float(sum(self.costs[t, a] for t, a in assignment.items()))
        return ProblemSolution(
            objective_value=total,
            variables={"assignment": assignment},
            is_feasible=True,
        )
