"""Quadratic assignment problem -> Ising; a numpy copy of
``spinglass_tpu.problems.qap``.

min sum_{i,j,p,q} F[i,j] D[p,q] x_{i,p} x_{j,q}  -- facility i at location p.
N = n^2 spins with permutation (cardinality-1 row/col) constraints."""

from __future__ import annotations

from typing import Optional

import numpy as np

from spinglass_tpu_torch.core import constraints as C
from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.problems.base import (ProblemSolution, ProblemTemplate,
                                               spins_to_binary)


class QuadraticAssignmentProblem(ProblemTemplate):
    name = "qap"

    def __init__(self, flows: Optional[np.ndarray] = None,
                 distances: Optional[np.ndarray] = None, *, device=None):
        super().__init__(device=device)
        self.flows = flows
        self.distances = distances

    def generate_random_instance(self, n: int = 6, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        f = rng.uniform(0, 10, (n, n))
        d = rng.uniform(1, 10, (n, n))
        self.flows = np.triu(f, 1) + np.triu(f, 1).T
        self.distances = np.triu(d, 1) + np.triu(d, 1).T

    @property
    def n(self) -> int:
        return self.flows.shape[0]

    def spin_index(self, fac: int, loc: int) -> int:
        return fac * self.n + loc

    def encode_to_ising(self, penalty_weight: Optional[float] = None,
                        **params) -> IsingProblem:
        n = self.n
        f, d = self.flows, self.distances
        if penalty_weight is None:
            penalty_weight = 2.0 * float(f.max() * d.max()) * n / 4.0

        # objective: F[i,j] D[p,q] on x_{i,p} x_{j,q} for i != j
        i, j, p, q = np.meshgrid(*([np.arange(n)] * 4), indexing="ij")
        off = i != j
        qi = (i * n + p)[off].ravel()
        qj = (j * n + q)[off].ravel()
        qv = (f[i, j] * d[p, q])[off].ravel()
        obj = C.binary_quadratic_terms(qi, qj, qv)

        self.compiler = C.ConstraintCompiler()
        for fac in range(n):
            self.compiler.add(C.CardinalityConstraint(
                name=f"fac_{fac}_placed", indices=fac * n + np.arange(n),
                k=1, weight=penalty_weight))
        for loc in range(n):
            self.compiler.add(C.CardinalityConstraint(
                name=f"loc_{loc}_used", indices=np.arange(n) * n + loc,
                k=1, weight=penalty_weight))
        t = C.Terms.concat([obj, self.compiler.compile()])
        self._problem = IsingProblem.from_terms(
            n * n, t.quad_i, t.quad_j, t.quad_v, t.lin_i, t.lin_v,
            device=self.device)
        return self._problem

    def assignment_cost(self, perm: np.ndarray) -> float:
        """Cost of facility->location permutation."""
        d_perm = self.distances[np.ix_(perm, perm)]
        return float((self.flows * d_perm).sum())

    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        n = self.n
        x = spins_to_binary(spins)[: n * n].reshape(n, n)
        perm = np.full(n, -1, dtype=np.int64)
        used = np.zeros(n, dtype=bool)
        for fac in range(n):
            cands = [l for l in np.nonzero(x[fac])[0] if not used[l]]
            if cands:
                perm[fac] = cands[0]
                used[cands[0]] = True
        free = [l for l in range(n) if not used[l]]
        for fac in range(n):
            if perm[fac] < 0:
                perm[fac] = free.pop(0)
        clean = bool(np.all(x.sum(0) == 1) and np.all(x.sum(1) == 1))
        return ProblemSolution(
            objective_value=self.assignment_cost(perm),
            variables={"permutation": perm},
            is_feasible=True,
            metadata={"clean_decode": clean},
        )
