"""MaxCut -> Ising (the canonical benchmark problem); the counterpart of
``spinglass_tpu.problems.maxcut``.

Maximize sum_{(i,j) in E} w_ij [s_i != s_j]  <=>  minimize E(s) with J = -W:
cut(s) = (W_total - sum_{i<j} w_ij s_i s_j) / 2 = (W_total - E(s)) / 2 when
h = 0 and J_ij = -w_ij (E = -1/2 s^T J s = sum_{i<j} w_ij s_i s_j). The only
encoder that builds from a dense matrix (``IsingProblem.from_dense``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.problems.base import ProblemSolution, ProblemTemplate


class MaxCutProblem(ProblemTemplate):
    name = "maxcut"

    def __init__(self, weights: Optional[np.ndarray] = None, *, device=None):
        super().__init__(device=device)
        self.weights = weights

    def generate_random_instance(self, n_nodes: int = 20, density: float = 0.5,
                                 seed: int = 0, weighted: bool = True) -> None:
        rng = np.random.default_rng(seed)
        w = np.zeros((n_nodes, n_nodes))
        iu = np.triu_indices(n_nodes, k=1)
        mask = rng.random(len(iu[0])) < density
        vals = rng.uniform(0.1, 1.0, len(iu[0])) if weighted else np.ones(len(iu[0]))
        w[iu[0][mask], iu[1][mask]] = vals[mask]
        self.weights = w + w.T

    def encode_to_ising(self, **params) -> IsingProblem:
        if self.weights is None:
            raise RuntimeError("no instance; call generate_random_instance")
        self._problem = IsingProblem.from_dense(-self.weights,
                                                device=self.device)
        return self._problem

    def cut_value(self, spins: np.ndarray) -> float:
        s = np.sign(np.asarray(spins, dtype=np.float64))
        w = self.weights
        total = 0.5 * w.sum()  # sum over i<j
        sws = 0.5 * float(s @ w @ s)
        return 0.5 * (total - sws)

    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        n = self.weights.shape[0]
        s = np.asarray(spins)[:n]
        partition = (s > 0).astype(np.int64)
        return ProblemSolution(
            objective_value=-self.cut_value(s),  # minimization convention
            variables={"partition": partition, "cut_value": self.cut_value(s)},
            is_feasible=True,  # MaxCut is unconstrained
        )
