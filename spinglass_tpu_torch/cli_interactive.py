"""Interactive quick-solve helper (reference cli/interactive_optimizer.py:19-211).

The counterpart of ``spinglass_tpu.cli_interactive``: for notebook / REPL
use, one call that inspects the problem, lets the meta-optimizer
(``research.meta``) pick an algorithm and schedule, solves, and prints a
summary. A raw J matrix is built on ``device`` (default: the card, see
``core.problem.resolve_device``)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.research.meta import MetaOptimizer, select_algorithm


class InteractiveOptimizer:
    def __init__(self, n_sweeps: int = 1000, n_replicas: int = 32,
                 verbose: bool = True, device=None):
        self.meta = MetaOptimizer(n_sweeps=n_sweeps, n_replicas=n_replicas)
        self.verbose = verbose
        self.device = device

    def quick_solve(self, problem: Union[IsingProblem, np.ndarray],
                    h: Optional[np.ndarray] = None,
                    algorithm: Optional[str] = None):
        """Solve a problem (IsingProblem or raw J matrix) with auto-selection.

        Returns the AnnealResult; prints a human summary when verbose."""
        if not isinstance(problem, IsingProblem):
            problem = IsingProblem.from_dense(np.asarray(problem), h,
                                              device=self.device)
        algo = algorithm or select_algorithm(problem)
        if self.verbose:
            print(f"problem: {problem.n_spins} spins → algorithm: {algo}")
        res = self.meta.solve(problem, algorithm=algo)
        if self.verbose:
            print(f"best energy: {res.best_energy:.4f}")
            print(f"time:        {res.total_time:.2f}s "
                  f"({res.spin_flips_per_second:.2e} flips/s)")
        return res

    def history(self) -> list:
        return self.meta.solve_log
