"""Multi-agent coordination -> Ising; a numpy copy of
``spinglass_tpu.problems.coordination``.

Encoding x_{agent,task,slot}: agent a performs task t during slot s.
N = A * T * S spins. Objectives: travel and completion time, priority
weighted; constraints: task assignment, one task per agent and slot,
capability matching."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from spinglass_tpu_torch.core import constraints as C
from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.problems.base import (ProblemSolution, ProblemTemplate,
                                               spins_to_binary)


@dataclass
class CoordAgent:
    id: int
    position: np.ndarray
    capabilities: List[str] = field(default_factory=list)
    comm_range: float = 50.0


@dataclass
class CoordTask:
    id: int
    position: np.ndarray
    required_capability: Optional[str] = None
    priority: float = 1.0
    duration: int = 1


class CoordinationProblem(ProblemTemplate):
    name = "coordination"

    def __init__(self, agents: Optional[List[CoordAgent]] = None,
                 tasks: Optional[List[CoordTask]] = None, horizon: int = 5,
                 *, device=None):
        super().__init__(device=device)
        self.agents = agents or []
        self.tasks = tasks or []
        self.horizon = horizon

    def generate_random_instance(self, n_agents: int = 3, n_tasks: int = 5,
                                 horizon: int = 4, seed: int = 0,
                                 box: float = 100.0,
                                 n_capabilities: int = 2) -> None:
        rng = np.random.default_rng(seed)
        caps = [f"cap{i}" for i in range(n_capabilities)]
        self.agents = [
            CoordAgent(id=a, position=rng.uniform(0, box, 2),
                       capabilities=list(rng.choice(
                           caps, size=rng.integers(1, n_capabilities + 1),
                           replace=False)),
                       comm_range=box * 0.6)
            for a in range(n_agents)
        ]
        self.tasks = [
            CoordTask(id=t, position=rng.uniform(0, box, 2),
                      required_capability=str(rng.choice(caps)),
                      priority=float(rng.uniform(0.5, 2.0)))
            for t in range(n_tasks)
        ]
        self.horizon = horizon

    def _dims(self):
        return len(self.agents), len(self.tasks), self.horizon

    def spin_index(self, a: int, t: int, s: int) -> int:
        na, nt, ns = self._dims()
        return (a * nt + t) * ns + s

    def communication_graph(self) -> np.ndarray:
        """[A, A] adjacency from positions + comm range."""
        na = len(self.agents)
        adj = np.zeros((na, na), dtype=bool)
        for i in range(na):
            for j in range(i + 1, na):
                d = np.linalg.norm(self.agents[i].position -
                                   self.agents[j].position)
                rng_ok = d <= min(self.agents[i].comm_range,
                                  self.agents[j].comm_range)
                adj[i, j] = adj[j, i] = rng_ok
        return adj

    def encode_to_ising(self, penalty_weight: Optional[float] = None,
                        **params) -> IsingProblem:
        na, nt, ns = self._dims()
        n_spins = na * nt * ns
        travel = np.array([[np.linalg.norm(ag.position - tk.position)
                            for tk in self.tasks] for ag in self.agents])
        if penalty_weight is None:
            penalty_weight = 4.0 * float(travel.max() / max(travel.max(), 1.0)) + 4.0

        a_i, t_i, s_i = np.meshgrid(np.arange(na), np.arange(nt),
                                    np.arange(ns), indexing="ij")
        flat = ((a_i * nt + t_i) * ns + s_i).ravel()
        prio = np.array([tk.priority for tk in self.tasks])
        # objective: travel cost + completion time, priority-weighted
        lin = (travel[a_i, t_i] / max(travel.max(), 1.0)
               + 0.3 * s_i / max(ns - 1, 1)) * prio[t_i]
        obj = C.binary_quadratic_terms(lin_i=flat, lin_v=lin.ravel())

        self.compiler = C.ConstraintCompiler()
        # each task assigned exactly once
        for t in range(nt):
            idx = np.array([(a * nt + t) * ns + s
                            for a in range(na) for s in range(ns)])
            self.compiler.add(C.CardinalityConstraint(
                name=f"task_{t}_assigned", indices=idx, k=1,
                weight=penalty_weight))
        # agent does at most one task per slot — pairwise penalty
        for a in range(na):
            for s in range(ns):
                idx = np.array([(a * nt + t) * ns + s for t in range(nt)])
                iu, ju = np.triu_indices(nt, k=1)
                self.compiler.add(C.CustomConstraint(
                    name=f"agent_{a}_s{s}_busy", weight=penalty_weight,
                    terms_fn=lambda idx=idx, iu=iu, ju=ju:
                        C.binary_quadratic_terms(idx[iu], idx[ju],
                                                 np.full(len(iu), 2.0)),
                    violation_fn=lambda sp, idx=idx: max(
                        0.0, float((np.asarray(sp)[idx] > 0).sum() - 1)),
                ))
        # capability matching: forbid assignments lacking the capability
        bad_i, bad_v = [], []
        for a, ag in enumerate(self.agents):
            for t, tk in enumerate(self.tasks):
                if (tk.required_capability is not None
                        and tk.required_capability not in ag.capabilities):
                    for s in range(ns):
                        bad_i.append((a * nt + t) * ns + s)
                        bad_v.append(4.0 * penalty_weight)
        cap_terms = (C.binary_quadratic_terms(lin_i=np.array(bad_i),
                                              lin_v=np.array(bad_v))
                     if bad_i else C.Terms())
        t_all = C.Terms.concat([obj, cap_terms, self.compiler.compile()])
        self._problem = IsingProblem.from_terms(
            n_spins, t_all.quad_i, t_all.quad_j, t_all.quad_v,
            t_all.lin_i, t_all.lin_v, device=self.device)
        return self._problem

    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        na, nt, ns = self._dims()
        x = spins_to_binary(spins)[: na * nt * ns].reshape(na, nt, ns)
        assignments = {}
        for t in range(nt):
            hits = np.argwhere(x[:, t, :] > 0)
            if len(hits):
                assignments[t] = {"agent": int(hits[0][0]),
                                  "slot": int(hits[0][1])}
        violations = {}
        missing = nt - len(assignments)
        if missing:
            violations["unassigned_tasks"] = float(missing)
        cap_bad = 0
        for t, v in assignments.items():
            tk, ag = self.tasks[t], self.agents[v["agent"]]
            if (tk.required_capability is not None
                    and tk.required_capability not in ag.capabilities):
                cap_bad += 1
        if cap_bad:
            violations["capability_mismatch"] = float(cap_bad)
        travel = sum(
            float(np.linalg.norm(self.agents[v["agent"]].position -
                                 self.tasks[t].position))
            for t, v in assignments.items())
        makespan = max((v["slot"] + self.tasks[t].duration
                        for t, v in assignments.items()), default=0)
        return ProblemSolution(
            objective_value=travel + makespan,
            variables={"assignments": assignments, "travel": travel,
                       "makespan": makespan},
            is_feasible=not violations,
            constraint_violations=violations,
        )
