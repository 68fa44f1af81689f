"""Multi-agent scheduling -> Ising; a numpy copy of
``spinglass_tpu.problems.scheduling``.

Encoding x_{task,agent,slot}: task t starts on agent a at time slot s.
N = T * A * S spins. Objectives (makespan / total completion / weighted)
become linear fields; assignment and capacity are cardinality constraints;
precedence becomes pairwise penalties, generated vectorized."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from spinglass_tpu_torch.core import constraints as C
from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.problems.base import (ProblemSolution, ProblemTemplate,
                                               spins_to_binary)


@dataclass
class Task:
    id: int
    duration: int = 1
    priority: float = 1.0
    due_date: Optional[int] = None
    predecessors: List[int] = field(default_factory=list)


@dataclass
class Agent:
    id: int
    skill: float = 1.0  # processing-speed multiplier


class SchedulingProblem(ProblemTemplate):
    """Task-agent-timeslot scheduling."""

    name = "scheduling"

    def __init__(self, tasks: Optional[List[Task]] = None,
                 agents: Optional[List[Agent]] = None,
                 horizon: int = 10, objective: str = "makespan",
                 *, device=None):
        super().__init__(device=device)
        self.tasks = tasks or []
        self.agents = agents or []
        self.horizon = horizon
        self.objective = objective

    def generate_random_instance(self, n_tasks: int = 6, n_agents: int = 3,
                                 horizon: Optional[int] = None, seed: int = 0,
                                 max_duration: int = 3,
                                 precedence_prob: float = 0.15) -> None:
        """Random instance."""
        rng = np.random.default_rng(seed)
        self.tasks = [
            Task(id=t, duration=int(rng.integers(1, max_duration + 1)),
                 priority=float(rng.uniform(0.5, 2.0)))
            for t in range(n_tasks)
        ]
        for t in range(1, n_tasks):
            for p in range(t):
                if rng.random() < precedence_prob:
                    self.tasks[t].predecessors.append(p)
        self.agents = [Agent(id=a, skill=float(rng.uniform(0.8, 1.2)))
                       for a in range(n_agents)]
        total_work = sum(t.duration for t in self.tasks)
        self.horizon = horizon or max(
            total_work // n_agents + max_duration + 2, max_duration + 1)

    def _dims(self):
        return len(self.tasks), len(self.agents), self.horizon

    def spin_index(self, t: int, a: int, s: int) -> int:
        na = len(self.agents)
        return (t * na + a) * self.horizon + s

    def encode_to_ising(self, penalty_weight: Optional[float] = None,
                        **params) -> IsingProblem:
        nt, na, ns = self._dims()
        n_spins = nt * na * ns
        if penalty_weight is None:
            penalty_weight = 4.0 * max(1.0, ns / 4.0)

        # ---- objective as linear fields ----
        t_idx, a_idx, s_idx = np.meshgrid(
            np.arange(nt), np.arange(na), np.arange(ns), indexing="ij")
        flat = ((t_idx * na + a_idx) * ns + s_idx).ravel()
        dur = np.array([t.duration for t in self.tasks])
        prio = np.array([t.priority for t in self.tasks])
        completion = s_idx + dur[t_idx]
        if self.objective == "makespan":
            cost = completion.astype(np.float64)  # proxy: sum of completions
        elif self.objective == "total_completion":
            cost = completion.astype(np.float64)
        elif self.objective == "weighted_completion":
            cost = (prio[t_idx] * completion).astype(np.float64)
        else:
            raise ValueError(self.objective)
        # normalize so objective stays below penalty scale
        cost = cost / max(cost.max(), 1.0)
        obj = C.binary_quadratic_terms(lin_i=flat, lin_v=cost.ravel())

        self.compiler = C.ConstraintCompiler()
        # each task assigned exactly once
        for t in range(nt):
            idx = np.array([(t * na + a) * ns + s
                            for a in range(na) for s in range(ns)])
            self.compiler.add(C.CardinalityConstraint(
                name=f"task_{t}_assigned", indices=idx, k=1,
                weight=penalty_weight))
        # agent capacity: at most one task occupying agent a at time u
        # — pairwise penalty over overlapping starts
        for a in range(na):
            for u in range(ns):
                cover = []
                for t in range(nt):
                    d = self.tasks[t].duration
                    for s in range(max(0, u - d + 1), min(u + 1, ns)):
                        cover.append((t * na + a) * ns + s)
                if len(cover) > 1:
                    idx = np.array(cover)
                    iu, ju = np.triu_indices(len(idx), k=1)
                    self.compiler.add(C.CustomConstraint(
                        name=f"agent_{a}_t{u}_cap", weight=penalty_weight,
                        terms_fn=lambda idx=idx, iu=iu, ju=ju:
                            C.binary_quadratic_terms(
                                idx[iu], idx[ju], np.full(len(iu), 2.0)),
                        violation_fn=lambda sp, idx=idx: max(
                            0.0, float((np.asarray(sp)[idx] > 0).sum() - 1)),
                    ))
        # precedence: pred must complete before successor starts
        # — penalize violating start pairs, vectorized
        qi_l, qj_l = [], []
        for t, task in enumerate(self.tasks):
            for p in task.predecessors:
                dp = self.tasks[p].duration
                s_t, s_p = np.meshgrid(np.arange(ns), np.arange(ns),
                                       indexing="ij")
                bad = s_t < s_p + dp  # successor starts before pred finishes
                at, ap = np.meshgrid(np.arange(na), np.arange(na),
                                     indexing="ij")
                for a1 in range(na):
                    for a2 in range(na):
                        qi_l.append(((t * na + a1) * ns + s_t[bad]).ravel())
                        qj_l.append(((p * na + a2) * ns + s_p[bad]).ravel())
        prec = (C.binary_quadratic_terms(
            np.concatenate(qi_l), np.concatenate(qj_l),
            np.full(sum(len(q) for q in qi_l), 2.0 * penalty_weight))
            if qi_l else C.Terms())
        # due dates as extra fields
        due_i, due_v = [], []
        for t, task in enumerate(self.tasks):
            if task.due_date is not None:
                for a in range(na):
                    for s in range(ns):
                        late = max(0, s + task.duration - task.due_date)
                        if late:
                            due_i.append((t * na + a) * ns + s)
                            due_v.append(float(late) * task.priority)
        due = (C.binary_quadratic_terms(lin_i=np.array(due_i),
                                        lin_v=np.array(due_v))
               if due_i else C.Terms())

        t_all = C.Terms.concat([obj, prec, due, self.compiler.compile()])
        self._problem = IsingProblem.from_terms(
            n_spins, t_all.quad_i, t_all.quad_j, t_all.quad_v,
            t_all.lin_i, t_all.lin_v, device=self.device)
        return self._problem

    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        """Greedy decode + schedule build."""
        nt, na, ns = self._dims()
        x = spins_to_binary(spins)[: nt * na * ns].reshape(nt, na, ns)
        assignments = {}
        for t in range(nt):
            hits = np.argwhere(x[t] > 0)
            if len(hits):
                a, s = int(hits[0][0]), int(hits[0][1])
            else:  # repair: earliest-free greedy
                a, s = t % na, 0
            assignments[t] = {"agent": a, "start": s,
                              "end": s + self.tasks[t].duration}
        makespan = max(v["end"] for v in assignments.values()) if assignments else 0
        # violation accounting
        violations = {}
        busy = {}
        for t, v in assignments.items():
            for u in range(v["start"], min(v["end"], ns)):
                keyu = (v["agent"], u)
                busy.setdefault(keyu, []).append(t)
        overlaps = sum(len(ts) - 1 for ts in busy.values() if len(ts) > 1)
        if overlaps:
            violations["agent_overlaps"] = float(overlaps)
        prec_bad = 0
        for t, task in enumerate(self.tasks):
            for p in task.predecessors:
                if assignments[t]["start"] < assignments[p]["end"]:
                    prec_bad += 1
        if prec_bad:
            violations["precedence"] = float(prec_bad)
        feasible = not violations
        total_completion = float(sum(v["end"] for v in assignments.values()))
        obj_val = (float(makespan) if self.objective == "makespan"
                   else total_completion)
        return ProblemSolution(
            objective_value=obj_val,
            variables={"assignments": assignments, "makespan": makespan,
                       "total_completion": total_completion},
            is_feasible=feasible,
            constraint_violations=violations,
        )


class JobShopScheduling(SchedulingProblem):
    """Job-shop: chains of operations with per-job precedence."""

    name = "jobshop"

    def generate_random_instance(self, n_jobs: int = 3, ops_per_job: int = 2,
                                 n_agents: int = 2, seed: int = 0,
                                 max_duration: int = 2, **_) -> None:
        rng = np.random.default_rng(seed)
        self.tasks = []
        tid = 0
        for j in range(n_jobs):
            prev = None
            for o in range(ops_per_job):
                t = Task(id=tid, duration=int(rng.integers(1, max_duration + 1)),
                         priority=1.0,
                         predecessors=[prev] if prev is not None else [])
                self.tasks.append(t)
                prev = tid
                tid += 1
        self.agents = [Agent(id=a) for a in range(n_agents)]
        total = sum(t.duration for t in self.tasks)
        self.horizon = total // n_agents + max_duration * ops_per_job + 1
