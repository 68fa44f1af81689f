"""Resource allocation -> Ising; a numpy copy of
``spinglass_tpu.problems.resource``.

Encoding x_{demand,resource}: demand d is served by resource r. N = D * R
spins. Objectives cost / satisfaction / load-balance as linear fields;
demand-satisfaction cardinality and capacity penalties."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from spinglass_tpu_torch.core import constraints as C
from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.problems.base import (ProblemSolution, ProblemTemplate,
                                               spins_to_binary)


@dataclass
class Resource:
    id: int
    capacity: float
    cost_per_unit: float = 1.0


@dataclass
class Demand:
    id: int
    amount: float
    priority: float = 1.0


class ResourceAllocationProblem(ProblemTemplate):
    name = "resource_allocation"

    def __init__(self, resources: Optional[List[Resource]] = None,
                 demands: Optional[List[Demand]] = None,
                 objective: str = "cost", *, device=None):
        super().__init__(device=device)
        self.resources = resources or []
        self.demands = demands or []
        self.objective = objective

    def generate_random_instance(self, n_resources: int = 4, n_demands: int = 8,
                                 seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        total_demand = 0.0
        self.demands = []
        for d in range(n_demands):
            amt = float(rng.uniform(1, 10))
            total_demand += amt
            self.demands.append(Demand(id=d, amount=amt,
                                       priority=float(rng.uniform(0.5, 2.0))))
        cap = 1.5 * total_demand / n_resources
        self.resources = [
            Resource(id=r, capacity=float(rng.uniform(0.8, 1.2)) * cap,
                     cost_per_unit=float(rng.uniform(0.5, 2.0)))
            for r in range(n_resources)
        ]

    def spin_index(self, d: int, r: int) -> int:
        return d * len(self.resources) + r

    def encode_to_ising(self, penalty_weight: Optional[float] = None,
                        **params) -> IsingProblem:
        nd, nr = len(self.demands), len(self.resources)
        n_spins = nd * nr
        costs = np.array([[dm.amount * rs.cost_per_unit
                           for rs in self.resources] for dm in self.demands])
        if penalty_weight is None:
            penalty_weight = 4.0 * float(costs.max())

        d_idx, r_idx = np.meshgrid(np.arange(nd), np.arange(nr), indexing="ij")
        flat = (d_idx * nr + r_idx).ravel()
        if self.objective == "cost":
            lin = costs.ravel()
        elif self.objective == "satisfaction":
            prio = np.array([dm.priority for dm in self.demands])
            lin = (-prio[d_idx]).ravel()  # reward serving high priority
        elif self.objective == "load_balance":
            amounts = np.array([dm.amount for dm in self.demands])
            caps = np.array([rs.capacity for rs in self.resources])
            lin = (amounts[d_idx] / caps[r_idx]).ravel()
        else:
            raise ValueError(self.objective)
        lin = lin / max(np.abs(lin).max(), 1.0)
        obj = C.binary_quadratic_terms(lin_i=flat, lin_v=lin)

        self.compiler = C.ConstraintCompiler()
        # each demand served exactly once
        for d in range(nd):
            idx = d * nr + np.arange(nr)
            self.compiler.add(C.CardinalityConstraint(
                name=f"demand_{d}_served", indices=idx, k=1,
                weight=penalty_weight))
        # capacity: sum of amounts on resource r <= capacity_r. Slack-free
        # QUBO relaxation: quadratic load-product penalty
        # lam * sum_{i<j} (2 a_i a_j / cap^2) x_i x_j, which grows with the
        # squared load and so also punishes 3+-demand overloads that a
        # pair-threshold test misses; pairs that alone exceed capacity get an
        # extra hard penalty.
        amounts = np.array([dm.amount for dm in self.demands])
        for r, rs in enumerate(self.resources):
            idx = np.arange(nd) * nr + r
            iu, ju = np.triu_indices(nd, k=1)
            pair_amount = amounts[iu] + amounts[ju]
            w = 2.0 * penalty_weight * (amounts[iu] * amounts[ju]
                                        / rs.capacity ** 2)
            w = w + np.where(pair_amount > rs.capacity, 2.0 * penalty_weight,
                             0.0)
            self.compiler.add(C.CustomConstraint(
                name=f"res_{r}_capacity", weight=1.0,
                terms_fn=lambda idx=idx, iu=iu, ju=ju, w=w:
                    C.binary_quadratic_terms(idx[iu], idx[ju], 2.0 * w),
                violation_fn=lambda sp, idx=idx, cap=rs.capacity: max(
                    0.0, float(amounts[(np.asarray(sp)[idx] > 0)].sum() - cap)),
            ))
        t = C.Terms.concat([obj, self.compiler.compile()])
        self._problem = IsingProblem.from_terms(
            n_spins, t.quad_i, t.quad_j, t.quad_v, t.lin_i, t.lin_v,
            device=self.device)
        return self._problem

    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        nd, nr = len(self.demands), len(self.resources)
        x = spins_to_binary(spins)[: nd * nr].reshape(nd, nr)
        allocation, loads = {}, np.zeros(nr)
        for d in range(nd):
            hits = np.nonzero(x[d])[0]
            r = int(hits[0]) if len(hits) else int(np.argmin(loads))
            allocation[d] = r
            loads[r] += self.demands[d].amount
        total_cost = float(sum(
            self.demands[d].amount * self.resources[r].cost_per_unit
            for d, r in allocation.items()))
        caps = np.array([rs.capacity for rs in self.resources])
        overloads = np.maximum(0.0, loads - caps)
        utilization = loads / caps
        return ProblemSolution(
            objective_value=total_cost,
            variables={"allocation": allocation, "loads": loads.tolist(),
                       "utilization": utilization.tolist()},
            is_feasible=bool(np.all(overloads <= 1e-9)),
            constraint_violations={
                f"resource_{r}_overload": float(o)
                for r, o in enumerate(overloads) if o > 1e-9},
        )
