"""Benchmark harness: grid over {problem x size x algorithm x schedule x trial}.

Rebuilds BenchmarkRunner/BenchmarkSuite (reference benchmarks/
benchmark_runner.py:20-429) and the PerformanceBenchmark grid
(benchmarking/performance_benchmark.py:93-860): metrics are best_energy,
time-to-solution, sweeps/s, spin-flips/s and device memory peak, reported as
JSON.

The counterpart of ``spinglass_tpu.benchmarks.runner``, on the port's
solvers: ``use_pallas`` is ``use_kernel``, the problems are built on
``device`` (None: the card), and the peak memory is the port's
``device_memory_stats``. A case's SA solves take ``make_engine``'s choice for
its encoded (dense) problem: K1 on the card where no colouring of at most 8
colours is found, the coloured sweep otherwise; its PT solves
(``min(R, 16)`` replicas) likewise."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from spinglass_tpu_torch.anneal import pt as pt_mod
from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu_torch.utils.monitoring import device_memory_stats


@dataclass
class BenchmarkResult:
    name: str
    problem: str
    size: int
    algorithm: str
    schedule: str
    trial: int
    best_energy: float
    objective: Optional[float]
    feasible: bool
    total_time: float
    sweeps_per_second: float
    spin_flips_per_second: float
    peak_memory_bytes: int = 0

    def to_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class BenchmarkCase:
    name: str
    make_problem: Callable[[], object]   # -> ProblemTemplate
    size: int
    problem_kind: str


def standard_suite(sizes=(20, 50), seed: int = 0,
                   device=None) -> List[BenchmarkCase]:
    """MaxCut / QAP / TSP / scheduling suite (reference
    standard_problems.py:339-500, problem_benchmarks.py:14-292), each
    problem built on ``device``."""
    from spinglass_tpu_torch.problems import (
        MaxCutProblem, QuadraticAssignmentProblem, SchedulingProblem,
        TSPProblem,
    )

    cases: List[BenchmarkCase] = []
    for n in sizes:
        def mk_maxcut(n=n):
            p = MaxCutProblem(device=device)
            p.generate_random_instance(n_nodes=n, density=0.5, seed=seed)
            return p

        cases.append(BenchmarkCase(f"maxcut_{n}", mk_maxcut, n, "maxcut"))

        tsp_n = max(5, n // 4)

        def mk_tsp(tsp_n=tsp_n):
            p = TSPProblem(device=device)
            p.generate_random_instance(n_cities=tsp_n, seed=seed)
            return p

        cases.append(BenchmarkCase(f"tsp_{tsp_n}", mk_tsp, tsp_n, "tsp"))

        qap_n = max(4, n // 5)

        def mk_qap(qap_n=qap_n):
            p = QuadraticAssignmentProblem(device=device)
            p.generate_random_instance(n=qap_n, seed=seed)
            return p

        cases.append(BenchmarkCase(f"qap_{qap_n}", mk_qap, qap_n, "qap"))

        def mk_sched(n=n):
            p = SchedulingProblem(device=device)
            p.generate_random_instance(n_tasks=max(3, n // 8), n_agents=3,
                                       seed=seed)
            return p

        cases.append(BenchmarkCase(f"sched_{n}", mk_sched, n, "scheduling"))
    return cases


ALGORITHMS = ("sa", "pt")
SCHEDULES = (ScheduleType.GEOMETRIC, ScheduleType.LINEAR,
             ScheduleType.ADAPTIVE)


class BenchmarkRunner:
    def __init__(self, n_sweeps: int = 500, n_replicas: int = 32,
                 n_trials: int = 3, use_kernel: str = "auto", device=None):
        self.n_sweeps = n_sweeps
        self.n_replicas = n_replicas
        self.n_trials = n_trials
        self.use_kernel = use_kernel
        self.device = device
        self.results: List[BenchmarkResult] = []

    def _solve(self, template, algorithm: str, schedule: ScheduleType,
               trial: int):
        problem = template.encode_to_ising()
        if algorithm == "sa":
            cfg = SAConfig(
                n_sweeps=self.n_sweeps, n_replicas=self.n_replicas,
                schedule=ScheduleConfig(schedule_type=schedule,
                                        initial_temp=5.0, final_temp=0.01,
                                        total_sweeps=self.n_sweeps),
                use_kernel=self.use_kernel, seed=42 + trial,
                enable_early_stop=False)
            return anneal(problem, cfg)
        if algorithm == "pt":
            cfg = pt_mod.PTConfig(
                n_replicas=min(self.n_replicas, 16), n_sweeps=self.n_sweeps,
                use_kernel=self.use_kernel, seed=42 + trial)
            return pt_mod.run(problem, cfg)
        raise ValueError(algorithm)

    def run_case(self, case: BenchmarkCase, algorithms=ALGORITHMS,
                 schedules=(ScheduleType.GEOMETRIC,)) -> List[BenchmarkResult]:
        out = []
        for algorithm in algorithms:
            for schedule in (schedules if algorithm == "sa"
                             else (ScheduleType.GEOMETRIC,)):
                for trial in range(self.n_trials):
                    template = case.make_problem()
                    t0 = time.perf_counter()
                    res = self._solve(template, algorithm, schedule, trial)
                    dt = time.perf_counter() - t0
                    sol = template.decode_solution(res.best_spins)
                    mem = 0
                    try:
                        stats = device_memory_stats()
                        mem = max((d["peak_bytes_in_use"]
                                   for d in stats.values()), default=0)
                    except Exception:
                        pass
                    out.append(BenchmarkResult(
                        name=case.name, problem=case.problem_kind,
                        size=case.size, algorithm=algorithm,
                        schedule=schedule.value, trial=trial,
                        best_energy=res.best_energy,
                        objective=sol.objective_value,
                        feasible=sol.is_feasible,
                        total_time=dt,
                        sweeps_per_second=res.sweeps_per_second,
                        spin_flips_per_second=res.spin_flips_per_second,
                        peak_memory_bytes=mem))
        self.results.extend(out)
        return out

    def run_suite(self, cases: Optional[List[BenchmarkCase]] = None,
                  **kwargs) -> List[BenchmarkResult]:
        for case in cases or standard_suite(device=self.device):
            self.run_case(case, **kwargs)
        return self.results

    def summary(self) -> dict:
        """Aggregate stats per (problem, algorithm)."""
        groups: dict = {}
        for r in self.results:
            groups.setdefault((r.problem, r.algorithm), []).append(r)
        return {
            f"{p}/{a}": {
                "n": len(rs),
                "best_objective": float(np.min([r.objective for r in rs])),
                "mean_objective": float(np.mean([r.objective for r in rs])),
                "mean_time": float(np.mean([r.total_time for r in rs])),
                "mean_flips_per_sec": float(np.mean(
                    [r.spin_flips_per_second for r in rs])),
                "feasibility_rate": float(np.mean(
                    [r.feasible for r in rs])),
            }
            for (p, a), rs in groups.items()
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"results": [r.to_dict() for r in self.results],
                       "summary": self.summary()}, f, indent=2)
