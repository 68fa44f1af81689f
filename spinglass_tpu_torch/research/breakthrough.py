"""Breakthrough-algorithms tier: named annealer variants and a validation
runner.

The counterpart of ``spinglass_tpu.research.breakthrough``:
AdaptiveNeuralAnnealer, QuantumErrorCorrectedAnnealer,
FederatedOptimizationNetwork and BreakthroughResearchFramework, the harness
that runs baseline SA against each variant over repeated trials with
significance statistics. Each annealer is a thin, uniformly shaped class
over the port's implementations (``research.novel``,
``research.federated``), so every trial anneals through K1 on the card.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.research.federated import (FederatedAnnealingServer,
                                                    FederatedConfig)
from spinglass_tpu_torch.research.novel import (
    LESDConfig, QECConfig, learning_enhanced_dynamics,
    quantum_error_corrected_annealing)
from spinglass_tpu_torch.research.validation import (ExperimentalValidation,
                                                     welch_t)


@dataclass(frozen=True)
class BreakthroughConfig:
    """The JAX ``BreakthroughConfig`` with ``use_pallas`` renamed
    ``use_kernel``."""

    n_sweeps: int = 300
    n_replicas: int = 8
    use_kernel: str = "auto"


class AdaptiveNeuralAnnealer:
    """NN-guided annealer (reference AdaptiveNeuralAnnealer,
    breakthrough_algorithms.py:55-161): a small network learns which spins
    to propose from running features, implemented by the
    learning-enhanced spin dynamics (research/novel.py
    learning_enhanced_dynamics, the same capability the reference's LESD
    class carries)."""

    name = "adaptive_neural"

    def __init__(self, cfg: Optional[BreakthroughConfig] = None):
        self.cfg = cfg or BreakthroughConfig()

    def solve(self, problem: IsingProblem, seed: int = 42):
        return learning_enhanced_dynamics(problem, LESDConfig(
            n_iterations=self.cfg.n_sweeps, n_replicas=self.cfg.n_replicas,
            seed=seed))


class QuantumErrorCorrectedAnnealer:
    """Redundant-encoding annealer (reference QuantumErrorCorrectedAnnealer,
    breakthrough_algorithms.py:162-279): anneal k noisy logical copies,
    decode by majority vote (research/novel.py
    quantum_error_corrected_annealing)."""

    name = "quantum_error_corrected"

    def __init__(self, cfg: Optional[BreakthroughConfig] = None,
                 repetition: int = 3):
        self.cfg = cfg or BreakthroughConfig()
        self.repetition = repetition

    def solve(self, problem: IsingProblem, seed: int = 42):
        return quantum_error_corrected_annealing(problem, QECConfig(
            repetition=self.repetition, n_sweeps=self.cfg.n_sweeps,
            n_replicas=self.cfg.n_replicas, seed=seed))


class FederatedOptimizationNetwork:
    """Federated multi-client optimization (reference
    FederatedOptimizationNetwork, breakthrough_algorithms.py:280-497):
    clients anneal locally, a server FedAvgs schedule hyperparameters
    weighted by improvement (research/federated.py). ``solve`` runs the
    single-problem degenerate network (every client holds the same
    instance), which is what the reference's validation harness measured."""

    name = "federated"

    def __init__(self, cfg: Optional[BreakthroughConfig] = None,
                 n_clients: int = 3, n_rounds: int = 2):
        self.cfg = cfg or BreakthroughConfig()
        self.n_clients = n_clients
        self.n_rounds = n_rounds

    def solve(self, problem: IsingProblem, seed: int = 42):
        server = FederatedAnnealingServer(FederatedConfig(
            n_rounds=self.n_rounds,
            local_sweeps=max(1, self.cfg.n_sweeps // self.n_rounds),
            n_replicas=self.cfg.n_replicas, seed=seed))
        out = server.run([problem] * self.n_clients)
        return _FederatedResult(best_energy=float(min(out["final_best"])),
                                detail=out)


@dataclass
class _FederatedResult:
    best_energy: float
    detail: dict = field(default_factory=dict)


def _baseline_sa(cfg: BreakthroughConfig):
    def run(problem: IsingProblem, seed: int = 42):
        return anneal(problem, SAConfig(
            n_sweeps=cfg.n_sweeps, n_replicas=cfg.n_replicas,
            schedule=ScheduleConfig(ScheduleType.GEOMETRIC,
                                    initial_temp=5.0, final_temp=0.01,
                                    total_sweeps=cfg.n_sweeps),
            use_kernel=cfg.use_kernel, enable_early_stop=False, seed=seed))
    return run


class BreakthroughResearchFramework:
    """Validation harness (reference BreakthroughResearchFramework,
    breakthrough_algorithms.py:498-1001): runs baseline SA and each
    breakthrough annealer over ``n_trials`` seeds on a shared instance and
    reports per-algorithm statistics + Welch significance vs the baseline —
    the format of the reference's breakthrough_validation_results.json."""

    def __init__(self, cfg: Optional[BreakthroughConfig] = None,
                 n_trials: int = 4, base_seed: int = 42,
                 annealers: Optional[Sequence] = None):
        self.cfg = cfg or BreakthroughConfig()
        self.n_trials = n_trials
        self.base_seed = base_seed
        self.annealers = list(annealers) if annealers is not None else [
            AdaptiveNeuralAnnealer(self.cfg),
            QuantumErrorCorrectedAnnealer(self.cfg),
            FederatedOptimizationNetwork(self.cfg),
        ]
        self.results: Optional[dict] = None

    def algorithms(self) -> Dict[str, Callable]:
        algos = {"baseline": _baseline_sa(self.cfg)}
        for a in self.annealers:
            algos[a.name] = a.solve
        return algos

    def validate(self, problem: IsingProblem) -> dict:
        val = ExperimentalValidation(n_trials=self.n_trials,
                                     base_seed=self.base_seed)
        t0 = time.perf_counter()
        val.run(problem, self.algorithms())
        report = val.analyze(baseline="baseline")
        base = val.energies("baseline")
        for name, entry in report["algorithms"].items():
            if name == "baseline":
                entry["significant_vs_baseline"] = None
                continue
            t = welch_t(val.energies(name), base)
            entry["welch_t"] = t
            entry["significant_vs_baseline"] = bool(
                t.get("p_value", 1.0) < 0.05)
        report["total_time"] = time.perf_counter() - t0
        report["problem"] = {"n_spins": problem.n_spins}
        self.results = report
        return report

    def save(self, path: str) -> None:
        if self.results is None:
            raise ValueError("validate() has not been run")
        with open(path, "w") as f:
            json.dump(self.results, f, indent=2, default=float)
