"""Experimental validation: multi-seed trials, significance tests, reports.

A copy of ``spinglass_tpu.research.validation``, which is numpy only: Welch
t-tests, Cohen's d effect sizes, bootstrap confidence intervals, and an
experiment runner that compares algorithms over seeded trials and emits a
JSON report (no scipy; the normal-approximation p-value is accurate for the
trial counts involved). The port keeps its own copy because importing
``spinglass_tpu`` pulls in JAX."""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


def welch_t(a, b) -> dict:
    """Welch's t-test with normal-approx two-sided p-value."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    va, vb = a.var(ddof=1), b.var(ddof=1)
    na, nb = len(a), len(b)
    se = math.sqrt(va / na + vb / nb) or 1e-12
    t = (a.mean() - b.mean()) / se
    # normal approximation of the two-sided p-value
    p = math.erfc(abs(t) / math.sqrt(2.0))
    return {"t": float(t), "p_value": float(p)}


def cohens_d(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    na, nb = len(a), len(b)
    pooled = math.sqrt(((na - 1) * a.var(ddof=1) + (nb - 1) * b.var(ddof=1))
                       / max(na + nb - 2, 1)) or 1e-12
    return float((a.mean() - b.mean()) / pooled)


def bootstrap_ci(x, n_boot: int = 2000, alpha: float = 0.05,
                 seed: int = 0) -> tuple:
    x = np.asarray(x, float)
    rng = np.random.default_rng(seed)
    means = rng.choice(x, size=(n_boot, len(x)), replace=True).mean(axis=1)
    lo, hi = np.percentile(means, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return float(lo), float(hi)


@dataclass
class TrialResult:
    algorithm: str
    seed: int
    best_energy: float
    runtime: float


class ExperimentalValidation:
    """Run algorithms over seeds on shared instances; analyze significance."""

    def __init__(self, n_trials: int = 6, base_seed: int = 42):
        self.n_trials = n_trials
        self.base_seed = base_seed
        self.trials: List[TrialResult] = []

    def run(self, problem, algorithms: Dict[str, Callable]) -> "ExperimentalValidation":
        """algorithms: name -> fn(problem, seed) -> AnnealResult-like with
        .best_energy."""
        for name, fn in algorithms.items():
            for t in range(self.n_trials):
                seed = self.base_seed + t
                t0 = time.perf_counter()
                res = fn(problem, seed)
                self.trials.append(TrialResult(
                    algorithm=name, seed=seed,
                    best_energy=float(res.best_energy),
                    runtime=time.perf_counter() - t0))
        return self

    def energies(self, algorithm: str) -> np.ndarray:
        return np.asarray([t.best_energy for t in self.trials
                           if t.algorithm == algorithm])

    def analyze(self, baseline: Optional[str] = None) -> dict:
        algos = sorted({t.algorithm for t in self.trials})
        baseline = baseline or algos[0]
        base = self.energies(baseline)
        out = {"baseline": baseline, "n_trials": self.n_trials,
               "algorithms": {}}
        for a in algos:
            e = self.energies(a)
            entry = {
                "mean_best_energy": float(e.mean()),
                "std_best_energy": float(e.std(ddof=1)) if len(e) > 1 else 0.0,
                "min_best_energy": float(e.min()),
                "ci95": bootstrap_ci(e),
                "mean_runtime": float(np.mean(
                    [t.runtime for t in self.trials if t.algorithm == a])),
            }
            if a != baseline:
                entry["vs_baseline"] = {
                    **welch_t(e, base),
                    "effect_size_d": cohens_d(e, base),
                    "improvement": float(base.mean() - e.mean()),
                }
            out["algorithms"][a] = entry
        return out

    def report(self, path: Optional[str] = None) -> dict:
        rep = {
            "analysis": self.analyze(),
            "trials": [t.__dict__ for t in self.trials],
        }
        if path:
            with open(path, "w") as f:
                json.dump(rep, f, indent=2)
        return rep
