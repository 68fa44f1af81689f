"""Scaling-law analysis: runtime/quality fits over problem size.

A copy of ``spinglass_tpu.research.scaling``, which is numpy only: measure
an algorithm across sizes, fit power and exponential laws, and report the
better fit. The port keeps its own copy because importing ``spinglass_tpu``
pulls in JAX."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np


@dataclass
class ScalingPoint:
    size: int
    runtime: float
    best_energy: float
    metric: float = 0.0     # e.g. flips/s


def fit_power_law(sizes, values):
    """value ~ a * size^b via log-log least squares. Returns (a, b, r2)."""
    x = np.log(np.asarray(sizes, float))
    y = np.log(np.maximum(np.asarray(values, float), 1e-12))
    b, loga = np.polyfit(x, y, 1)
    pred = loga + b * x
    ss_res = np.sum((y - pred) ** 2)
    ss_tot = np.sum((y - y.mean()) ** 2) or 1e-12
    return float(np.exp(loga)), float(b), float(1 - ss_res / ss_tot)


def fit_exponential(sizes, values):
    """value ~ a * exp(b * size). Returns (a, b, r2)."""
    x = np.asarray(sizes, float)
    y = np.log(np.maximum(np.asarray(values, float), 1e-12))
    b, loga = np.polyfit(x, y, 1)
    pred = loga + b * x
    ss_res = np.sum((y - pred) ** 2)
    ss_tot = np.sum((y - y.mean()) ** 2) or 1e-12
    return float(np.exp(loga)), float(b), float(1 - ss_res / ss_tot)


class ScalingAnalyzer:
    """Run fn(size) -> result over sizes, fit runtime scaling."""

    def __init__(self):
        self.points: List[ScalingPoint] = []

    def measure(self, solve_fn: Callable[[int], object],
                sizes: Sequence[int], n_trials: int = 1) -> "ScalingAnalyzer":
        for n in sizes:
            times, energies = [], []
            for _ in range(n_trials):
                t0 = time.perf_counter()
                res = solve_fn(n)
                times.append(time.perf_counter() - t0)
                energies.append(getattr(res, "best_energy", float("nan")))
            self.points.append(ScalingPoint(
                size=n, runtime=float(np.median(times)),
                best_energy=float(np.min(energies))))
        return self

    def analyze(self) -> dict:
        sizes = [p.size for p in self.points]
        times = [p.runtime for p in self.points]
        a_p, b_p, r2_p = fit_power_law(sizes, times)
        a_e, b_e, r2_e = fit_exponential(sizes, times)
        best = "power" if r2_p >= r2_e else "exponential"
        return {
            "points": [p.__dict__ for p in self.points],
            "power_law": {"a": a_p, "exponent": b_p, "r2": r2_p},
            "exponential": {"a": a_e, "rate": b_e, "r2": r2_e},
            "best_fit": best,
            "complexity_estimate": (
                f"O(n^{b_p:.2f})" if best == "power"
                else f"O(e^{b_e:.3g} n)"),
        }
