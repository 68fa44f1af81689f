"""MC-trajectory analysis: autocorrelation time + equilibration detection.

A copy of ``spinglass_tpu.core.dynamics_analysis`` (the port imports
nothing of the JAX package): integrated autocorrelation time of an energy
series and a two-window equilibration test. Host-side numpy over recorded
histories; ``anneal.pt.tune_ladder`` gates its pilot runs on
``is_equilibrated``."""

from __future__ import annotations

import numpy as np


def autocorrelation(series: np.ndarray, max_lag: int = 100) -> np.ndarray:
    """Normalized autocorrelation function C(t) of a scalar series."""
    x = np.asarray(series, float)
    x = x - x.mean()
    n = len(x)
    var = x.var()
    if var == 0 or n < 2:
        return np.ones(1)
    max_lag = min(max_lag, n - 1)
    acf = np.empty(max_lag + 1)
    for lag in range(max_lag + 1):
        acf[lag] = np.dot(x[: n - lag], x[lag:]) / ((n - lag) * var)
    return acf


def integrated_autocorrelation_time(series: np.ndarray,
                                    max_lag: int = 100) -> float:
    """tau_int = 1/2 + sum C(t), truncated at the first negative C
    (standard windowing; reference spin_dynamics.py:361-392)."""
    acf = autocorrelation(series, max_lag)
    tau = 0.5
    for c in acf[1:]:
        if c <= 0:
            break
        tau += c
    return float(tau)


def effective_sample_size(series: np.ndarray) -> float:
    tau = integrated_autocorrelation_time(series)
    return len(series) / (2.0 * tau)


def is_equilibrated(series: np.ndarray, window_fraction: float = 0.25,
                    z_threshold: float = 2.0) -> bool:
    """Two-window mean comparison: the first and last window_fraction of the
    series must agree within z_threshold combined standard errors
    (reference equilibrium t-test check, spin_dynamics.py:394-421)."""
    x = np.asarray(series, float)
    w = max(int(len(x) * window_fraction), 2)
    if len(x) < 2 * w:
        return False
    a, b = x[:w], x[-w:]
    tau_a = integrated_autocorrelation_time(a, max_lag=w - 1)
    tau_b = integrated_autocorrelation_time(b, max_lag=w - 1)
    se = np.sqrt(a.var() * 2 * tau_a / w + b.var() * 2 * tau_b / w)
    if se == 0:
        return bool(abs(a.mean() - b.mean()) < 1e-12)
    return bool(abs(a.mean() - b.mean()) / se < z_threshold)
