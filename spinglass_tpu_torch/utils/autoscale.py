"""Auto-scaling policies: workload prediction + resource allocation.

Copied from ``spinglass_tpu.utils.autoscale``: the port imports nothing of
the JAX package.

Rebuilds the reference's scaling tier — AdaptiveScaler/MultiObjectiveScaler
(optimization/adaptive_scaling.py:57-466) and the workload predictor +
allocator of scaling/intelligent_auto_scaling.py:81-713 — for the
accelerator runtime. The scalable resources here are not thread pools but
the captured workload's shape knobs:

  * n_replicas     — replica batch per device (throughput vs memory),
  * batch_size     — problems stacked per launch (anneal/batch.py),
  * sweep_chunk    — sweeps per replayed chunk (latency vs launch overhead).

Decisions are pure functions of observed utilization, so they are testable
without hardware and the caller applies them between captured chunks (shape
changes trigger new captures — the policies therefore quantize targets to
power-of-two steps and rate-limit changes, unlike the reference's per-tick
thread-pool resizes).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


def _pow2_quantize(x: float, lo: int, hi: int) -> int:
    v = lo
    while v * 2 <= min(x, hi):
        v *= 2
    return v


class WorkloadPredictor:
    """Short-horizon load forecast (reference WorkloadPredictor,
    intelligent_auto_scaling.py:81-210): EWMA level + trend (Holt's linear)
    over observed queue depth / request rate."""

    def __init__(self, alpha: float = 0.4, beta: float = 0.2,
                 history: int = 256):
        self.alpha = alpha
        self.beta = beta
        self.level: Optional[float] = None
        self.trend: float = 0.0
        self.history: deque = deque(maxlen=history)

    def observe(self, load: float) -> None:
        self.history.append((time.time(), load))
        if self.level is None:
            self.level = load
            return
        prev = self.level
        self.level = self.alpha * load + (1 - self.alpha) * (
            self.level + self.trend)
        self.trend = self.beta * (self.level - prev) + (
            1 - self.beta) * self.trend

    def predict(self, steps_ahead: int = 1) -> float:
        if self.level is None:
            return 0.0
        return max(0.0, self.level + steps_ahead * self.trend)


@dataclass
class ScalingDecision:
    resource: str
    current: int
    target: int
    reason: str

    @property
    def changed(self) -> bool:
        return self.current != self.target


@dataclass
class ScalingLimits:
    min_replicas: int = 64
    max_replicas: int = 4096
    min_batch: int = 1
    max_batch: int = 64
    min_chunk: int = 50
    max_chunk: int = 2000


class AdaptiveScaler:
    """Threshold policy engine (reference AdaptiveScaler,
    adaptive_scaling.py:57-248): scale up when utilization is high and HBM
    has headroom, scale down under memory pressure; changes are quantized to
    power-of-two replica counts and rate-limited by `cooldown_s`."""

    def __init__(self, limits: Optional[ScalingLimits] = None,
                 high_util: float = 0.85, low_util: float = 0.30,
                 mem_ceiling: float = 0.85, cooldown_s: float = 10.0):
        self.limits = limits or ScalingLimits()
        self.high_util = high_util
        self.low_util = low_util
        self.mem_ceiling = mem_ceiling
        self.cooldown_s = cooldown_s
        self._last_change = 0.0
        self.decisions: List[ScalingDecision] = []

    def decide(self, *, n_replicas: int, utilization: float,
               hbm_used_fraction: float,
               queue_depth: int = 0, now: Optional[float] = None
               ) -> ScalingDecision:
        now = time.time() if now is None else now
        lim = self.limits
        target = n_replicas
        reason = "steady"
        if hbm_used_fraction > self.mem_ceiling:
            target = max(lim.min_replicas, n_replicas // 2)
            reason = f"hbm {hbm_used_fraction:.0%} > {self.mem_ceiling:.0%}"
        elif now - self._last_change < self.cooldown_s:
            reason = "cooldown"
        elif utilization > self.high_util and queue_depth > 0:
            target = _pow2_quantize(n_replicas * 2, lim.min_replicas,
                                    lim.max_replicas)
            reason = f"util {utilization:.0%} high, queue {queue_depth}"
        elif utilization < self.low_util and n_replicas > lim.min_replicas:
            target = max(lim.min_replicas, n_replicas // 2)
            reason = f"util {utilization:.0%} low"
        decision = ScalingDecision("n_replicas", n_replicas, target, reason)
        if decision.changed:
            self._last_change = now
        self.decisions.append(decision)
        return decision


class MultiObjectiveScaler:
    """Weighted multi-objective policy (reference MultiObjectiveScaler,
    adaptive_scaling.py:249-466): scores candidate configurations on
    throughput, latency, and memory objectives and picks the argmax.

    Candidate shape knobs are enumerated, scored with normalized objective
    models fit from observed samples, and combined with the configured
    weights — the accelerator analog of the reference's thread/batch grid.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 limits: Optional[ScalingLimits] = None):
        self.weights = weights or {
            "throughput": 0.5, "latency": 0.3, "memory": 0.2}
        self.limits = limits or ScalingLimits()
        # observed (n_replicas, sweep_chunk) -> flips/s samples
        self._samples: Dict[tuple, float] = {}

    def observe(self, n_replicas: int, sweep_chunk: int,
                flips_per_s: float) -> None:
        self._samples[(n_replicas, sweep_chunk)] = flips_per_s

    def _throughput_model(self, n_replicas: int, sweep_chunk: int) -> float:
        if self._samples:
            # nearest observed sample, scaled by replica ratio (sub-linear)
            key = min(self._samples,
                      key=lambda k: abs(k[0] - n_replicas)
                      + abs(k[1] - sweep_chunk))
            base = self._samples[key]
            return base * (n_replicas / key[0]) ** 0.8
        return float(n_replicas * sweep_chunk)

    def decide(self, *, hbm_bytes_per_replica: float, hbm_budget: float,
               target_latency_s: float = 1.0,
               sweep_time_s: float = 1e-4) -> dict:
        lim = self.limits
        best, best_score = None, -float("inf")
        r = lim.min_replicas
        while r <= lim.max_replicas:
            for chunk in (lim.min_chunk, (lim.min_chunk + lim.max_chunk) // 2,
                          lim.max_chunk):
                mem = r * hbm_bytes_per_replica
                if mem > hbm_budget:
                    continue
                thr = self._throughput_model(r, chunk)
                latency = chunk * sweep_time_s
                score = (
                    self.weights["throughput"] * thr
                    / max(self._throughput_model(
                        lim.max_replicas, lim.max_chunk), 1e-9)
                    - self.weights["latency"]
                    * max(0.0, latency / target_latency_s - 1.0)
                    - self.weights["memory"] * mem / hbm_budget)
                if score > best_score:
                    best_score = score
                    best = {"n_replicas": r, "sweep_chunk": chunk,
                            "score": score, "est_hbm": mem}
            r *= 2
        return best or {"n_replicas": lim.min_replicas,
                        "sweep_chunk": lim.min_chunk, "score": 0.0,
                        "est_hbm": 0.0}


class AutoScalingManager:
    """Predictor + policy wiring (reference AutoScalingManager,
    adaptive_optimization.py and intelligent_auto_scaling.py:400-713):
    observe load each tick, let the predictor anticipate the next window,
    and drive the AdaptiveScaler with the predicted queue."""

    def __init__(self, scaler: Optional[AdaptiveScaler] = None,
                 predictor: Optional[WorkloadPredictor] = None):
        self.scaler = scaler or AdaptiveScaler()
        self.predictor = predictor or WorkloadPredictor()

    def tick(self, *, n_replicas: int, utilization: float,
             hbm_used_fraction: float, queue_depth: int) -> ScalingDecision:
        self.predictor.observe(float(queue_depth))
        predicted = int(round(self.predictor.predict(steps_ahead=2)))
        return self.scaler.decide(
            n_replicas=n_replicas, utilization=utilization,
            hbm_used_fraction=hbm_used_fraction,
            queue_depth=max(queue_depth, predicted))
