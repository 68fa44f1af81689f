"""Adaptive monitoring: metric anomaly detection + self-healing actions.

Copied from ``spinglass_tpu.utils.anomaly``: the port imports nothing of
the JAX package.

Rebuilds the reference's adaptive monitoring tier — AnomalyDetector and
SelfHealingSystem (monitoring/adaptive_monitoring_system.py:229-452) and the
AdaptiveMonitoringSystem facade (:229-691) — for the accelerator runtime:
the metrics that matter here are sweep throughput, device-dispatch latency,
device-memory headroom, and acceptance-rate collapse, and the healing actions
adjust solver-side knobs (shrink replica batch, clear captured-step caches,
re-make engines) instead of the reference's thread-pool restarts.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from spinglass_tpu_torch.utils.logging import get_logger

logger = get_logger()


@dataclass
class Anomaly:
    metric: str
    kind: str          # "spike" | "drop" | "drift" | "stuck"
    value: float
    zscore: float
    ts: float = field(default_factory=time.time)


class AnomalyDetector:
    """Streaming per-metric detector (reference AnomalyDetector,
    adaptive_monitoring_system.py:229-336).

    Keeps an EWMA mean/variance per metric; flags
      * spike/drop — |z| > z_threshold against the EWMA band,
      * drift — EWMA itself moved > drift_fraction from its long baseline,
      * stuck — identical value repeated `stuck_after` times (a hung sampler).
    """

    def __init__(self, alpha: float = 0.2, z_threshold: float = 4.0,
                 drift_fraction: float = 0.5, stuck_after: int = 8,
                 warmup: int = 5):
        self.alpha = alpha
        self.z_threshold = z_threshold
        self.drift_fraction = drift_fraction
        self.stuck_after = stuck_after
        self.warmup = warmup
        self._state: Dict[str, dict] = {}

    def observe(self, metric: str, value: float) -> Optional[Anomaly]:
        st = self._state.setdefault(metric, {
            "mean": value, "var": 0.0, "baseline": value, "n": 0,
            "last": value, "repeats": 0,
        })
        st["n"] += 1
        if value == st["last"]:
            st["repeats"] += 1
        else:
            st["repeats"] = 0
        st["last"] = value

        std = math.sqrt(max(st["var"], 1e-12))
        z = (value - st["mean"]) / std if st["n"] > self.warmup else 0.0

        anomaly = None
        if st["n"] > self.warmup and abs(z) > self.z_threshold:
            anomaly = Anomaly(metric, "spike" if z > 0 else "drop", value, z)
        elif st["repeats"] >= self.stuck_after:
            anomaly = Anomaly(metric, "stuck", value, 0.0)
            st["repeats"] = 0

        # EWMA update after the test so the anomaly doesn't mask itself
        d = value - st["mean"]
        st["mean"] += self.alpha * d
        st["var"] = (1 - self.alpha) * (st["var"] + self.alpha * d * d)
        if st["n"] == self.warmup:
            st["baseline"] = st["mean"]
        if (anomaly is None and st["n"] > 2 * self.warmup
                and abs(st["baseline"]) > 1e-12):
            rel = abs(st["mean"] - st["baseline"]) / abs(st["baseline"])
            if rel > self.drift_fraction:
                anomaly = Anomaly(metric, "drift", value, z)
                st["baseline"] = st["mean"]  # re-anchor after reporting
        return anomaly

    def stats(self, metric: str) -> dict:
        return dict(self._state.get(metric, {}))


class SelfHealingSystem:
    """Healing actions keyed by (metric, anomaly kind) patterns (reference
    SelfHealingSystem, adaptive_monitoring_system.py:337-452). Actions are
    plain callables; registration order is priority order. Each firing is
    journaled so repeated failures surface in `report()`."""

    def __init__(self, max_attempts_per_metric: int = 3):
        self.max_attempts = max_attempts_per_metric
        self._actions: List[dict] = []
        self.journal: deque = deque(maxlen=256)
        self._attempts: Dict[str, int] = {}

    def register(self, metric_pattern: str, kind: str,
                 action: Callable[[Anomaly], None], name: str = "") -> None:
        self._actions.append({
            "pattern": metric_pattern, "kind": kind, "action": action,
            "name": name or getattr(action, "__name__", "action"),
        })

    def handle(self, anomaly: Anomaly) -> bool:
        attempts = self._attempts.get(anomaly.metric, 0)
        if attempts >= self.max_attempts:
            return False
        for entry in self._actions:
            if entry["kind"] not in (anomaly.kind, "*"):
                continue
            if not _pattern_match(entry["pattern"], anomaly.metric):
                continue
            self._attempts[anomaly.metric] = attempts + 1
            try:
                entry["action"](anomaly)
                self.journal.append({
                    "ts": anomaly.ts, "metric": anomaly.metric,
                    "kind": anomaly.kind, "action": entry["name"],
                    "ok": True,
                })
                logger.info("self-heal %s on %s/%s", entry["name"],
                            anomaly.metric, anomaly.kind)
                return True
            except Exception as exc:  # pragma: no cover - defensive
                self.journal.append({
                    "ts": anomaly.ts, "metric": anomaly.metric,
                    "kind": anomaly.kind, "action": entry["name"],
                    "ok": False, "error": str(exc),
                })
        return False

    def reset_attempts(self, metric: str) -> None:
        self._attempts.pop(metric, None)

    def report(self) -> dict:
        entries = list(self.journal)
        return {
            "n_healings": sum(1 for e in entries if e["ok"]),
            "n_failures": sum(1 for e in entries if not e["ok"]),
            "recent": entries[-10:],
        }


def _pattern_match(pattern: str, metric: str) -> bool:
    if pattern in ("*", metric):
        return True
    if pattern.endswith("*"):
        return metric.startswith(pattern[:-1])
    return False


class AdaptiveMonitoringSystem:
    """Facade: feed metrics, get anomalies detected and healed (reference
    AdaptiveMonitoringSystem, adaptive_monitoring_system.py:229-691)."""

    def __init__(self, detector: Optional[AnomalyDetector] = None,
                 healer: Optional[SelfHealingSystem] = None):
        self.detector = detector or AnomalyDetector()
        self.healer = healer or SelfHealingSystem()
        self.anomalies: deque = deque(maxlen=512)

    def record(self, metric: str, value: float) -> Optional[Anomaly]:
        anomaly = self.detector.observe(metric, value)
        if anomaly is not None:
            self.anomalies.append(anomaly)
            self.healer.handle(anomaly)
        return anomaly

    def record_many(self, metrics: Dict[str, float]) -> List[Anomaly]:
        return [a for k, v in sorted(metrics.items())
                if (a := self.record(k, v)) is not None]

    def report(self) -> dict:
        return {
            "n_anomalies": len(self.anomalies),
            "by_kind": _count_by(self.anomalies, "kind"),
            "healing": self.healer.report(),
        }


def _count_by(items, attr: str) -> dict:
    out: Dict[str, int] = {}
    for it in items:
        k = getattr(it, attr)
        out[k] = out.get(k, 0) + 1
    return out
