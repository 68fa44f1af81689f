"""Runtime monitoring: resource sampling, circuit breaker, health snapshot.

The counterpart of ``spinglass_tpu.utils.monitoring`` (the rest is copied):
host psutil sampling in a background thread, device memory of each visible
CUDA card from ``torch.cuda``, per-operation counters, and a circuit breaker
for retryable device work."""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from spinglass_tpu_torch.utils.exceptions import AnnealingError


def device_memory_stats() -> dict:
    """Per-card memory stats under the JAX package's keys, by device name
    ("cuda:0", ...): ``bytes_in_use`` (the caching allocator's live bytes,
    ``torch.cuda.memory_stats``), ``bytes_limit`` (the card's total memory,
    ``torch.cuda.mem_get_info``), ``peak_bytes_in_use``
    (``torch.cuda.max_memory_allocated``), and ``bytes_free`` (the driver's
    free bytes, which also count other processes). ``{}`` without a card."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(total),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            "bytes_free": int(free),
        }
    return out


def host_stats() -> dict:
    try:
        import psutil

        vm = psutil.virtual_memory()
        return {
            "cpu_percent": psutil.cpu_percent(interval=None),
            "mem_used_gb": vm.used / 1e9,
            "mem_percent": vm.percent,
        }
    except ImportError:
        return {}


class PerformanceMonitor:
    """Background sampler thread (reference utils/monitoring.py:39-295)."""

    def __init__(self, interval: float = 5.0, history: int = 720):
        self.interval = interval
        self.samples: deque = deque(maxlen=history)
        self.counters: dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PerformanceMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.interval)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            sample = {"ts": time.time(), **host_stats()}
            try:
                sample["device"] = device_memory_stats()
            except Exception:
                pass
            with self._lock:
                self.samples.append(sample)

    def record(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "n_samples": len(self.samples),
                "latest": self.samples[-1] if self.samples else None,
                "counters": dict(self.counters),
            }


@dataclass
class CircuitBreaker:
    """Trip after repeated failures; half-open after a cooldown
    (reference utils/advanced_monitoring.py:80-166)."""

    failure_threshold: int = 5
    cooldown_seconds: float = 30.0
    _failures: int = 0
    _opened_at: Optional[float] = None

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if time.time() - self._opened_at >= self.cooldown_seconds:
            return "half_open"
        return "open"

    def call(self, fn: Callable, *args, **kwargs):
        if self.state == "open":
            raise AnnealingError(
                f"circuit open ({self._failures} consecutive failures)")
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = time.time()
            raise
        self._failures = 0
        self._opened_at = None
        return out


_global_monitor: Optional[PerformanceMonitor] = None


def global_monitor() -> PerformanceMonitor:
    """Lazy global (reference global_performance_monitor,
    comprehensive_monitoring.py:47)."""
    global _global_monitor
    if _global_monitor is None:
        _global_monitor = PerformanceMonitor()
    return _global_monitor
