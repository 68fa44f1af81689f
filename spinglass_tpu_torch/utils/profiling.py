"""Profiling: per-phase timers + torch.profiler trace hooks.

The counterpart of ``spinglass_tpu.utils.profiling``: the phase timers are
copied (reference utils/performance.py:386-543, PerformanceProfiler +
@profile); ``device_trace`` records the host and the card with
``torch.profiler`` and writes a chrome trace into ``log_dir`` (the JAX
package's ``jax.profiler`` trace for XProf/TensorBoard)."""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import numpy as np


class PerformanceProfiler:
    def __init__(self):
        self.records: dict[str, list] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(
                time.perf_counter() - t0)

    def profile(self, fn=None, *, name: Optional[str] = None):
        """Decorator form (reference @profile, utils/performance.py:671)."""
        def deco(f):
            label = name or f.__qualname__

            @functools.wraps(f)
            def wrapper(*args, **kwargs):
                with self.phase(label):
                    return f(*args, **kwargs)

            return wrapper

        return deco(fn) if fn is not None else deco

    def summary(self) -> dict:
        return {
            k: {"n": len(v), "total_s": float(np.sum(v)),
                "mean_s": float(np.mean(v)),
                "p50_s": float(np.percentile(v, 50)),
                "max_s": float(np.max(v))}
            for k, v in self.records.items()
        }

    def reset(self) -> None:
        self.records.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace context (CPU activity, and CUDA where a card is
    visible); on exit writes ``log_dir/trace.json`` (chrome://tracing,
    Perfetto). Yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


global_profiler = PerformanceProfiler()
