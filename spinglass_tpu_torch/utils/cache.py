"""Solution / computation caches (reference optimization/performance_cache.py
:43-513 LRUCache/ComputationCache + performance_accelerator.py:25-561
IntelligentCache + fast_memoize).

The counterpart of ``spinglass_tpu.utils.cache``. The captured drivers keep
their graphs per problem and configuration (``anneal.graphs.SA_CACHE`` /
``PT_CACHE``); these caches cover *solutions*: identical (problem, config)
pairs skip re-annealing. The JAX package's persistent XLA compile cache has
no counterpart here."""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from functools import wraps
from typing import Any, Callable, Optional

import numpy as np


class LRUCache:
    """Thread-safe LRU with TTL + hit stats."""

    def __init__(self, max_size: int = 128, ttl: Optional[float] = None):
        self.max_size = max_size
        self.ttl = ttl
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            if key not in self._data:
                self.misses += 1
                return None
            value, ts = self._data[key]
            if self.ttl is not None and time.time() - ts > self.ttl:
                del self._data[key]
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key, value) -> None:
        with self._lock:
            self._data[key] = (value, time.time())
            self._data.move_to_end(key)
            while len(self._data) > self.max_size:
                self._data.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def problem_fingerprint(problem, config=None) -> str:
    """Stable hash of (J, h, config repr) for solution caching. J and h
    (tensors on any device, or arrays) are read to the host once per call,
    as the JAX function reads them."""
    md = hashlib.sha256()
    md.update(np.ascontiguousarray(_host(problem.j)).tobytes())
    md.update(np.ascontiguousarray(_host(problem.h)).tobytes())
    if config is not None:
        md.update(repr(config).encode())
    return md.hexdigest()


_solution_cache = LRUCache(max_size=64)


def cached_anneal(problem, config=None, *, cache: Optional[LRUCache] = None,
                  anneal_fn: Optional[Callable] = None):
    """anneal() with solution caching keyed by (J, h, config)."""
    from spinglass_tpu_torch.anneal.sa import anneal as _anneal

    cache = cache or _solution_cache
    fn = anneal_fn or _anneal
    key = problem_fingerprint(problem, config)
    hit = cache.get(key)
    if hit is not None:
        return hit
    result = fn(problem, config)
    cache.put(key, result)
    return result


def memoize(max_size: int = 128, ttl: Optional[float] = None):
    """Hashable-arg memoization decorator (reference fast_memoize)."""

    def decorator(fn):
        cache = LRUCache(max_size=max_size, ttl=ttl)

        @wraps(fn)
        def wrapper(*args, **kwargs):
            key = (args, tuple(sorted(kwargs.items())))
            hit = cache.get(key)
            if hit is not None:
                return hit
            out = fn(*args, **kwargs)
            cache.put(key, out)
            return out

        wrapper.cache = cache  # type: ignore[attr-defined]
        return wrapper

    return decorator


def anneal_cache_stats(cache: Optional[LRUCache] = None) -> dict:
    """Stats for the global solution cache (reference AdvancedCLI cache
    commands, cli/advanced_cli.py; performance_cache.py:43-513 stats)."""
    c = cache or _solution_cache
    return {
        "size": len(c._data),
        "max_size": c.max_size,
        "hits": c.hits,
        "misses": c.misses,
        "hit_rate": c.hit_rate,
    }
