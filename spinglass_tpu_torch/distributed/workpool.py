"""Work-stealing host-side worker pool for many-problem workloads.

Rebuilds the reference's work-stealing layer — AdaptiveCache/
WorkStealingQueue/WorkerPool (optimization/high_performance_scaling.py:99-
1034) — as the host orchestration tier around the solvers: workers
own per-worker deques of problem jobs, idle workers steal from the tail of
the busiest peer, and results stream back through a thread-safe collector.

On the card this layer is for HOST work (encode, decode, IO, per-problem
driver calls: the drivers take ``anneal.graphs.DRIVER_LOCK``, so their
device work runs one call at a time); device throughput comes from batching
replicas inside one launch (anneal/batch.py), not from threads. The pool is
still useful for heterogeneous problem sets whose encode/decode dominates,
and for CPU runs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence


@dataclass
class WorkItem:
    job_id: int
    fn: Callable[[], Any]
    result: Any = None
    error: Optional[str] = None
    done: bool = False


class WorkStealingQueue:
    """Per-worker deque: owner pushes/pops LIFO at the head (cache-warm),
    thieves steal FIFO from the tail (reference WorkStealingQueue,
    high_performance_scaling.py:~200)."""

    def __init__(self):
        self._dq: deque = deque()
        self._lock = threading.Lock()

    def push(self, item: WorkItem) -> None:
        with self._lock:
            self._dq.appendleft(item)

    def pop(self) -> Optional[WorkItem]:
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def steal(self) -> Optional[WorkItem]:
        with self._lock:
            return self._dq.pop() if self._dq else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


class WorkerPool:
    """Fixed worker threads over work-stealing queues (reference WorkerPool,
    high_performance_scaling.py:~300-500). `map(fns)` distributes round-robin
    and blocks until all jobs finish; per-worker executed/stolen counters
    expose the stealing behavior for tests and monitoring."""

    def __init__(self, n_workers: int = 4):
        self.n_workers = max(1, n_workers)
        self.queues = [WorkStealingQueue() for _ in range(self.n_workers)]
        self.stats = [{"executed": 0, "stolen": 0} for _ in range(self.n_workers)]
        self._stop = threading.Event()
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._done_event = threading.Event()
        self._threads: List[threading.Thread] = []

    def _take(self, wid: int) -> Optional[WorkItem]:
        item = self.queues[wid].pop()
        if item is not None:
            return item
        # steal from the longest peer queue
        order = sorted((i for i in range(self.n_workers) if i != wid),
                       key=lambda i: -len(self.queues[i]))
        for i in order:
            item = self.queues[i].steal()
            if item is not None:
                self.stats[wid]["stolen"] += 1
                return item
        return None

    def _run(self, wid: int) -> None:
        while not self._stop.is_set():
            item = self._take(wid)
            if item is None:
                if self._done_event.is_set():
                    return
                time.sleep(0.001)
                continue
            try:
                item.result = item.fn()
            except Exception as exc:
                item.error = f"{type(exc).__name__}: {exc}"
            item.done = True
            self.stats[wid]["executed"] += 1
            with self._pending_lock:
                self._pending -= 1
                if self._pending == 0:
                    self._done_event.set()

    def map(self, fns: Sequence[Callable[[], Any]],
            timeout: Optional[float] = None) -> List[WorkItem]:
        """Run all thunks; returns WorkItems in submission order."""
        items = [WorkItem(i, fn) for i, fn in enumerate(fns)]
        with self._pending_lock:
            self._pending = len(items)
        self._done_event.clear()
        if not items:
            return []
        for i, item in enumerate(items):
            self.queues[i % self.n_workers].push(item)
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._run, args=(w,), daemon=True)
            for w in range(self.n_workers)]
        for t in self._threads:
            t.start()
        finished = self._done_event.wait(timeout)
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        if not finished:
            raise TimeoutError(
                f"worker pool timed out with {self._pending} jobs pending")
        return items

    def report(self) -> dict:
        return {
            "n_workers": self.n_workers,
            "executed": [s["executed"] for s in self.stats],
            "stolen": sum(s["stolen"] for s in self.stats),
        }
