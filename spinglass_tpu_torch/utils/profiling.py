"""Profiling: the program's span recorder and ``torch.profiler`` traces.

The counterpart of ``spinglass_tpu.utils.profiling``. A span is one phase
of the host's work, ``(name, start_ns, end_ns, parent)`` on
``time.perf_counter_ns()``: ``parent`` is the index of the enclosing span on
the same thread, or -1 for a root, and a root's index is the identifier
that the spans under it share (``Spans.root``). The drivers open spans where
their host work happens:

* ``sa.anneal`` (root): one ``anneal.sa.anneal`` call; ``sa.start`` its
  start state and the load into the captured chunk (the host draw of the
  start spins, the copy, the layout, the energy); ``sa.result`` the best
  row, the per-replica copy and the publish;
* ``ttt.solve`` (root): one seed of ``benchmarks.planted.time_to_target``;
  ``ttt.start`` its start state, the load and the synchronise before its
  clock starts;
* ``pt.run`` (root): one ``anneal.pt.run`` call; ``pt.start`` the
  synchronise before its clock, its start state and the load into the
  captured super-step (the capture on a first call); ``pt.result`` the best
  row, the copies, the history read and the result;
* ``step.fill``: a captured step's random tape filled before a replay;
  ``step.launch``: the graph's replay (on the CPU: the eager step);
* ``read``: a small read to the host (``anneal.graphs.HostRead``), the
  wait included.

Recording is off by default, and then ``phase`` returns one shared no-op
context manager. It is on inside ``recording()``, which yields the list of
the spans it takes, and while ``torch.profiler`` records (a ``profile``
session, ``device_trace``): the spans of such a session go into a list of
their own, ``last`` until another recording starts, so that a trace taken
by anyone can be read against the program's phases. A list holds at most
``cap`` spans and counts the ones it drops.

``device_trace(log_dir)`` records the host and the card with
``torch.profiler`` and writes ``log_dir/trace.json`` (chrome://tracing,
Perfetto) with the spans in it, as ``"ph": "X"`` events of category
``program_span`` on the trace's own clock: the trace's ``ts`` is in us
after ``baseTimeNanoseconds`` on ``time.time_ns()``'s clock, and each list
notes ``time.time_ns()`` beside ``time.perf_counter_ns()`` when it starts
(``clock``). The JAX package's counterpart is a ``jax.profiler`` trace for
XProf/TensorBoard."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import namedtuple
from typing import Optional

from torch.autograd import profiler as _torch_profiler

CAP = 1_000_000   # spans one recording keeps

Span = namedtuple("Span", "name start_ns end_ns parent")

class _Off:
    """The context manager of every span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _clock_pair() -> tuple:
    return time.time_ns(), time.perf_counter_ns()


class Spans(list):
    """The spans of one recording in the order they started (an open span
    has ``end_ns`` None). ``clock`` holds the pairs (``time.time_ns()``,
    ``time.perf_counter_ns()``) at the recording's start and end (None
    until ``recording()`` ends, and for a profiler session's list);
    ``dropped`` counts the spans beyond ``cap``."""

    def __init__(self, cap: int = CAP):
        super().__init__()
        self.cap = cap
        self.dropped = 0
        self.clock = [_clock_pair(), None]

    def root(self, i: int) -> int:
        """The index of the root above span ``i`` (``i`` for a root)."""
        while self[i].parent >= 0:
            i = self[i].parent
        return i

    def wall_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` time on ``time.time_ns()``'s clock."""
        wall, perf = self.clock[0]
        return t_ns + wall - perf


class _Open:
    """One span being recorded: appended when entered, its end written
    when left."""

    __slots__ = ("spans", "name", "stack", "index")

    def __init__(self, spans: Spans, name: str, stack: list):
        self.spans, self.name, self.stack = spans, name, stack

    def __enter__(self):
        spans, stack = self.spans, self.stack
        if len(spans) >= spans.cap:
            spans.dropped += 1
            self.index = -1
            return self
        parent = stack[-1][1] if stack and stack[-1][0] is spans else -1
        self.index = len(spans)
        stack.append((spans, self.index))
        spans.append(Span(self.name, time.perf_counter_ns(), None, parent))
        return self

    def __exit__(self, *exc):
        if self.index >= 0:
            t = time.perf_counter_ns()
            self.stack.pop()
            name, start, _, parent = self.spans[self.index]
            self.spans[self.index] = Span(name, start, t, parent)
        return False


class PerformanceProfiler:
    """The span recorder (see the module docstring); ``global_profiler`` is
    the process-wide one that the drivers use. ``last`` is the newest list
    of spans."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.last: Optional[Spans] = None
        self._explicit: Optional[Spans] = None
        self._traced: Optional[Spans] = None
        self._local = threading.local()

    def phase(self, name: str):
        """A context manager that records the span ``name`` while recording
        is on; the shared no-op one while it is off."""
        spans = self._explicit
        if spans is None:
            if not _torch_profiler._is_profiler_enabled:
                if self._traced is not None:   # that session has ended
                    self._traced = None
                return _OFF
            spans = self._traced
            if spans is None:
                spans = self._traced = self.last = Spans(self.cap)
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return _Open(spans, name, stack)

    @contextlib.contextmanager
    def recording(self):
        """Recording on for the block; yields the list of its spans."""
        outer = self._explicit
        spans = self._explicit = self.last = Spans(self.cap)
        try:
            yield spans
        finally:
            spans.clock[1] = _clock_pair()
            self._explicit = outer

    def summary(self, spans: Optional[Spans] = None) -> dict:
        """Per span name of ``spans`` (default ``last``): the count, the
        total and mean seconds, and the self seconds (each span's time less
        what its children cover). Open spans are left out."""
        spans = self.last if spans is None else spans
        if not spans:
            return {}
        child_ns = [0] * len(spans)
        for s in spans:
            if s.parent >= 0 and s.end_ns is not None:
                child_ns[s.parent] += s.end_ns - s.start_ns
        out: dict = {}
        for s, inner in zip(spans, child_ns):
            if s.end_ns is None:
                continue
            d = out.setdefault(s.name, {"n": 0, "total_s": 0.0, "self_s": 0.0,
                                        "max_s": 0.0})
            dur = (s.end_ns - s.start_ns) * 1e-9
            d["n"] += 1
            d["total_s"] += dur
            d["self_s"] += dur - inner * 1e-9
            d["max_s"] = max(d["max_s"], dur)
        for d in out.values():
            d["mean_s"] = d["total_s"] / d["n"]
        return out


def trace_events(spans: Spans, base_ns: int) -> list:
    """The finished spans as chrome-trace ``"ph": "X"`` events of category
    ``program_span``, in us after ``base_ns`` on ``time.time_ns()``'s clock
    (a trace's ``baseTimeNanoseconds``), on a track of this process named
    "program spans"; ``args`` hold each span's index and parent."""
    pid = os.getpid()
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "program spans"}}]
    for i, s in enumerate(spans):
        if s.end_ns is None:
            continue
        out.append({"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": pid, "tid": 0,
                    "ts": (spans.wall_ns(s.start_ns) - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"index": i, "parent": s.parent}})
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace context (CPU activity, and CUDA where a card is
    visible), with the program's spans recorded; on exit writes
    ``log_dir/trace.json`` (chrome://tracing, Perfetto) with the spans as
    ``program_span`` events on the trace's clock. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with global_profiler.recording() as spans:
        with profile(activities=activities) as prof:
            yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(
        trace_events(spans, int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)


global_profiler = PerformanceProfiler()
