"""Captured drivers: one step of a driver replayed as a CUDA graph, and the
cache that keeps captured steps across calls.

The counterpart of ``spinglass_tpu.anneal.jit_cache``. The JAX package runs
an SA chunk, a PT run, the time-to-target loop and a scan of PPO updates as
single jitted dispatches and keeps the compiled executables across calls;
the port captures the driver's step (an SA chunk, a PT super-step, a PPO
update) once in a ``torch.cuda.CUDAGraph`` and replays it, so a step costs
one launch from the host whatever it holds, and ``StepCache`` keeps the
captured steps of a problem and configuration for the calls after.

``CapturedStep(step, state, generator)``:

* ``step(state) -> (state, outputs)`` is the driver's eager step. The
  state's tensors are the graph's static inputs: the captured step ends by
  copying the new state into them, so consecutive replays chain with no
  host work. Its outputs are static too (the graph's own tensors).
  ``load`` copies a new run's start state in.
* ``record=n`` also writes each replay's outputs into row ``row`` of
  static ``[n, ...]`` buffers (``history``) and advances ``row``, a device
  counter, modulo n: n replays need no read in between.
* Before capture the step runs once on a throwaway copy of the state and a
  copy of the generator (``warm_up`` may supply another throwaway state), on
  a side stream: kernels are built and loaded, lazy buffers allocated and
  shared-memory limits raised there, and none of the run's draws is used.
* Randomness: the step's draws go through a ``core.rng.RandomTape``,
  recorded in the warm-up and refilled from the run's host generator before
  every replay (see ``core.rng``).
* Launches: what the warm-up and the capture count in the launch ledger
  (``kernels.build.LAUNCHES``) is given back; the capture's count is the
  graph's launches, which every replay adds to the ledger.
* On the CPU there is no graph: ``replay`` runs the step eagerly, through
  the same tape and the same static state.
* ``capture_seconds``: what the warm-up and the capture took.
* A failed capture or replay raises. Nothing falls back to the eager loop.

Threads: the random tape is process-wide (``core.rng``), a cached step's
static state belongs to the run that uses it, and a capture on the card
must not overlap another thread's launches. So every driver that uses a
``StepCache`` or the tape holds ``DRIVER_LOCK`` (``serialized``) from its
cache lookup to its last read: concurrent callers run one after another,
as the JAX package's dispatch orders them.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import threading
import time
from collections import OrderedDict
from typing import Callable, Hashable, Optional, Sequence

import torch

from spinglass_tpu_torch.core.rng import RandomTape
from spinglass_tpu_torch.kernels import build
from spinglass_tpu_torch.utils.profiling import global_profiler


# a process-wide re-entrant lock: a driver may call another driver
DRIVER_LOCK = threading.RLock()


def sync(device: torch.device) -> None:
    """Wait for ``device``'s work (a CUDA device; nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _give_back(snapshot: dict) -> dict:
    """The launches counted since ``snapshot``, taken out of the ledger."""
    counted = build.launches_since(snapshot)
    build.count_launches({k: -n for k, n in counted.items()})
    return counted


def serialized(fn: Callable) -> Callable:
    """``fn`` run under ``DRIVER_LOCK`` (see the module docstring)."""
    @functools.wraps(fn)
    def locked(*args, **kwargs):
        with DRIVER_LOCK:
            return fn(*args, **kwargs)
    return locked


# -- state trees --------------------------------------------------------------

def _map(fn, x):
    """``x`` rebuilt with ``fn`` applied to every tensor and generator in
    it (dataclasses, dicts, lists and tuples are walked)."""
    if isinstance(x, (torch.Tensor, torch.Generator)):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _map(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x)
                                         if f.init})
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    return x


def leaves(x) -> list:
    """The tensors of a state tree, in a fixed order."""
    out = []
    _map(lambda t: out.append(t) if isinstance(t, torch.Tensor) else t, x)
    return out


def clone_generator(g: torch.Generator) -> torch.Generator:
    """A generator in ``g``'s state; drawing from it leaves ``g`` as it is."""
    return torch.Generator(device=g.device).set_state(g.get_state())


def clone(x):
    """A throwaway copy of a state tree: tensors cloned, generators copied."""
    with torch.no_grad():
        return _map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else clone_generator(t), x)


def device_counter(state):
    """A driver state (a dataclass with ``spins`` and a ``sweep`` counter)
    with its counter as a 0-d int64 tensor on the spins' device, filled
    there; a graph reads it at every replay where it would freeze an int."""
    if isinstance(state.sweep, torch.Tensor):
        return state
    return dataclasses.replace(state, sweep=torch.full(
        (), state.sweep, dtype=torch.int64, device=state.spins.device))


def distinct(x):
    """``x`` with every tensor that shares storage with an earlier one
    replaced by a copy, so that each leaf can take a new value of its own."""
    seen = set()

    def fn(t):
        if not isinstance(t, torch.Tensor):
            return t
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            return t.detach().clone()
        seen.add(ptr)
        return t

    return _map(fn, x)


def assign(static, new) -> None:
    """Copy the tensors of ``new`` into those of ``static`` (same tree
    structure). A leaf that is already the static tensor is skipped; one
    that shares storage with a static tensor is copied out first, so no
    copy reads what an earlier one wrote."""
    dst, src = leaves(static), leaves(new)
    if len(dst) != len(src):
        raise RuntimeError(f"the step returned {len(src)} state tensors "
                           f"for {len(dst)}")
    ptrs = {t.untyped_storage().data_ptr() for t in dst}
    with torch.no_grad():
        src = [s if s is d or s.untyped_storage().data_ptr() not in ptrs
               else s.clone() for d, s in zip(dst, src)]
        for d, s in zip(dst, src):
            if s is not d:
                d.copy_(s)


class CapturedStep:
    """A driver step captured once and replayed (see the module
    docstring). ``state`` becomes ``self.state`` (storage shared between
    leaves is split first); ``record`` > 0 keeps the outputs of the last
    ``record`` replays in ``history`` (the outputs' tree, each tensor with
    a leading [record] axis; ``row`` is the next row);
    ``warm_up(state) -> (throwaway state, restore)``
    replaces the default throwaway copy where a step must run on some of the
    run's own objects (PPO's parameters and optimizer: ``restore`` puts them
    back after the warm-up). ``launches`` are the graph's per replay (kernel
    name -> launches; empty on the CPU, whose replays count themselves).
    ``CapturedStep.made`` counts the steps captured in this process."""

    made = 0

    def __init__(self, step: Callable, state, generator: torch.Generator,
                 record: int = 0, warm_up: Optional[Callable] = None):
        CapturedStep.made += 1
        self.step = step
        self.generator = generator
        self.state = distinct(state)
        tensors = leaves(self.state)
        if not tensors:
            raise ValueError("a captured step needs a state on a device")
        self.device = tensors[0].device
        self.tape = RandomTape(self.device)
        self.launches = {}
        self.graph = None
        self.outputs = None
        self.record = record
        t0 = time.perf_counter()
        before = build.launch_snapshot()
        if warm_up is None:
            warm, restore = clone(self.state), None
        else:
            warm, restore = warm_up(self.state)
        cuda = self.device.type == "cuda"
        if cuda:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side), self.tape.recording():
                _, out = step(warm)
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            with self.tape.recording():
                _, out = step(warm)
        if record:
            self.history = _map(lambda t: torch.zeros(
                (record,) + tuple(t.shape), dtype=t.dtype, device=t.device),
                out)
            self.row = torch.zeros((), dtype=torch.int64, device=self.device)
        del warm, out
        if restore is not None:
            restore()
        _give_back(before)
        self.tape.allocate()
        if cuda:
            self.graph = torch.cuda.CUDAGraph()
            # no cyclic garbage collection inside the capture: a dead cycle
            # that holds another step's graph would destroy that graph
            # there, which the driver refuses while a stream captures (and
            # the capture fails)
            gc_was_on = gc.isenabled()
            gc.disable()
            before = build.launch_snapshot()
            try:
                with self.tape.serving(), torch.cuda.graph(self.graph):
                    self.outputs = self._run()
            finally:
                if gc_was_on:
                    gc.enable()
            self.launches = _give_back(before)
        # warm-up and capture on the host clock (the capture waits for the
        # warm-up's device work, and instantiates the graph)
        self.capture_seconds = time.perf_counter() - t0

    def _run(self):
        new, out = self.step(self.state)
        assign(self.state, new)
        if self.record:
            with torch.no_grad():
                for h, o in zip(leaves(self.history), leaves(out)):
                    h.index_copy_(0, self.row.reshape(1), o[None])
                self.row.copy_((self.row + 1) % self.record)
        return out

    def load(self, state) -> None:
        """A new run's start ``state`` (the tree of ``self.state``, its
        counters device tensors) copied into the static state; the history
        row goes back to 0."""
        assign(self.state, state)
        if self.record:
            self.row.zero_()

    def replay(self, generator: Optional[torch.Generator] = None):
        """One step: the tape's draws from ``generator`` (default: the one
        given at construction), then the graph (on the CPU: the step, run
        eagerly). Returns the step's outputs (static tensors on the card)."""
        with global_profiler.phase("step.fill"):
            self.tape.fill(generator if generator is not None
                           else self.generator)
        if self.graph is None:
            with global_profiler.phase("step.launch"), self.tape.serving():
                self.outputs = self._run()
            return self.outputs
        with global_profiler.phase("step.launch"):
            self.graph.replay()
        build.count_launches(self.launches)
        return self.outputs


class CapturedLearner:
    """A learner's step captured once (``CapturedStep``) and replayed: an RL
    update or act-and-learn step ``step_fn(state) -> (state, metrics)``
    whose state holds ``params`` (a dict of tensors), the optimizer ``opt``
    that steps them and the run's host ``generator``. Each replay writes the
    metrics named by ``keys`` (0-d tensors) into the step's [k, m] history,
    so k replays need one read (``read``). The warm-up runs on the run's own
    parameters and optimizer (Adam's state is built there, outside the
    graph, on the tensors the graph updates) and on a throwaway copy of the
    rest of the state, the generator included; then it puts the parameters
    and the optimizer's state back as they were. ``done`` counts
    replays."""

    def __init__(self, step_fn: Callable, state, keys: Sequence[str],
                 k: int = 1):
        self.k = k
        self.keys = keys = tuple(keys)
        self.done = 0

        def step(st):
            st, metrics = step_fn(st)
            return st, torch.stack([metrics[key].reshape(())
                                    for key in keys])

        def warm_up(st):
            params, opt = st.params, st.opt
            with torch.no_grad():
                kept_params = {n: p.detach().clone() for n, p in params.items()}
                kept = {p: {key: v.clone() for key, v in opt.state[p].items()}
                        for p in params.values() if p in opt.state}

            def restore():
                with torch.no_grad():
                    for n, p in params.items():
                        p.copy_(kept_params[n])
                        for key, v in opt.state.get(p, {}).items():
                            if p in kept:
                                v.copy_(kept[p][key])
                            else:   # Adam's fresh state is all zeros
                                v.zero_()
                opt.zero_grad(set_to_none=True)

            warm = clone(dataclasses.replace(st, params=None, opt=None))
            return dataclasses.replace(warm, params=params, opt=opt), restore

        self.step = CapturedStep(step, state, state.generator, record=k,
                                 warm_up=warm_up)
        self.state = self.step.state
        self._read = HostRead()

    def replay(self) -> None:
        """One step."""
        self.step.replay()
        self.done += 1

    def read(self, n: int) -> list:
        """The metrics of the last ``n`` <= k steps, oldest first, as dicts
        of floats (one read of the history)."""
        rows = self._read([self.step.history])[0].tolist()
        first = self.done - n
        return [dict(zip(self.keys, rows[(first + i) % self.k]))
                for i in range(n)]


CACHES: dict = {}   # name -> StepCache, every cache made in this process


class StepCache:
    """Captured steps kept across driver calls, as ``jit_cache.SolverCache``
    keeps executables: an entry per (problem object, key), where the key
    names the driver and its configuration (and so every shape). The entry
    holds its problem, so the problem's id cannot be reused while the entry
    lives; beyond ``max_entries`` the least recently used entry goes, and
    its graphs and their memory with it. One run at a time may use an
    entry: its static state is the run's. Every cache is listed in
    ``CACHES`` under its ``name``, and ``clear_caches`` clears them all."""

    def __init__(self, name: str, max_entries: int = 8):
        CACHES[name] = self
        self.max_entries = max_entries
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, problem, key: Hashable):
        """The entry of (problem, key), or None."""
        entry = self._d.get((id(problem), key))
        if entry is None:
            self.misses += 1
            return None
        self._d.move_to_end((id(problem), key))
        self.hits += 1
        return entry[0]

    def put(self, problem, key: Hashable, value) -> None:
        self._d[(id(problem), key)] = (value, problem)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def values(self) -> list:
        """The cached entries, least recently used first."""
        return [value for value, _ in self._d.values()]

    def clear(self) -> None:
        self._d.clear()


def config_key(config):
    """A driver's configuration as a cache key, its ``seed`` taken out.
    The seed never enters a captured step: the random tape is refilled from
    the run's generator before every replay. So runs that differ only in
    their seed share one capture, as they share one executable in the JAX
    package's ``jit_cache``."""
    return dataclasses.replace(config, seed=0)


SA_CACHE = StepCache("sa_steps")   # sa.anneal / sa.anneal_scan
PT_CACHE = StepCache("pt_steps")   # pt.run / planted.time_to_target


def clear_caches() -> None:
    """Drop every cache of ``CACHES``: captured steps and what they hold
    (the next driver call captures)."""
    for cache in CACHES.values():
        cache.clear()


class HostRead:
    """Small device tensors read through pinned host buffers: one
    asynchronous copy each and an event, so the host waits for these copies
    only (no device-wide sync). Returns host tensors."""

    def __init__(self):
        self._bufs = {}
        self._event = None

    def __call__(self, tensors: Sequence[torch.Tensor]) -> list:
        with global_profiler.phase("read"):
            return self._read(tensors)

    def _read(self, tensors: Sequence[torch.Tensor]) -> list:
        if not tensors or not tensors[0].is_cuda:
            return [t.detach().clone() for t in tensors]
        out = []
        for i, t in enumerate(tensors):
            buf = self._bufs.get(i)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype).pin_memory()
                self._bufs[i] = buf
            buf.copy_(t, non_blocking=True)
            out.append(buf)
        if self._event is None:
            self._event = torch.cuda.Event()
        self._event.record()
        self._event.synchronize()
        return [b.clone() for b in out]


class ReadRing:
    """Reads of a small device tensor kept in flight: ``push(t)`` queues a
    copy of ``t`` into the next of ``depth`` pinned host buffers and
    records that buffer's event, so the copy takes ``t``'s value at that
    point of the stream; ``pop()`` waits for the oldest copy only and
    returns it (a host tensor). Reads come back in the order pushed, at most
    ``depth`` at a time; ``clear()`` forgets those still in flight. On the
    CPU a push keeps a copy."""

    def __init__(self, depth: int):
        self.depth = depth
        self._bufs = [None] * depth
        self._events = [None] * depth
        self._first = 0     # the slot of the oldest read in flight
        self._count = 0

    def push(self, t: torch.Tensor) -> None:
        if self._count == self.depth:
            raise RuntimeError(f"{self.depth} reads are in flight already")
        i = (self._first + self._count) % self.depth
        self._count += 1
        if not t.is_cuda:
            self._bufs[i] = t.detach().clone()
            return
        buf = self._bufs[i]
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._bufs[i] = torch.empty(t.shape,
                                              dtype=t.dtype).pin_memory()
        buf.copy_(t, non_blocking=True)
        if self._events[i] is None:
            self._events[i] = torch.cuda.Event()
        self._events[i].record()

    def pop(self) -> torch.Tensor:
        if not self._count:
            raise RuntimeError("no read is in flight")
        i = self._first
        self._first = (i + 1) % self.depth
        self._count -= 1
        with global_profiler.phase("read"):
            if self._events[i] is not None:
                self._events[i].synchronize()
            return self._bufs[i].clone()

    def clear(self) -> None:
        self._first = self._count = 0
