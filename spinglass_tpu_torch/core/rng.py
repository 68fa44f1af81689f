"""The port's random draws, and the random tape that replays them.

The JAX package threads PRNG keys; the port draws from one host
``torch.Generator`` per run. Every draw of a driver's step goes through the
functions here: ``draw_seed`` (a kernel's 62-bit Philox seed; ``draw_seeds``
n of them, one per problem of a stacked launch),
``device_generator`` (a generator on the device seeded by one host draw)
and ``rand`` / ``randn`` / ``randperm`` / ``random_bits`` / ``randint`` on
such a generator (``device_uniforms`` is the first two in one).

A captured driver step (``anneal.graphs.CapturedStep``) cannot call the
host generator at each replay, so while it records or replays, a
``RandomTape`` is active (``RandomTape.recording`` / ``serving``) and the
functions go through it:

* ``draw_seed`` gives a seed slot: an element of a static int64 buffer on
  the device, whose address the kernels read their seed from;
* ``device_generator`` gives a ``TapeGenerator``, whose draws are static
  tensors.

The warm-up records the ordered list of draws (their kinds and shapes).
Before each replay ``RandomTape.fill`` makes the same draws eagerly, in the
recorded order, from the run's host generator: the seeds go through a
pinned host tensor to the device buffer in one asynchronous copy, and each
device draw writes its static tensor from a device generator seeded by the
same host draw as in the eager loop. The host generator is consumed in the
eager loop's order, so a replayed run draws the eager run's numbers. Outside
a tape the functions draw directly, as the eager loop does.

Ranks (``distributed/``): every rank of a group holds the same host
generator and makes the same host draws. A ``ShardStream`` is that
generator seen from one rank: a kernel seed is folded with the rank
(``fold_seed``; rank 0 keeps it, so a one-rank group draws the one-device
stream, as JAX's ``fold_in`` of the device index makes each device's
stream), and a device draw is made at the group's width along the replica
axis, of which the rank takes its own slice (``SlicedGenerator``): the
plain sweeps of W ranks draw what one device draws for all replicas.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_TAPE: Optional["RandomTape"] = None   # the tape the running step draws through


_SEED_MASK = 2 ** 62 - 1
# odd 62-bit step between the ranks' seeds (the golden ratio's bits)
_RANK_STEP = 0x9E3779B97F4A7C15 & _SEED_MASK


class ShardStream:
    """A host generator seen from rank ``rank`` of ``world`` (see the
    module docstring). ``axis`` is the replica axis of the draws made
    through it: a draw of local shape s is made at s with s[axis] * world
    and rank's slice of that axis is kept. The draw functions here take it
    wherever they take a host generator."""

    def __init__(self, generator: torch.Generator, rank: int, world: int,
                 axis: int = 0):
        if isinstance(generator, ShardStream):
            generator = generator.generator
        self.generator, self.rank, self.world, self.axis = (
            generator, int(rank), int(world), int(axis))

    @property
    def device(self):
        return self.generator.device


def fold_seed(seed, rank: int):
    """Kernel seed ``seed`` (an int, or a seed slot) of rank ``rank``:
    rank 0 keeps it; a slot gives a new one-element int64 tensor on its
    device, computed there (inside a captured step, at every replay)."""
    if rank == 0:
        return seed
    step = (rank * _RANK_STEP) & _SEED_MASK
    if isinstance(seed, torch.Tensor):
        return torch.bitwise_and(seed + step, _SEED_MASK)
    return (int(seed) + step) & _SEED_MASK


def host_seed(generator: torch.Generator) -> int:
    """One 62-bit seed from a host generator (no device sync)."""
    if isinstance(generator, ShardStream):
        generator = generator.generator
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator))


def draw_seed(generator: torch.Generator):
    """One kernel seed from a host generator: an int, or a seed slot while a
    tape is active. From a ``ShardStream``, the rank's fold of it."""
    if isinstance(generator, ShardStream):
        return fold_seed(draw_seed(generator.generator), generator.rank)
    if _TAPE is not None:
        return _TAPE.seed(generator)
    return host_seed(generator)


def draw_seeds(generator: torch.Generator, n: int):
    """``n`` kernel seeds from a host generator, drawn as ``n`` calls of
    ``draw_seed``: a list of ints, or while a tape is active a [n] view of
    its seed buffer (n consecutive slots, one per problem of a stacked
    launch)."""
    if isinstance(generator, ShardStream):
        seeds = draw_seeds(generator.generator, n)
        if isinstance(seeds, list):
            return [fold_seed(x, generator.rank) for x in seeds]
        return fold_seed(seeds, generator.rank)
    if _TAPE is not None:
        return _TAPE.seed_block(generator, n)
    return [host_seed(generator) for _ in range(n)]


def device_generator(generator: torch.Generator, device):
    """A generator on ``device`` seeded by one draw of the host
    ``generator``: what it draws never crosses from the host. Draw from it
    with ``rand``, ``randn``, ``randperm`` or ``random_bits``, which also
    take a tape's generators. From a ``ShardStream``, a
    ``SlicedGenerator`` over it."""
    if isinstance(generator, ShardStream):
        inner = device_generator(generator.generator, device)
        if generator.world == 1:
            return inner
        return SlicedGenerator(inner, generator.rank, generator.world,
                               generator.axis)
    if _TAPE is not None:
        return _TAPE.generator(generator, device)
    return torch.Generator(device=device).manual_seed(host_seed(generator))


_DRAWS = {
    "rand": lambda size, g, dev, out: torch.rand(size, generator=g,
                                                 device=dev, out=out),
    "randn": lambda size, g, dev, out: torch.randn(size, generator=g,
                                                   device=dev, out=out),
    "randperm": lambda n, g, dev, out: torch.randperm(n, generator=g,
                                                      device=dev, out=out),
    "bits": lambda size, g, dev, out: torch.randint(0, 2, size, generator=g,
                                                    device=dev, out=out),
}
_DTYPES = {"rand": torch.float32, "randn": torch.float32,
           "randperm": torch.int64, "bits": torch.int64}


def _draw(op: str, gen, size, device) -> torch.Tensor:
    if isinstance(gen, ShardStream):   # a draw on the host generator itself
        gen = (SlicedGenerator(gen.generator, gen.rank, gen.world, gen.axis)
               if gen.world > 1 else gen.generator)
    if isinstance(gen, (TapeGenerator, SlicedGenerator)):
        return gen.draw(op, size)
    return _DRAWS[op](size, gen, device, None)


class SlicedGenerator:
    """A device generator (or a tape's) seen from rank ``rank`` of
    ``world``: a draw of shape s is made at s with s[axis] * world, and
    the rank's slice of that axis is returned (contiguous). A permutation,
    and a draw with no such axis, are the group's own: returned whole."""

    def __init__(self, inner, rank: int, world: int, axis: int):
        self.inner, self.rank, self.world, self.axis = inner, rank, world, axis
        self.device = inner.device

    def draw(self, op: str, size) -> torch.Tensor:
        if op == "randperm" or len(size) <= self.axis:
            return _draw(op, self.inner, size, self.device)
        size = tuple(int(d) for d in size)
        n = size[self.axis]
        full = size[:self.axis] + (n * self.world,) + size[self.axis + 1:]
        out = _draw(op, self.inner, full, self.device)
        return out.narrow(self.axis, self.rank * n, n).contiguous()


def rand(gen, shape, device) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` from a device generator."""
    return _draw("rand", gen, shape, device)


def randn(gen, shape, device) -> torch.Tensor:
    """Standard normals of ``shape`` from a device generator."""
    return _draw("randn", gen, shape, device)


def randperm(n: int, gen, device) -> torch.Tensor:
    """A permutation of 0 .. n-1 from a device generator."""
    return _draw("randperm", gen, n, device)


def random_bits(gen, shape) -> torch.Tensor:
    """int64 zeros and ones of ``shape`` on the generator's device."""
    return _draw("bits", gen, shape, gen.device)


def randint(gen, high, shape, device) -> torch.Tensor:
    """int64 integers in [0, high) of ``shape``, as floor(u * high) of
    uniforms from a device generator. ``high`` is an int or a 0-d tensor on
    ``device`` (a count the step keeps there), so no bound is read back to
    the host; a product rounded up to ``high`` is clamped below it."""
    idx = (rand(gen, shape, device) * high).long()
    top = high - 1
    if isinstance(top, torch.Tensor):
        return torch.minimum(idx, top.long())
    return idx.clamp(max=top)


def device_uniforms(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Uniforms in [0, 1) drawn on ``device``, from a generator there seeded
    by one draw of the host ``generator`` (no host-to-device copy)."""
    return rand(device_generator(generator, device), shape, device)


class TapeGenerator:
    """What ``device_generator`` gives while a tape is active: a device
    generator whose draws the tape records (warm-up) or serves from its
    static tensors (capture, eager replay on the CPU)."""

    def __init__(self, tape: "RandomTape", ops: list, device,
                 real: Optional[torch.Generator]):
        self.tape, self.ops, self.device = tape, ops, torch.device(device)
        self.real = real      # recording: a device generator, else None
        self.pos = 0

    def draw(self, op: str, size) -> torch.Tensor:
        """The next draw of kind ``op`` (a key of ``_DRAWS``) of ``size``
        (a shape, or n for randperm)."""
        size = size if op == "randperm" else tuple(int(d) for d in size)
        if self.real is not None:
            self.ops.append([op, size, None])
            return _DRAWS[op](size, self.real, self.device, None)
        if self.pos >= len(self.ops) or self.ops[self.pos][:2] != [op, size]:
            raise RuntimeError(f"the step drew {op} {size} where its tape "
                               f"recorded {self.ops[self.pos:self.pos + 1]}")
        self.pos += 1
        return self.ops[self.pos - 1][2]


class RandomTape:
    """The ordered draws of one captured step (see the module docstring)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.entries = []     # "seed" | ("gen", device, ops)
        self.seeds = None     # [n_seeds] int64 on the device
        self._mode = None     # "record" | "serve"
        self._pos = 0
        self._slot = 0

    @contextlib.contextmanager
    def _active(self, mode: str):
        global _TAPE
        if _TAPE is not None:
            raise RuntimeError("a captured step is already drawing")
        self._mode, self._pos, self._slot = mode, 0, 0
        _TAPE = self
        try:
            yield self
        finally:
            _TAPE = None
            self._mode = None
        if mode == "serve" and self._pos != len(self.entries):
            raise RuntimeError(f"the step made {self._pos} of the "
                               f"{len(self.entries)} draws its tape recorded")

    def recording(self):
        """The warm-up: draws come from the generator the step names (a
        throwaway copy) and their kinds and shapes are recorded."""
        if self.entries:
            raise RuntimeError("this tape has been recorded")
        return self._active("record")

    def serving(self):
        """Capture, or an eager replay: draws are the static slots."""
        return self._active("serve")

    def _next(self, kind: str):
        if self._pos >= len(self.entries):
            raise RuntimeError(f"the step drew more than the "
                               f"{len(self.entries)} draws its tape recorded")
        entry = self.entries[self._pos]
        if (entry if kind == "seed" else entry[0]) != kind:
            raise RuntimeError(f"draw {self._pos} of the step is a {kind}; "
                               f"the tape recorded {entry!r}")
        self._pos += 1
        return entry

    def seed(self, generator: torch.Generator):
        """A kernel seed: an int while recording, a slot when served."""
        if self._mode == "record":
            self.entries.append("seed")
            return host_seed(generator)
        self._next("seed")
        self._slot += 1
        return self.seeds[self._slot - 1]

    def seed_block(self, generator: torch.Generator, n: int):
        """``n`` kernel seeds: ints while recording, n consecutive slots
        (a contiguous [n] view) when served."""
        if self._mode == "record":
            return [self.seed(generator) for _ in range(n)]
        for _ in range(n):
            self._next("seed")
        self._slot += n
        return self.seeds[self._slot - n:self._slot]

    def generator(self, generator: torch.Generator, device) -> TapeGenerator:
        """A device generator seeded by one host draw."""
        if self._mode == "record":
            ops: list = []
            self.entries.append(("gen", torch.device(device), ops))
            real = torch.Generator(device=device).manual_seed(
                host_seed(generator))
            return TapeGenerator(self, ops, device, real)
        _, dev, ops = self._next("gen")
        if dev != torch.device(device):
            raise RuntimeError(f"the step drew on {device}; the tape "
                               f"recorded {dev}")
        return TapeGenerator(self, ops, dev, None)

    def allocate(self) -> None:
        """The static buffers of the recorded draws."""
        n = sum(e == "seed" for e in self.entries)
        self.seeds = torch.zeros(n, dtype=torch.int64, device=self.device)
        for e in self.entries:
            if e != "seed":
                _, dev, ops = e
                for op in ops:
                    size = (op[1],) if op[0] == "randperm" else op[1]
                    op[2] = torch.empty(size, dtype=_DTYPES[op[0]], device=dev)

    def fill(self, generator: torch.Generator) -> None:
        """The recorded draws, made now from ``generator`` in the recorded
        order: seeds into the slots, device draws into their tensors. On
        the stream of the replay that follows, so it reads them."""
        seeds = []
        for e in self.entries:
            if e == "seed":
                seeds.append(host_seed(generator))
                continue
            _, dev, ops = e
            g = torch.Generator(device=dev).manual_seed(host_seed(generator))
            for op, size, out in ops:
                _DRAWS[op](size, g, dev, out)
        if seeds:
            host = torch.tensor(seeds, dtype=torch.int64)
            if self.seeds.is_cuda:  # a fresh pinned buffer per replay
                host = host.pin_memory()
            self.seeds.copy_(host, non_blocking=True)
