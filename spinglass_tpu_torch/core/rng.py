"""The port's random draws, and the random tape that replays them.

The JAX package threads PRNG keys; the port draws from one host
``torch.Generator`` per run. Every draw of a driver's step goes through the
functions here: ``draw_seed`` (a kernel's 62-bit Philox seed),
``device_generator`` (a generator on the device seeded by one host draw)
and ``rand`` / ``randn`` / ``randperm`` / ``random_bits`` on such a
generator (``device_uniforms`` is the first two in one).

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
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_TAPE: Optional["RandomTape"] = None   # the tape the running step draws through


def host_seed(generator: torch.Generator) -> int:
    """One 62-bit seed from a host generator (no device sync)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator))


def draw_seed(generator: torch.Generator):
    """One kernel seed from a host generator: an int, or a seed slot while a
    tape is active."""
    if _TAPE is not None:
        return _TAPE.seed(generator)
    return host_seed(generator)


def device_generator(generator: torch.Generator, device):
    """A generator on ``device`` seeded by one draw of the host
    ``generator``: what it draws never crosses from the host. Draw from it
    with ``rand``, ``randn``, ``randperm`` or ``random_bits``, which also
    take a tape's generators."""
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
    if isinstance(gen, TapeGenerator):
        return gen.draw(op, size)
    return _DRAWS[op](size, gen, device, None)


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
