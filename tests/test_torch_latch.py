"""The time-to-target latch (``kernels/latch_cuda.py``) on the CPU: its
twin's rule (copy once, on the first super-step at or below the threshold,
until armed again), what the wrapper hands the kernel through a stand-in
for the built library, and the state it refuses. The kernel itself is
checked against the twin on the card (``test_torch_gpu.py``)."""

import contextlib
import ctypes
import types

import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.kernels import latch_cuda as LC  # noqa: E402


def _state(seed=0, rows=40, r=8):
    """A PT state's nine tensors, in the order of its leaves."""
    g = torch.Generator().manual_seed(seed)
    spins = (2 * torch.randint(0, 2, (rows, r), generator=g) - 1).float()
    return [spins, torch.randperm(r, generator=g).int(),
            torch.randn(r, generator=g), torch.randn(r, generator=g),
            spins.clone(), torch.tensor(30, dtype=torch.int64),
            torch.randint(0, 9, (r - 1,), generator=g, dtype=torch.int32),
            torch.randint(0, 9, (r - 1,), generator=g, dtype=torch.int32),
            torch.rand(r, generator=g)]


def _best(x):
    return torch.tensor(x, dtype=torch.float32)


def test_latch_keeps_the_first_hit_until_armed_again():
    first, later = _state(0), _state(1)
    latch = LC.Latch(first)
    kept = [t.clone() for t in latch.snapshot]
    latch(_best(-5.0), first)               # not armed: the threshold is -inf
    assert all(torch.equal(x, y) for x, y in zip(latch.snapshot, kept))
    latch.arm(-10.0)
    latch(_best(-9.5), first)               # above the threshold
    assert int(latch.flag[0]) == 0
    assert all(torch.equal(x, y) for x, y in zip(latch.snapshot, kept))
    latch(_best(-10.0), first)              # at it: the hit
    assert latch.flag.tolist() == [1, 0]
    assert all(torch.equal(x, y) for x, y in zip(latch.snapshot, first))
    latch(_best(-20.0), later)              # latched: nothing more
    assert all(torch.equal(x, y) for x, y in zip(latch.snapshot, first))
    targets = [torch.zeros_like(t) for t in first]
    latch.restore(targets)
    assert all(torch.equal(x, y) for x, y in zip(targets, first))
    latch.arm(-10.0)
    latch(_best(-20.0), later)              # a new solve hits anew
    assert all(torch.equal(x, y) for x, y in zip(latch.snapshot, later))


def test_latch_compares_in_float64():
    """The threshold is the host's float64: the least float32 above it is
    no hit, the float32 below that is one, as the host's comparison of the
    read best energy decides."""
    state = _state()
    latch = LC.Latch(state)
    threshold = -1234.56789
    above = torch.tensor(threshold, dtype=torch.float32)
    if float(above) <= threshold:
        above = torch.nextafter(above, torch.tensor(0.0))
    below = torch.nextafter(above, torch.tensor(-2e3))
    assert float(below) <= threshold < float(above)
    latch.arm(threshold)
    latch(above, state)
    assert int(latch.flag[0]) == 0
    latch(below, state)
    assert int(latch.flag[0]) == 1


class _FakeLib:
    """A stand-in for the built library: records each entry point's
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("sgt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def test_latch_launch_arguments(monkeypatch):
    """The best energy, the float64 threshold, the flag, each source's and
    snapshot's address and byte count, the leaf count and the stream; one
    launch counted, nothing copied on the host."""
    fake = _FakeLib()
    monkeypatch.setattr(LC, "load_kernel", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    state = _state()
    latch = LC.Latch(state)
    kept = [t.clone() for t in latch.snapshot]
    best = _best(-1e9)
    latch.arm(0.0)
    before = build.launch_snapshot()
    latch._launch(best, state)
    (name, a), = fake.calls
    assert name == "sgt_pt_latch"
    assert build.launches_since(before, [LC.KERNEL]) == {LC.KERNEL: 1}
    assert a[:3] == (best.data_ptr(), latch.threshold.data_ptr(),
                     latch.flag.data_ptr())
    assert latch.threshold.dtype == torch.float64
    n = len(state)
    assert a[6] == n and a[7] == 0
    ptrs = ctypes.cast(a[3], ctypes.POINTER(ctypes.c_void_p))
    assert [ptrs[k] for k in range(n)] == [t.data_ptr() for t in state]
    ptrs = ctypes.cast(a[4], ctypes.POINTER(ctypes.c_void_p))
    assert [ptrs[k] for k in range(n)] == [t.data_ptr()
                                           for t in latch.snapshot]
    sizes = ctypes.cast(a[5], ctypes.POINTER(ctypes.c_ulonglong))
    assert [sizes[k] for k in range(n)] == [t.numel() * t.element_size()
                                            for t in state]
    assert sizes[5] == 8 and sizes[0] == 40 * 8 * 4
    assert all(torch.equal(x, y) for x, y in zip(latch.snapshot, kept))
    with pytest.raises(ValueError):            # the kernel copies bytes
        latch._launch(best, [state[0].t()] + state[1:])


@pytest.mark.parametrize("fault", ["count", "shape", "dtype", "best"])
def test_latch_refuses_a_state_unlike_its_snapshot(fault):
    state = _state()
    latch = LC.Latch(state)
    best = _best(0.0)
    bad = list(state)
    if fault == "count":
        bad = bad[:-1]
    elif fault == "shape":
        bad[2] = bad[2][:-1]
    elif fault == "dtype":
        bad[6] = bad[6].long()
    else:
        best = best.double()
    with pytest.raises(ValueError):
        latch(best, bad)


def test_latch_takes_one_to_sixteen_tensors():
    with pytest.raises(ValueError):
        LC.Latch([])
    with pytest.raises(ValueError):
        LC.Latch([torch.zeros(2)] * (LC.MAX_LEAVES + 1))
    assert len(LC.Latch([torch.zeros(2)] * LC.MAX_LEAVES).snapshot) == 16
