"""The yardstick: the frozen instance, the bound arithmetic, the plain
energies against the program's, and the reading of a trace."""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.devtrace import Trace
from portbench.reference import bounds, energy, planted, sk


def test_frozen_planted_instance_matches_its_record():
    prov = planted.provenance()
    spec = json.load(open(f"{harness.HERE}/configs/planted10k.json"))[
        "instance"]
    inst = planted.build({"instance": spec}, seed=123, device="cpu")
    assert planted.instance_hash(inst["rows"], inst["cols"], inst["vals"]) \
        == prov["instance"]["sha256"]
    assert spec["sha256"].startswith("3778707e")
    assert len(inst["rows"]) == prov["instance"]["n_directed_entries"]
    assert inst["target"]["energy"] == pytest.approx(-21773.709)
    assert inst["target"]["rel_gap"] == 5e-3


def test_planted_hash_is_checked():
    spec = dict(json.load(open(f"{harness.HERE}/configs/planted10k.json"))[
        "instance"], sha256="0" * 64)
    with pytest.raises(RuntimeError, match="hash"):
        planted.build({"instance": spec}, seed=0, device="cpu")


def test_planted_copy_equals_the_programs_generator():
    from spinglass_tpu_torch.benchmarks import planted as prog

    ours = planted.planted_gauge_coo(500, 6.0, 9, 0.3, "uniform")
    theirs = prog.planted_gauge_coo(500, 6.0, 9, 0.3, "uniform")
    for a, b in zip(ours, (theirs.rows, theirs.cols, theirs.vals)):
        np.testing.assert_array_equal(a, b)


def test_sk_draw_is_symmetric_and_seeded():
    a = sk.draw_j(64, 2 ** 31 + 5, "cpu")
    assert torch.equal(a, a.T) and torch.all(a.diagonal() == 0)
    assert torch.equal(a, sk.draw_j(64, 2 ** 31 + 5, "cpu"))
    assert not torch.equal(a, sk.draw_j(64, 6, "cpu"))
    assert a.std().item() == pytest.approx(1 / 8, rel=0.1)


def test_k1_bound_counts_the_work_once():
    """2 N^2 R at the bf16 peak, whatever planes an implementation uses:
    the program's own bound at 3 planes is three times the operations."""
    from spinglass_tpu_torch.kernels import metropolis_cuda as mc

    least, what = bounds.dense_sweep(4096, 1024)
    assert what == "operations"
    assert least == pytest.approx(2 * 4096 ** 2 * 1024 / 989e12)
    assert least * 1e6 == pytest.approx(34.74, abs=0.01)
    for planes in (1, 3):
        ms, _ = mc.dense_sweep_bound(mc.DENSE_KERNELS[0], 4096, 1024, planes)
        assert least <= ms * 1e-3 + 1e-12


def test_k2_bound_counts_real_spins_and_edges():
    """Bytes bound K2 on the planted instance at both replica counts: the
    real spins and edges once through HBM, a spin as a byte; the work's
    operations (an FMA per edge and a compare per spin, no random draws)
    take less."""
    least, what = bounds.sparse_sweep(10000, 79966, 1024)
    nbytes = 8 * 79966 + 12 * 10000 + 2 * 10000 * 1024 + 12 * 1024
    assert what == "bytes" and least == pytest.approx(nbytes / 3.35e12)
    assert least * 1e6 == pytest.approx(6.34, abs=0.01)
    assert (2 * 79966 + 10000) * 1024 / 67e12 < least
    small, what = bounds.sparse_sweep(10000, 79966, 128)
    assert what == "bytes" and small < least


def _spins(r, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2, (r, n), generator=g).float() * 2 - 1


def test_dense_energies_equal_the_programs():
    from spinglass_tpu_torch.core import energy as prog_energy
    from spinglass_tpu_torch.core.problem import IsingProblem

    inst = sk.build({"sizes": {"n_spins": 200}}, 7, "cpu")
    s = _spins(5, 200)
    ours = energy.Couplings(inst, "cpu").energies(s)
    p = IsingProblem.from_dense(inst["j"].numpy(), device="cpu")
    pad = torch.ones(5, p.n_padded)
    pad[:, :200] = s
    theirs = prog_energy.energy(p, pad).double()
    torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=1e-5)
    low = energy.Couplings(inst, "cpu", torch.float32, True).energies(
        s).double()
    assert 0 < (low - ours).abs().max() / ours.abs().max() < 1e-2


def test_sparse_energies_equal_the_programs():
    from spinglass_tpu_torch.kernels.sparse import EllProblem, sparse_energy

    rows, cols, vals = planted.planted_gauge_coo(300, 6.0, 4, 0.3, "uniform")
    inst = {"kind": "coo", "n": 300, "rows": rows, "cols": cols,
            "vals": vals}
    s = _spins(4, 300, 1)
    ours = energy.Couplings(inst, "cpu").energies(s)
    ell = EllProblem.from_coo(300, rows, cols, vals, device="cpu")
    pad = torch.ones(4, ell.n_padded)
    pad[:, :300] = s
    theirs = sparse_energy(ell, pad).double()
    torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=1e-4)


def _trace():
    """A synthetic Chrome trace: three kernels with two gaps, the second
    while the host draws."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "sparse_sweep_kernel", "ts": 0,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 12, "dur": 3},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 14,
         "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "sparse_sweep_kernel", "ts": 30,
         "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 9,
         "dur": 0.5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 20,
         "dur": 8},
        {"ph": "X", "cat": "cpu_op", "name": "aten::randint", "ts": 16,
         "dur": 12},
        {"ph": "i", "cat": "kernel", "name": "not a span", "ts": 0},
    ]
    t = Trace()
    t._read({"traceEvents": ev})
    t.window_s = 50e-6
    return t


def test_trace_reading():
    t = _trace()
    assert t.device_seconds("sparse_sweep_kernel") == pytest.approx(20e-6)
    assert t.device_seconds() == pytest.approx(23e-6)
    assert t.busy_s() == pytest.approx(24e-6)
    assert t.idle_gaps() == [(10, 2), (16, 14)]
    idle = t.idle_by_host()
    assert idle["cudaMemcpyAsync"] == pytest.approx(14e-6)
    assert idle["host, no op"] == pytest.approx(2e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["sparse_sweep_kernel", pytest.approx(20e-6)]
    assert len(b["idle_gaps"]) == 2


def test_a_trace_without_device_time_raises():
    with pytest.raises(RuntimeError, match="no device activity"):
        Trace()._read({"traceEvents": []})


def test_readers(bench):
    t = _trace()
    x = SimpleNamespace(trace=t, counts={"sweeps": 2, "jobs": 1},
                        params={"n_replicas": 128},
                        instance={"n": 10000, "rows": np.zeros(79966)},
                        workload={"sweep_kernels": ["sparse_sweep_kernel"],
                                  "replicas_param": "n_replicas"})
    read = {m["name"]: harness.load_module("metrics", m["name"]).read(x)
            for m in bench["per_layer"]
            if m["name"].endswith(".ttt") or m["name"].startswith("pt_")}
    least, _ = bounds.sparse_sweep(10000, 79966, 128)
    assert read["k2_roofline_pct.ttt"] == pytest.approx(
        100 * least * 2 / 20e-6)
    assert read["pt_other_us_per_sweep"] == pytest.approx(1.5)
    assert read["kernels_per_sweep.ttt"] == 1.5
    assert read["device_idle_pct.ttt"] == pytest.approx(52.0)
    none = SimpleNamespace(**dict(vars(x), workload=dict(
        x.workload, sweep_kernels=["x"])))
    assert harness.load_module("metrics", "k2_roofline_pct.ttt").read(
        none) is None
    assert math.isfinite(read["k2_roofline_pct.ttt"])
