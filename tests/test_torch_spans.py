"""The span recorder (``utils.profiling``) and the drivers' spans: off by
default at no cost, nesting, parents and roots across ``sa.anneal`` and
``time_to_target``, spans under a ``torch.profiler`` session, and
``device_trace``'s ``program_span`` events on the trace's own clock."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from spinglass_tpu_torch.anneal import pt, sa
from spinglass_tpu_torch.benchmarks import planted
from spinglass_tpu_torch.core.problem import IsingProblem
from spinglass_tpu_torch.kernels.sparse import EllProblem
from spinglass_tpu_torch.utils import profiling
from spinglass_tpu_torch.utils.profiling import (PerformanceProfiler,
                                                 device_trace,
                                                 global_profiler)

SA_CFG = sa.SAConfig(n_sweeps=40, n_replicas=4, record_interval=20,
                     enable_early_stop=False)


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(0)
    j = rng.normal(size=(16, 16))
    j = (j + j.T) / 2
    np.fill_diagonal(j, 0)
    p = IsingProblem.from_dense(j, device="cpu")
    sa.anneal(p, SA_CFG)   # builds and caches the chunk
    return p


def _names(spans):
    return [s.name for s in spans]


def test_off_records_nothing_and_returns_the_shared_no_op():
    prof = PerformanceProfiler()
    a, b = prof.phase("a"), prof.phase("b")
    assert a is b
    with a:
        pass
    assert prof.last is None and prof.summary() == {}


def test_the_drivers_open_no_span_while_off(dense):
    before = global_profiler.last
    sa.anneal(dense, SA_CFG)
    assert global_profiler.last is before


def test_sa_anneal_spans_nest_under_one_root(dense):
    with global_profiler.recording() as spans:
        sa.anneal(dense, SA_CFG)
    assert _names(spans) == ["sa.anneal", "sa.start",
                             "step.fill", "step.launch", "read",
                             "step.fill", "step.launch", "read", "sa.result"]
    assert spans[0].parent == -1
    assert all(s.parent == 0 for s in spans[1:])
    assert {spans.root(i) for i in range(len(spans))} == {0}
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        assert spans[0].start_ns <= s.start_ns <= s.end_ns <= spans[0].end_ns
    for prev, nxt in zip(spans[1:], spans[2:]):   # children one after another
        assert prev.end_ns <= nxt.start_ns
    wall0, perf0 = spans.clock[0]
    wall1, perf1 = spans.clock[1]
    assert perf0 <= spans[0].start_ns and spans[-1].end_ns <= perf1
    assert abs((wall1 - wall0) - (perf1 - perf0)) < 5_000_000


def test_time_to_target_spans_one_root_per_seed():
    inst = planted.planted_gauge_coo(64, seed=1)
    ell = EllProblem.from_coo(64, inst.rows, inst.cols, inst.vals,
                              device="cpu")
    cfg = pt.PTConfig(n_replicas=4, exchange_interval=5, min_temp=0.1,
                      max_temp=3.0)
    # two seeds that hit at once, then two that never hit (a target below
    # the ground state): 20 super-steps each
    with global_profiler.recording() as spans:
        runs = [run for target in (inst.e0, 2 * inst.e0)
                for run in planted.time_to_target(
                    ell, target, cfg, rel_gap=0.05, max_sweeps=100,
                    seeds=[1, 2])["per_seed"]]
    assert [r["hit"] for r in runs] == [True, True, False, False]
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["ttt.solve"] * 4
    for k, r in enumerate(roots):
        end = roots[k + 1] if k + 1 < len(roots) else len(spans)
        mine = range(r + 1, end)
        assert all(spans.root(i) == r and spans[i].parent == r for i in mine)
        names = [spans[i].name for i in mine]
        assert names[0] == "ttt.start"
        run = runs[k]
        n_super = run["sweeps"] // cfg.exchange_interval
        launched = run["launched"]
        # the pipelined order: DEPTH replays queued, then a read before
        # each further replay, then the reads of those still in flight
        ahead = min(planted.DEPTH, launched)
        fill_launch = ["step.fill", "step.launch"]
        assert names[1:] == (fill_launch * ahead
                             + (["read"] + fill_launch) * (launched - ahead)
                             + ["read"] * (n_super - launched + ahead))
        assert names.count("step.launch") == launched
        assert names.count("step.fill") == launched
        assert names.count("read") == n_super
        assert launched - n_super == run["discarded"] <= planted.DEPTH - 1


def test_sqa_spans_nest_sa_anneal_under_sqa_run():
    """Carried SQA on a sparse lattice: one ``sqa.run`` root over the call,
    ``sqa.start``, one ``sqa.stage`` a stage and ``sqa.decode`` under it,
    and each stage's ``sa.anneal`` under its ``sqa.stage``, so no longer a
    request root."""
    from spinglass_tpu_torch.core.topology import lattice_coo
    from spinglass_tpu_torch.research import quantum

    ell = EllProblem.from_coo(*lattice_coo(4, dims=2, dist="uniform",
                                           scale=2.0, seed=1), device="cpu")
    cfg = quantum.SQAConfig(n_trotter=4, beta=4.0, n_stages=3,
                            sweeps_per_stage=10, n_replicas=4,
                            carry_state=True, gamma_schedule="linear")
    quantum.simulated_quantum_annealing(ell, cfg)   # builds and captures
    with global_profiler.recording() as spans:
        quantum.simulated_quantum_annealing(ell, cfg)
    names = _names(spans)
    assert names[0] == "sqa.run" and spans[0].parent == -1
    assert [i for i, s in enumerate(spans) if s.parent == -1] == [0]
    top = [s.name for s in spans if s.parent == 0]
    assert top == ["sqa.start"] + ["sqa.stage"] * 3 + ["sqa.decode"]
    stages = [i for i, s in enumerate(spans) if s.name == "sqa.stage"]
    anneals = [i for i, s in enumerate(spans) if s.name == "sa.anneal"]
    assert [spans[i].parent for i in anneals] == stages
    assert all(spans.root(i) == 0 for i in range(len(spans)))
    assert all(s.end_ns is not None for s in spans)
    assert spans[0].end_ns >= max(s.end_ns for s in spans[1:])


def test_parents_are_per_thread_and_the_cap_counts_drops():
    prof = PerformanceProfiler(cap=3)
    seen = {}

    def other():
        with prof.phase("t"):
            seen["stack"] = list(prof._local.stack)

    with prof.recording() as spans:
        with prof.phase("outer"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            with prof.phase("inner"):
                with prof.phase("dropped"):
                    pass
    assert not t.is_alive()
    assert _names(spans) == ["outer", "t", "inner"]
    assert [s.parent for s in spans] == [-1, -1, 0]
    assert seen["stack"] == [(spans, 1)]
    assert spans.dropped == 1


def test_a_profiler_session_records_spans_of_its_own(dense):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        sa.anneal(dense, SA_CFG)
    first = global_profiler.last
    assert _names(first)[:2] == ["sa.anneal", "sa.start"]
    assert first.clock[1] is None
    sa.anneal(dense, SA_CFG)            # after the session: nothing
    assert global_profiler.last is first and len(first) == 9
    with profile(activities=[ProfilerActivity.CPU]):
        sa.anneal(dense, SA_CFG)
    assert global_profiler.last is not first
    assert len(global_profiler.last) == 9


def test_device_trace_puts_the_spans_on_the_traces_clock(dense, tmp_path):
    """On the CPU the trace holds the host's operators: the start spins'
    draws (``aten::randint``) lie inside the ``sa.start`` span."""
    with device_trace(str(tmp_path)):
        sa.anneal(dense, SA_CFG)
    doc = json.loads((tmp_path / "trace.json").read_text())
    ev = doc["traceEvents"]
    spans = [e for e in ev if e.get("cat") == "program_span"]
    assert [e["name"] for e in spans][:2] == ["sa.anneal", "sa.start"]
    assert [e["args"]["parent"] for e in spans] == [-1] + [0] * 8
    start = spans[1]
    draws = [e for e in ev if e.get("name") == "aten::randint"
             and e.get("ph") == "X"]
    assert draws
    inside = [e for e in draws if start["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= start["ts"] + start["dur"]]
    # the tape's fills draw seeds on the host, not through randint: the
    # two inside sa.start are the start's one seed from the run's host
    # generator and the start spins' draw on the problem's device
    assert len(inside) == 2
    # every operator of the run lies inside the root span
    root = spans[0]
    ops = [e for e in ev if e.get("cat") == "cpu_op"]
    assert ops and all(root["ts"] - 50 <= e["ts"] and e["ts"] + e["dur"]
                       <= root["ts"] + root["dur"] + 50 for e in ops)


def test_trace_events_convert_on_the_recordings_clock():
    spans = profiling.Spans()
    spans.clock[0] = (10_000_000, 4_000)
    spans.append(profiling.Span("a", 5_000, 8_000, -1))
    spans.append(profiling.Span("open", 6_000, None, 0))
    ev = profiling.trace_events(spans, base_ns=1_000)
    assert ev[0]["ph"] == "M" and ev[0]["args"]["name"] == "program spans"
    (a,) = ev[1:]
    assert a["ts"] == pytest.approx((5_000 + 10_000_000 - 4_000 - 1_000)
                                    / 1e3)
    assert a["dur"] == pytest.approx(3.0) and a["pid"] == os.getpid()
    assert a["cat"] == "program_span" and a["args"] == {"index": 0,
                                                        "parent": -1}
