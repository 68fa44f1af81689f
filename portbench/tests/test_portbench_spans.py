"""The program's spans against a traced window (``portbench/spans.py``):
their conversion to the trace's clock, the idle gaps named by span, the
readers of the span metrics (None without spans), and on the card the
agreement of the two clocks."""

from types import SimpleNamespace

import pytest

from portbench import harness, spans as S
from portbench.devtrace import Trace

SPAN_METRICS = ("start_ms_per_job", "fill_us_per_replay",
                "launch_us_per_replay", "idle_unspanned_pct")


def _trace():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 12, "dur": 4},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 30, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 10.5, "dur": 1},
    ]
    t = Trace()
    t._read({"traceEvents": ev})
    t.window_s = 70e-6
    return t


def _spans():
    """Program spans whose clock pair puts them at their ns / 1000 us on
    the trace's clock: a request (``sa.anneal`` and its phases) and a
    step with no request above it, as PPO's updates have."""
    from spinglass_tpu_torch.utils import profiling

    sp = profiling.Spans()
    sp.clock[0] = (S.trace_base_ns(), 0)
    for row in (("sa.anneal", 0, 42_000, -1), ("sa.start", 1_000, 3_000, 0),
                ("step.fill", 9_000, 10_000, 0),
                ("step.launch", 10_200, 11_800, 0),
                ("read", 20_000, 22_000, 0),
                ("read", 41_000, None, 0),             # never ended
                ("step.fill", 44_000, 46_000, -1),     # a root of its own
                ("step.fill", 100_000, 101_000, -1)):  # after the window
        sp.append(profiling.Span(*row))
    return sp


@pytest.fixture
def recorded(monkeypatch):
    from spinglass_tpu_torch.utils import profiling

    sp = _spans()
    monkeypatch.setattr(profiling.global_profiler, "last", sp)
    return sp


def test_spans_go_onto_the_traces_clock(recorded):
    got = S.on_trace(_trace())
    assert [s.name for s in got] == ["sa.anneal", "sa.start", "step.fill",
                                     "step.launch", "read", "step.fill"]
    assert got[3] == S.TraceSpan("step.launch", pytest.approx(10.2),
                                 pytest.approx(11.8), 0, False)
    assert [s.request for s in got] == [True] + [False] * 5


def test_gaps_are_named_by_the_innermost_span_below_a_request(recorded):
    t = _trace()
    spans = S.on_trace(t)
    assert t.idle_gaps() == [(10, 2), (16, 14), (40, 10)]
    named = S.idle_by_span(t, spans)
    assert named == {"step.launch | cudaGraphLaunch": pytest.approx(2e-6),
                     "host, no op": pytest.approx(14e-6),
                     "step.fill | host, no op": pytest.approx(10e-6)}
    assert S.host_call(t, [11, 23]) == ["cudaGraphLaunch", "host, no op"]
    assert S.containment(t, spans, "step.launch", "cudaGraphLaunch") == (1, 1)
    assert S.containment(t, spans, "step.launch", "cudaGraphLaunch",
                         slack_us=0.0) == (1, 1)
    assert S.containment(t, spans, "read", "cudaGraphLaunch") == (0, 1)


@pytest.mark.parametrize("suffix", ["sa", "ttt", "ppo"])
def test_span_readers(recorded, suffix):
    x = SimpleNamespace(trace=_trace())
    read = {stem: harness.load_module("metrics", f"{stem}.{suffix}").read(x)
            for stem in SPAN_METRICS}
    assert read["start_ms_per_job"] == pytest.approx(0.002)
    assert read["fill_us_per_replay"] == pytest.approx(1.5)
    assert read["launch_us_per_replay"] == pytest.approx(1.6)
    # the 14 us gap lies in the request's own time: 20% of the 70 us window
    assert read["idle_unspanned_pct"] == pytest.approx(20.0)


@pytest.mark.parametrize("program", ["none recorded", "no recorder"])
def test_span_readers_read_none_without_spans(monkeypatch, program):
    from spinglass_tpu_torch.utils import profiling

    if program == "none recorded":
        monkeypatch.setattr(profiling.global_profiler, "last", None)
    else:   # a program from before the recorder
        monkeypatch.setattr(profiling, "global_profiler", SimpleNamespace())
    x = SimpleNamespace(trace=_trace())
    assert S.program_spans() is None and S.on_trace(x.trace) is None
    for stem in SPAN_METRICS:
        assert harness.load_module("metrics", f"{stem}.ttt").read(x) is None


def test_span_metrics_are_declared_for_the_cells_that_record_them(bench):
    mine = [m for m in bench["per_layer"] if m["source"] == "program_span"]
    assert sorted(m["name"] for m in mine) == sorted(
        ["start_ms_per_job.sa"] + [f"{s}.{c}" for s in SPAN_METRICS[1:]
                                   for c in ("sa", "ttt", "ppo")])
    for m in mine:
        assert all(m["moves"] in harness.end_to_end_names(bench, w)
                   for w in m["workloads"])


@pytest.mark.gpu
def test_the_span_clock_agrees_with_the_trace_on_the_card(cuda):
    """In a traced ``planted10k.ttt`` window, 99% of the ``step.launch``
    spans hold a ``cudaGraphLaunch`` and 99% of the ``read`` spans a
    ``cudaEventSynchronize``, each to within 5 us."""
    tr, spans, _ = S.traced_window("planted10k.ttt", 2 ** 31 + 5, 1.0)
    for name, call in (("step.launch", "cudaGraphLaunch"),
                       ("read", "cudaEventSynchronize")):
        held, n = S.containment(tr, spans, name, call)
        assert n >= 100 and held >= 0.99 * n, (name, held, n)
