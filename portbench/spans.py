"""The program's spans read against a traced window (``devtrace.Trace``).

While ``torch.profiler`` records, the program records where its host work
happens as spans (``spinglass_tpu_torch.utils.profiling``: ``sa.anneal``,
``sa.start``, ``sa.result``, ``ttt.solve``, ``ttt.start``, ``step.fill``,
``step.launch``, ``read``), on ``time.perf_counter_ns()`` with a pair of
clock readings that places them on ``time.time_ns()``'s clock. A trace's
``ts`` is in us after the profiler's ``baseTimeNanoseconds`` on that clock,
so the spans go onto the trace's clock beside the device's activities and
the host's runtime calls. A program without the recorder has no spans, and
every reading here is None then.

Run on a machine with the card, this module traces one window of a cell and
prints what the spans show: the per-layer readings, the idle gaps named by
span, self time by span, and how well the clocks agree (the share of
``step.launch`` spans that hold a ``cudaGraphLaunch`` and of ``read`` spans
that hold a ``cudaEventSynchronize``)::

    python3 portbench/spans.py --workload planted10k.ttt --seed 7 \
        --seconds 2
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import sys
import tempfile
import time
from collections import defaultdict, namedtuple
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a span on the trace's clock: start and end in us, the parent's index in
# the program's list (-1 for a root), and whether it is a request's root: a
# root with spans under it (``sa.anneal``, ``ttt.solve``), whose own time
# is the driver's code between its phases
TraceSpan = namedtuple("TraceSpan", "name start end parent request")


def program_spans():
    """The program's newest list of spans, or None (none recorded, or a
    program without the recorder)."""
    from spinglass_tpu_torch.utils import profiling

    spans = getattr(profiling.global_profiler, "last", None)
    return spans if spans and hasattr(spans, "wall_ns") else None


@functools.lru_cache(maxsize=None)
def trace_base_ns():
    """``baseTimeNanoseconds`` of this process's profiler traces (one for
    the process: read from an empty trace of the host), or None."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            base = json.load(f).get("baseTimeNanoseconds")
    finally:
        os.remove(path)
    return None if base is None else int(base)


def on_trace(trace):
    """The program's finished spans that overlap the traced window, as
    ``TraceSpan`` on the trace's clock, in the order they started; None
    where there are no spans or the trace's clock is unknown."""
    spans = program_spans()
    base = trace_base_ns() if spans else None
    if base is None:
        return None
    events = trace.device + trace.host
    lo = min(e[1] for e in events)
    hi = max(e[1] + e[2] for e in events)
    parents = {s.parent for s in spans}
    out = []
    for i, s in enumerate(spans):
        if s.end_ns is None:
            continue
        a = (spans.wall_ns(s.start_ns) - base) / 1e3
        b = a + (s.end_ns - s.start_ns) / 1e3
        if b >= lo and a <= hi:
            out.append(TraceSpan(s.name, a, b, s.parent,
                                 s.parent < 0 and i in parents))
    return out


def mean_us(x, name: str):
    """Mean length in us of the window's spans ``name``, or None."""
    d = [s.end - s.start for s in on_trace(x.trace) or () if s.name == name]
    return sum(d) / len(d) if d else None


def innermost(spans: list, times: list) -> list:
    """For each of the ascending ``times``, the innermost span that covers
    it (the latest started), or None."""
    order = sorted(spans, key=lambda s: s.start)
    active, i, out = [], 0, []
    for t in times:
        while i < len(order) and order[i].start <= t:
            active.append(order[i])
            i += 1
        active = [s for s in active if s.end > t]
        out.append(max(active, key=lambda s: s.start) if active else None)
    return out


def _gap_spans(trace, spans):
    """The idle gaps and, for each, the span that names it: the innermost
    over its middle, None where that is none or a request's root."""
    gaps = trace.idle_gaps()
    inner = innermost(spans, [a + 0.5 * n for a, n in gaps])
    return gaps, [None if s is None or s.request else s for s in inner]


def idle_unspanned_pct(x):
    """Device-idle time in gaps that no span names (their middle lies in no
    span, or only in a request root's own time: the drivers' Python between
    their phases, the benchmark's code between jobs), in percent of the
    window."""
    spans = on_trace(x.trace)
    if not spans or x.trace.window_s <= 0:
        return None
    gaps, named = _gap_spans(x.trace, spans)
    us = sum(n for (_, n), s in zip(gaps, named) if s is None)
    return 1e-4 * us / x.trace.window_s


def host_call(trace, times: list) -> list:
    """For each of the ascending ``times``, the runtime call the host was
    in, as ``Trace.idle_by_host`` names it ("host, no op" for none)."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(trace.host) and trace.host[i][1] <= t:
            active.append(trace.host[i])
            i += 1
        active = [h for h in active if h[1] + h[2] > t]
        if active:
            outer = max(active, key=lambda h: h[2])[0]
            inner = min(active, key=lambda h: h[2])[0]
            out.append(outer if outer == inner else f"{outer} > {inner}")
        else:
            out.append("host, no op")
    return out


def idle_by_span(trace, spans: list) -> dict:
    """Idle device seconds by ``<span> | <runtime call>``: the span that
    names each gap (``_gap_spans``; none: the runtime call alone) and the
    call the host was in at its middle."""
    gaps, named = _gap_spans(trace, spans)
    calls = host_call(trace, [a + 0.5 * n for a, n in gaps])
    out = defaultdict(float)
    for (_, n), s, call in zip(gaps, named, calls):
        out[call if s is None else f"{s.name} | {call}"] += n * 1e-6
    return dict(out)


def containment(trace, spans: list, name: str, call: str,
                slack_us: float = 5.0) -> tuple:
    """(spans ``name`` that hold a runtime call ``call`` to within
    ``slack_us`` at either end, spans ``name``)."""
    calls = sorted((h[1], h[1] + h[2]) for h in trace.host if h[0] == call)
    starts = [c[0] for c in calls]
    held = 0
    mine = [s for s in spans if s.name == name]
    for s in mine:
        j = bisect.bisect_left(starts, s.start - slack_us)
        while j < len(calls) and calls[j][0] <= s.end + slack_us:
            if calls[j][1] <= s.end + slack_us:
                held += 1
                break
            j += 1
    return held, len(mine)


def traced_window(name: str, seed: int, seconds: float, device="cuda"):
    """One traced window of cell ``name`` on the card, set up as a run of
    ``run.py`` sets it up: (trace, the program's spans on its clock, the
    readings that the per-layer readers take)."""
    import torch

    from portbench import harness
    from portbench.devtrace import Trace

    bench = harness.benchmark()
    wl = harness.cell(name, bench)
    cfg = harness.load_json("configs", f"{wl['config']}.json")
    ctx = SimpleNamespace(
        device=torch.device(device), workload=wl, params=dict(wl["params"]),
        control=None,
        job_seed=lambda i, stream="job": harness.derived_seed(seed, stream, i))
    ctx.instance = harness.load_module("reference", cfg["generator"]).build(
        cfg, harness.derived_seed(seed, "instance"), ctx.device)
    traffic = harness.load_module("traffic", wl["traffic"])
    runner = traffic.prepare(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()

    def window():
        records, t0 = [], time.perf_counter()
        while True:
            records.append(traffic.job(runner, len(records)))
            if time.perf_counter() - t0 >= seconds:
                return records

    tr = Trace()
    records = tr.record(window)
    x = SimpleNamespace(trace=tr, counts=traffic.counts(records),
                        params=ctx.params, instance=ctx.instance, workload=wl)
    return tr, on_trace(tr), x


def main(argv=None) -> int:
    import argparse

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    tr, spans, x = traced_window(args.workload, args.seed, args.seconds)
    bench = harness.benchmark()
    readings = {}
    for m in harness.per_layer_metrics(bench, args.workload):
        if m["source"] == "program_span":
            readings[m["name"]] = harness.load_module(
                "metrics", m["name"]).read(x)
    prog = program_spans()
    from spinglass_tpu_torch.utils.profiling import global_profiler

    gaps = sorted(idle_by_span(tr, spans).items(), key=lambda kv: -kv[1])
    print(json.dumps({
        "workload": args.workload, "window_s": tr.window_s,
        "busy_s": tr.busy_s(), "jobs": x.counts["jobs"],
        "readings": readings, "idle_by_span": gaps[:16],
        "idle_by_host": sorted(tr.idle_by_host().items(),
                               key=lambda kv: -kv[1])[:10],
        "span_summary": global_profiler.summary(prog),
        "dropped": prog.dropped,
        "launch_holds_graph_launch": containment(
            tr, spans, "step.launch", "cudaGraphLaunch"),
        "read_holds_event_sync": containment(
            tr, spans, "read", "cudaEventSynchronize")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
