"""Arithmetic shared by the per-layer readers (``metrics/<name>.py``). A
reader gets the traced window's ``trace`` (``devtrace.Trace``), the
program's ``counts`` of the work done in it (jobs, sweeps, env steps), the
cell's ``params``, ``instance`` and ``workload``; it returns a number, or
None where it finds nothing to read."""

from __future__ import annotations


def sweep_seconds(x) -> float:
    """Device seconds of the cell's sweep kernels in the window."""
    return sum(x.trace.device_seconds(k) for k in x.workload["sweep_kernels"])


def roofline_pct(x, least_s_per_sweep: float):
    """The sweep kernels' share of their bound: the least time of the
    window's sweeps over their device time, in percent."""
    t = sweep_seconds(x)
    if t <= 0 or x.counts["sweeps"] <= 0:
        return None
    return 100.0 * least_s_per_sweep * x.counts["sweeps"] / t


def other_us_per(x, unit: str):
    """Device microseconds of every kernel but the sweep kernels, per
    ``unit`` (a key of the counts)."""
    if x.counts.get(unit, 0) <= 0:
        return None
    return 1e6 * (x.trace.device_seconds() - sweep_seconds(x)) / x.counts[unit]


def kernels_per(x, unit: str):
    if x.counts.get(unit, 0) <= 0:
        return None
    return len(x.trace.kernels()) / x.counts[unit]


def idle_pct(x):
    w = x.trace.window_s
    return None if w <= 0 else 100.0 * (1.0 - x.trace.busy_s() / w)


def replicas(x) -> int:
    """The sweep's replica count: the parameter that the workload file
    names under ``replicas_param``."""
    return int(x.params[x.workload["replicas_param"]])


def nnz(x) -> int:
    return len(x.instance["rows"])
