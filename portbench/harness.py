"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one cell is found by name:

* ``BENCHMARK.json`` (the repository's root) lists the cells, the metrics
  and ``run_seconds``;
* ``workloads/<cell>.json`` holds the cell's traffic parameters, the
  limits of its check and the names of its sweep kernels;
* ``configs/<config>.json`` holds the configuration and names its
  generator, ``reference/<generator>.py``;
* ``traffic/<traffic>.py`` runs the cell's jobs (``prepare``, ``job``,
  ``end_to_end``, ``counts``, ``judge``);
* ``metrics/<metric>.py`` reads one per-layer metric from a traced window
  (``metrics/<stem>.py`` serves every ``<stem>.<suffix>`` that has no file
  of its own).

A later cell, traffic kind, configuration or metric is new files; no file
here changes for it.

Jobs run back to back in a closed loop with one client (every driver of the
program holds one process-wide lock, so a second client would only queue).
The window starts after set-up and ends with the first job that finishes
after ``seconds``; an end-to-end rate is all the work of the window over
all of its time. With ``trace`` the window runs under ``torch.profiler``
for the workload's ``trace_seconds`` and the run reports the per-layer
metrics instead. After the window: the peak memory is read, the program's
state is freed, the reference judges the answers, and the boundary check
makes sure the process never loaded JAX or the JAX package.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that no run may load: JAX, its parts, and the JAX
# package that the program is a port of (compared as whole names: the
# program's own name begins with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "spinglass_tpu")


class RunFailed(RuntimeError):
    """A run that must print no result."""


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, imported from its file (a
    name may hold dots); where there is no such file, ``<kind>/<stem>.py``
    for the name's part before its first dot, so that one reader serves
    ``device_idle_pct.sa`` and ``device_idle_pct.ttt``."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, kind, f"{name.split('.')[0]}.py")
    if not os.path.exists(path):
        raise RunFailed(f"no {kind} module for {name!r} under {kind}/")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str, bench: dict = None) -> dict:
    """The cell's entry of ``BENCHMARK.json`` merged with its workload file
    (the file's ``params``, ``limits``, ``sweep_kernels``, ...)."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise RunFailed(f"no cell {name!r} in BENCHMARK.json")
    return {**load_json("workloads", f"{name}.json"), **entry}


def derived_seed(seed: int, stream: str, i: int = 0) -> int:
    """A 60-bit seed for job ``i`` of ``stream`` from the run's seed: the
    same seed gives the same jobs, any whole number is taken."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}/{i}".encode()).hexdigest()
    return int(digest[:15], 16)


def boundary_check() -> list:
    """Top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def end_to_end_names(bench: dict, name: str) -> list:
    """The end-to-end metrics cell ``name`` reports: those whose
    ``workloads`` list it, or that have no such list."""
    return [m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def per_layer_metrics(bench: dict, name: str) -> list:
    """The per-layer metrics cell ``name`` reports: those whose
    ``workloads`` list it, or, without the key, whose ``moves`` it
    reports."""
    reported = end_to_end_names(bench, name)
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def run_cell(wl: dict, cfg: dict, bench: dict, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float = None,
             control: str = None) -> dict:
    """One run of the cell ``wl`` (``cell``'s merged entry) on the
    configuration ``cfg``; returns the result object that ``run.py``
    prints. ``device`` "cuda" is the card, which the caller has checked;
    tests pass "cpu". ``control`` names one of the workload's ``controls``,
    a lower-precision stand-in for the program (never set in a benchmark
    run)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    name = wl["name"]
    device = torch.device(device)
    traffic = load_module("traffic", wl["traffic"])
    generator = load_module("reference", cfg["generator"])
    params = dict(wl["params"])
    if control is not None:
        params.update(wl["controls"][control])
    ctx = SimpleNamespace(
        device=device, workload=wl, params=params, control=control,
        job_seed=lambda i, stream="job": derived_seed(seed, stream, i))
    ctx.instance = generator.build(cfg, derived_seed(seed, "instance"), device)
    runner = traffic.prepare(ctx)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    def window(limit_s):
        records, t0 = [], time.perf_counter()
        while True:
            records.append(traffic.job(runner, len(records)))
            if time.perf_counter() - t0 >= limit_s:
                break
        _sync(device)
        return records, time.perf_counter() - t0

    tr = None
    if trace:
        from portbench.devtrace import Trace

        tr = Trace()
        records, _ = tr.record(
            lambda: window(min(seconds, wl["trace_seconds"])))
        window_s = tr.window_s
    else:
        records, window_s = window(seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    checks, failed = traffic.judge(runner, records, ctx)
    del runner
    found = boundary_check()
    if found:
        raise RunFailed(f"loaded modules that no run may load: {found}")
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": int(failed)}
    if trace:
        if not any(tr.device_seconds(k) > 0 for k in wl["sweep_kernels"]):
            raise RunFailed(f"the trace holds no device time for the sweep "
                            f"kernels {wl['sweep_kernels']}")
        readings = SimpleNamespace(trace=tr, counts=traffic.counts(records),
                                   params=params, instance=ctx.instance,
                                   workload=wl)
        metrics = {}
        for m in per_layer_metrics(bench, name):
            value = load_module("metrics", m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s(), window_s=window_s)
        out.update(metrics=metrics, device=dev, breakdown=tr.breakdown())
    else:
        values = traffic.end_to_end(records, window_s)
        metrics = {k: {"value": float(values[k]), "unit": _unit(bench, k)}
                   for k in end_to_end_names(bench, name) if k != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        out.update(metrics=metrics, device=dev)
    out["checks"] = checks
    return out


def _unit(bench: dict, name: str) -> str:
    return next(m["unit"] for m in bench["end_to_end"] if m["name"] == name)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
