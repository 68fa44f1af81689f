"""Quality-gate runner: automated pass/fail checks with a JSON report.

The counterpart of ``spinglass_tpu.benchmarks.quality_gates``, with the
same gates: import health, security hygiene, numerical correctness
invariants, solver performance smoke, the sharded path, graceful
degradation, the suite's time budget. CLI: ``sgt-torch quality-gates``.

The gates run on ``device`` (default: the card, see
``core.problem.resolve_device``). Differences from the JAX gates:
``sharded_pallas_tpu`` is ``sharded_kernel_cuda`` (K1 under the sharded
engine, on the card); ``performance_smoke`` and ``headline_paths`` gate
against this package's ``benchmarks/perf_targets.json`` (measured on an
H100, not the TPU's targets) and turn on no compile cache, which the port
does not have: each bench body keeps its capturing first call out of what
it reports (``time_sweeps``' best of three, ``bench_pt10k``'s second run,
``bench_rl``'s steady windows); ``suite_budget`` runs the port's tests (on
the card the GPU-marked ones, with ``--noconftest``: that machine has no
JAX).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from spinglass_tpu_torch.core.problem import resolve_device
from spinglass_tpu_torch.kernels import build


@dataclass
class GateResult:
    name: str
    passed: bool
    detail: str = ""
    duration_s: float = 0.0


def _gate_imports(device) -> GateResult:
    mods = [
        "spinglass_tpu_torch", "spinglass_tpu_torch.core",
        "spinglass_tpu_torch.anneal", "spinglass_tpu_torch.problems",
        "spinglass_tpu_torch.rl", "spinglass_tpu_torch.distributed",
        "spinglass_tpu_torch.research", "spinglass_tpu_torch.utils",
        "spinglass_tpu_torch.deployment", "spinglass_tpu_torch.benchmarks",
    ]
    failed = []
    for m in mods:
        try:
            __import__(m)
        except Exception as exc:
            failed.append(f"{m}: {exc}")
    return GateResult("imports", not failed, "; ".join(failed) or
                      f"{len(mods)} packages importable")


def _gate_energy_invariants(device) -> GateResult:
    from spinglass_tpu_torch.core import energy as E
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
    from spinglass_tpu_torch.kernels import sweeps as K

    n = 48
    j = topology.fully_connected(n, dist="gaussian", scale=1 / np.sqrt(n),
                                 seed=0)
    h = np.random.default_rng(0).normal(0, 0.3, n)
    p = IsingProblem.from_dense(j, h, device=device)
    s = random_spins(torch.Generator().manual_seed(0), (4, p.n_padded),
                     p.active_mask)
    e0 = E.energy(p, s)
    u = torch.rand(s.shape, generator=torch.Generator().manual_seed(1)).to(
        p.device)
    s1, de, cnt = K.blocked_sweep(p, s, 0.7, u)
    e1 = E.energy(p, s1)
    ok = bool(np.allclose((e0 + de).cpu().numpy(), e1.cpu().numpy(),
                          rtol=1e-3, atol=1e-2))
    sym = bool(torch.equal(p.j, p.j.t()))
    return GateResult("energy_invariants", ok and sym,
                      f"E0+dE==E1 {ok}; J symmetric {sym}")


def _gate_determinism(device) -> GateResult:
    from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem

    j = topology.fully_connected(24, dist="binary", seed=1)
    p = IsingProblem.from_dense(j, device=device)
    cfg = SAConfig(n_sweeps=80, n_replicas=4, use_kernel="auto", seed=7)
    a = anneal(p, cfg)
    b = anneal(p, cfg)
    ok = a.best_energy == b.best_energy and np.array_equal(
        a.best_spins, b.best_spins)
    return GateResult("determinism", bool(ok),
                      f"fixed-seed reproducibility: {a.best_energy} "
                      f"({a.metadata.get('engine')})")


def _gate_solution_quality(device) -> GateResult:
    from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem

    n = 32
    j = topology.fully_connected(n, dist="ferromagnetic", seed=0)
    p = IsingProblem.from_dense(np.asarray(j), device=device)
    res = anneal(p, SAConfig(n_sweeps=200, n_replicas=8, use_kernel="auto",
                             seed=0))
    target = -n * (n - 1) / 2
    ok = res.best_energy <= 0.95 * target
    return GateResult("solution_quality", bool(ok),
                      f"FM ground state {res.best_energy} vs {target}")


def _load_perf_targets() -> dict:
    """The committed gate targets of the port (benchmarks/perf_targets.json:
    H100 numbers measured with chip_smoke.py and the gates derived from
    them)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "perf_targets.json")
    with open(path) as f:
        return json.load(f)["gates"]


def _gate_performance_smoke(device, min_flips=None) -> GateResult:
    """Throughput gate. On the card the dense headline benchmark
    (``headline.bench_dense``, K1 at N=4096, R=1024) against
    perf_targets.json's dense gate; on the CPU a smoke test at 1e4 flips/s
    (the JAX gate's 1e5 is XLA's; the port's CPU sweep is the kernels'
    plain version, a Python loop over the spins, and the CI machine's speed
    is not known). An explicit ``min_flips`` is authoritative (0.0
    included)."""
    if device.type == "cuda":
        from spinglass_tpu_torch.benchmarks import headline

        gate = (_load_perf_targets()["dense_flips_min"]
                if min_flips is None else min_flips)
        res = headline.bench_dense()
        fps = res["value"]
        return GateResult("performance_smoke", bool(fps >= gate),
                          f"{fps:.4g} flips/s (gate {gate:.3g}, "
                          f"{res['extras']['nvidia_smi']}, headline dense "
                          f"shape)")

    from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem

    n, r, sweeps = 64, 16, 200
    gate = 1e4 if min_flips is None else min_flips
    j = topology.fully_connected(n, dist="gaussian", scale=1 / np.sqrt(n),
                                 seed=2)
    p = IsingProblem.from_dense(j, device=device)
    cfg = SAConfig(n_sweeps=sweeps, n_replicas=r, enable_early_stop=False,
                   seed=0)
    anneal(p, cfg)                      # captures
    res = anneal(p, cfg)                # replays the cached step
    ok = res.spin_flips_per_second >= gate
    return GateResult("performance_smoke", bool(ok),
                      f"{res.spin_flips_per_second:.3g} flips/s "
                      f"(gate {gate:.0g}, cpu, n={n} r={r})")


def _gate_security(device) -> GateResult:
    from spinglass_tpu_torch.utils.security import (sanitize_path,
                                                    validate_problem_payload)

    issues = []
    try:
        sanitize_path("../../etc/passwd", base_dir="/tmp")
        issues.append("path traversal not rejected")
    except Exception:
        pass
    try:
        validate_problem_payload(np.full((3, 4), np.nan))
        issues.append("invalid payload not rejected")
    except Exception:
        pass
    return GateResult("security", not issues, "; ".join(issues) or
                      "traversal + payload validation enforced")


def _gate_multidevice(device) -> GateResult:
    """``pt_sharded.run`` over the group that is up (one is brought up on
    ``device`` where none is: a one-rank group still runs the gather and
    the sharded exchange)."""
    from spinglass_tpu_torch.anneal.pt import PTConfig
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem
    from spinglass_tpu_torch.distributed import multihost, pt_sharded

    info = multihost.initialize(device=device)
    world = info["process_count"]
    j = topology.fully_connected(16, dist="binary", seed=3)
    p = IsingProblem.from_dense(j, device=multihost.device_of_group())
    cfg = PTConfig(n_replicas=2 * world, n_sweeps=20, exchange_interval=10,
                   use_kernel="auto", seed=0)
    res = pt_sharded.run(p, cfg, pt_sharded.make_mesh())
    return GateResult("multidevice", bool(np.isfinite(res.best_energy)),
                      f"sharded PT over {world} rank(s) "
                      f"({info['backend']}): {res.algorithm}")


def _gate_sharded_kernel_cuda(device) -> GateResult:
    """On the card: one super-step of the sharded PT step on a one-rank
    mesh through K1 (``ShardedFusedEngine``) at N=256, R=8 — the sharded
    kernel path runs on the hardware it targets. Skipped off the card."""
    if device.type != "cuda":
        return GateResult("sharded_kernel_cuda", True,
                          "skipped: device is not cuda")
    from spinglass_tpu_torch.anneal.pt import PTConfig
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem
    from spinglass_tpu_torch.distributed import multihost, pt_sharded

    multihost.initialize(device=device)
    j = topology.fully_connected(256, dist="gaussian", scale=1.0 / 16.0,
                                 seed=3)
    p = IsingProblem.from_dense(j, device=device)
    mesh = pt_sharded.make_mesh(device)
    cfg = PTConfig(n_replicas=8 * mesh.size(), exchange_interval=2,
                   n_sweeps=4, sweep_method="blocked", use_kernel="always",
                   min_temp=0.2, max_temp=5.0, seed=0)
    step, init, _, engine, _ = pt_sharded.make_sharded_pt_step(p, cfg, mesh)
    if not isinstance(engine, pt_sharded.ShardedFusedEngine):
        return GateResult("sharded_kernel_cuda", False,
                          f"dispatch picked {engine.name}, not the "
                          f"sharded K1 engine")
    launches0 = build.launch_snapshot()
    state = init()
    state, stats = step(state)
    torch.cuda.synchronize(device)
    ok = bool(torch.all(torch.isfinite(state.energy)))
    slots = np.sort(stats["slot_of_replica"].cpu().numpy())
    slots_ok = bool((slots == np.arange(cfg.n_replicas)).all())
    moved = build.launches_since(launches0, engine.kernel_names)
    return GateResult("sharded_kernel_cuda",
                      ok and slots_ok and sum(moved.values()) > 0,
                      f"K1 under the sharded engine on the card: finite="
                      f"{ok}, slots_ok={slots_ok}, launches {moved}")


def _gate_headline_paths(device) -> GateResult:
    """On the card: the sparse / pt10k / ttt / rl headline paths at
    ``chip_smoke.py``'s protocols, each gated against perf_targets.json.
    Skipped off the card (machine speed unknown)."""
    if device.type != "cuda":
        return GateResult("headline_paths", True,
                          "skipped: device is not cuda")
    from spinglass_tpu_torch.benchmarks import headline

    t = _load_perf_targets()
    checks = [
        ("sparse", lambda: headline.bench_sparse(sweeps=1000), "ge",
         t["sparse_flips_min"]),
        ("pt10k", lambda: headline.bench_pt10k(sweeps=300), "le",
         t["pt10k_wall_max_s"]),
        ("ttt", lambda: headline.bench_ttt(max_sweeps=20000), "le",
         t["ttt_median_max_s"]),
        ("rl", lambda: headline.bench_rl(n_updates=48), "ge",
         t["rl_env_steps_min"]),
    ]
    parts, ok = [], True
    for name, fn, op, gate in checks:
        try:
            val = fn()["value"]
        except Exception as exc:
            ok = False
            parts.append(f"{name}=ERROR({type(exc).__name__}: {exc})"[:160])
            continue
        good = val >= gate if op == "ge" else val <= gate
        ok = ok and good
        parts.append(f"{name}={val:.4g}{'' if good else '!'} "
                     f"(gate {'>=' if op == 'ge' else '<='}{gate:.3g})")
    return GateResult("headline_paths", bool(ok), "; ".join(parts))


def _gate_suite_budget(device) -> GateResult:
    """Run the port's tests and enforce the wall budget: 480 s in all and,
    for any one test, 30 s under 2 xdist workers (where ``xdist`` imports:
    a test's wall time up to doubles beside the other worker) or 15 s in
    one process, as the JAX package's gate. On the card the GPU-marked
    tests (``tests/test_torch_gpu.py -m gpu --noconftest``: that machine
    has no JAX, which tests/conftest.py imports); on the CPU the port's CPU
    tests (``tests/test_torch_*.py -m "not slow and not gpu"``)."""
    import re
    import subprocess
    import sys

    if os.environ.get("PYTEST_CURRENT_TEST"):
        # a test may run run_quality_gates() — spawning the suite from
        # inside the suite would recurse without bound
        return GateResult("suite_budget", True,
                          "skipped: already inside a pytest run")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if device.type == "cuda":
        args = ["tests/test_torch_gpu.py", "-m", "gpu", "--noconftest"]
    else:
        import glob

        args = sorted(os.path.relpath(p, repo) for p in glob.glob(
            os.path.join(repo, "tests", "test_torch_*.py")))
        args += ["-m", "not slow and not gpu"]
    try:
        import xdist  # noqa: F401

        workers, ceiling, mode = ["-n", "2"], 30.0, "2 xdist workers"
    except ImportError:
        workers, ceiling, mode = [], 15.0, "sequential"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", *args, "-q", "-p",
             "no:cacheprovider", "--durations=15", "--durations-min=1.0",
             *workers],
            cwd=repo, capture_output=True, text=True, timeout=900)
    except subprocess.TimeoutExpired:
        return GateResult("suite_budget", False,
                          "the suite exceeded the 900 s hard timeout "
                          "(budget is 480 s)")
    wall = time.perf_counter() - t0
    out = proc.stdout or ""
    if proc.returncode != 0:
        tail = " | ".join(out.strip().splitlines()[-3:])[:300]
        return GateResult("suite_budget", False,
                          f"suite FAILED (rc={proc.returncode}): {tail}")
    # lines like "12.34s call     tests/test_torch_x.py::test_y"
    slowest, worst = 0.0, ""
    for m in re.finditer(r"^\s*(\d+\.\d+)s\s+(call|setup|teardown)\s+(\S+)",
                         out, re.M):
        if float(m.group(1)) > slowest:
            slowest, worst = float(m.group(1)), m.group(3)
    ok = wall <= 480.0 and slowest <= ceiling
    return GateResult(
        "suite_budget", bool(ok),
        f"{mode}: wall {wall:.0f}s (budget 480s); slowest test "
        f"{slowest:.1f}s {worst} (ceiling {ceiling:.0f}s)")


def _gate_graceful_degradation(device) -> GateResult:
    from spinglass_tpu_torch.core.minimal import (MinimalAnnealer,
                                                  create_test_problem)

    model = create_test_problem(10, seed=4)
    result = MinimalAnnealer(n_sweeps=200, seed=0).anneal(model)
    ok = np.isfinite(result["best_energy"])
    return GateResult("graceful_degradation", bool(ok),
                      f"stdlib-only annealer best={result['best_energy']}")


DEFAULT_GATES: Dict[str, Callable[[torch.device], GateResult]] = {
    "imports": _gate_imports,
    "energy_invariants": _gate_energy_invariants,
    "determinism": _gate_determinism,
    "solution_quality": _gate_solution_quality,
    "performance_smoke": _gate_performance_smoke,
    "headline_paths": _gate_headline_paths,
    "security": _gate_security,
    "multidevice": _gate_multidevice,
    "sharded_kernel_cuda": _gate_sharded_kernel_cuda,
    "graceful_degradation": _gate_graceful_degradation,
    "suite_budget": _gate_suite_budget,
}


def run_quality_gates(gates: Optional[List[str]] = None,
                      report_path: Optional[str] = None,
                      device=None) -> dict:
    """Run gates on ``device`` (default: the card), return (and optionally
    write) the JSON report. An unknown gate name raises ``KeyError``."""
    device = resolve_device(device)
    selected = gates or list(DEFAULT_GATES)
    unknown = [g for g in selected if g not in DEFAULT_GATES]
    if unknown:
        raise KeyError(f"unknown gates {unknown}; choose from "
                       f"{sorted(DEFAULT_GATES)}")
    results = []
    for name in selected:
        fn = DEFAULT_GATES[name]
        t0 = time.perf_counter()
        try:
            r = fn(device)
        except Exception as exc:
            r = GateResult(name, False, f"{type(exc).__name__}: {exc}")
        r.duration_s = time.perf_counter() - t0
        results.append(r)
    report = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "device": str(device),
        "summary": {
            "total": len(results),
            "passed": sum(r.passed for r in results),
            "failed": sum(not r.passed for r in results),
        },
        "gates": [r.__dict__ for r in results],
    }
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
    return report
