"""Headline benchmarks of the port on one GPU.

The counterparts of ``spinglass_tpu.benchmarks.headline``, at the same
shapes:
  * ``bench_dense``: SK glass, N=4096, R=1024, beta = 1, sweeps through
    ``make_engine``'s dense engine (K1), CUDA events after a warm-up;
  * ``bench_sparse``: 10k spins, average degree 6, Gaussian, R=1024, 2000
    sweeps through the transposed sparse engine (K2), CUDA events;
  * ``bench_pt10k``: wall-clock of a 10k-spin 16-replica PT run (1000
    sweeps, the plain [R, N] sparse engine), second of two runs;
  * ``bench_ttt``: time-to-target on the planted 10k instance of
    ``spinglass_tpu/benchmarks/ttt_provenance.json`` (read as a data file,
    instance hash checked), 128-replica PT, median of three seeds.
PPO is not ported yet. A run without a CUDA device raises: no number from
the CPU is reported under a device metric.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

N_SPINS = 4096
N_REPLICAS = 1024
N_SWEEPS = 2000
SEED = 42

SPARSE_N = 10_000
SPARSE_DEG = 6.0
SPARSE_REPLICAS = 1024
SPARSE_SWEEPS = 2000

TTT_PROVENANCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "spinglass_tpu", "benchmarks", "ttt_provenance.json")
TTT_SEEDS = (42, 43, 44)


def device_description() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_sweeps(engine, spins, beta, generator, sweeps: int, trials: int = 3,
                warmup: int = 5) -> float:
    """Best-of-``trials`` seconds for ``sweeps`` engine sweeps, CUDA events."""
    for _ in range(warmup):
        spins, _, _ = engine.sweep(spins, beta, generator)
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(sweeps):
            spins, _, _ = engine.sweep(spins, beta, generator)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3)
    return best


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the headline benchmarks measure the GPU; "
                           "no CUDA device found")


def _sk_problem(n: int):
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem

    _need_cuda()
    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=SEED)
    return IsingProblem.from_dense(j, device="cuda")


def bench_dense(n: int = N_SPINS, r: int = N_REPLICAS,
                sweeps: int = N_SWEEPS, trials: int = 3,
                block_size: int = 0) -> dict:
    """Dense fused-kernel sweep throughput (flips/s on one GPU).
    ``block_size`` 0 lets the engine pick (256 where it divides Np);
    ``anneal``'s ``SAConfig`` default is 128."""
    from spinglass_tpu_torch.anneal.engines import make_engine
    from spinglass_tpu_torch.core.problem import random_spins

    problem = _sk_problem(n)
    engine = make_engine(problem, sweep_method="blocked", use_kernel="auto",
                         block_size=block_size)
    gen = torch.Generator().manual_seed(SEED)
    spins = engine.to_layout(
        random_spins(gen, (r, problem.n_padded), problem.active_mask))
    beta = torch.ones(r, dtype=torch.float32, device="cuda")
    best = time_sweeps(engine, spins, beta, gen, sweeps, trials)
    flips = sweeps * r * n
    return {
        "metric": "spin_flips_per_sec",
        "value": flips / best,
        "unit": "flips/s",
        "extras": {"n_spins": n, "n_replicas": r, "n_sweeps": sweeps,
                   "seconds": best, "us_per_sweep": best / sweeps * 1e6,
                   "engine": engine.name,
                   "block_size": getattr(engine, "fused", engine).block_size,
                   "device": torch.cuda.get_device_name(0),
                   "nvidia_smi": device_description()},
    }


def sparse_bench_problem(n: int = SPARSE_N):
    """The sparse bench instance: n spins, average degree 6, Gaussian
    couplings, as an EllProblem on the card."""
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    coo = topology.sparse_random_graph_coo(n, avg_degree=SPARSE_DEG,
                                           dist="gaussian", seed=SEED)
    return EllProblem.from_coo(n, *coo, device="cuda")


def bench_sparse(n: int = SPARSE_N, r: int = SPARSE_REPLICAS,
                 sweeps: int = SPARSE_SWEEPS, trials: int = 3) -> dict:
    """Sparse sweep throughput (flips/s on one GPU): make_engine's engine for
    an EllProblem with r_hint=R, beta = 1."""
    from spinglass_tpu_torch.anneal.engines import make_engine
    from spinglass_tpu_torch.core.problem import random_spins

    _need_cuda()
    ell = sparse_bench_problem(n)
    engine = make_engine(ell, r_hint=r)
    gen = torch.Generator().manual_seed(SEED)
    spins = engine.to_layout(random_spins(gen, (r, ell.n_padded),
                                          ell.active_mask))
    beta = torch.ones(r, dtype=torch.float32, device="cuda")
    best = time_sweeps(engine, spins, beta, gen, sweeps, trials)
    return {
        "metric": "sparse_spin_flips_per_sec",
        "value": sweeps * r * n / best,
        "unit": "flips/s",
        "extras": {"n_spins": n, "avg_degree": SPARSE_DEG, "n_replicas": r,
                   "n_sweeps": sweeps, "seconds": best,
                   "us_per_sweep": best / sweeps * 1e6, "engine": engine.name,
                   "n_sorted": getattr(engine, "n_sorted", None),
                   "device": torch.cuda.get_device_name(0),
                   "nvidia_smi": device_description()},
    }


def bench_pt10k(n: int = SPARSE_N, sweeps: int = 1000) -> dict:
    """Wall-clock of a full 10k-spin 16-replica PT run (the second of two
    runs, so the first pays for set-up)."""
    from spinglass_tpu_torch.anneal import pt as pt_mod

    _need_cuda()
    ell = sparse_bench_problem(n)
    cfg = pt_mod.PTConfig(n_replicas=16, n_sweeps=sweeps, seed=SEED)
    pt_mod.run(ell, cfg)
    res = pt_mod.run(ell, cfg)
    return {
        "metric": "pt_10k_wall_seconds",
        "value": res.total_time,
        "unit": "s",
        "extras": {"n_spins": n, "n_replicas": 16, "n_sweeps": sweeps,
                   "best_energy": res.best_energy,
                   "flips_per_sec": res.spin_flips_per_second,
                   "engine": res.metadata["engine"],
                   "device": torch.cuda.get_device_name(0),
                   "nvidia_smi": device_description()},
    }


def ttt_instance():
    """The time-to-target instance of ttt_provenance.json as an EllProblem on
    the card, with the provenance record. Raises if the generated instance's
    hash differs from the recorded one."""
    from spinglass_tpu_torch.benchmarks import planted
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    with open(TTT_PROVENANCE) as f:
        prov = json.load(f)
    spec = prov["instance"]
    inst = planted.planted_gauge_coo(
        spec["n_spins"], avg_degree=spec["avg_degree"], seed=spec["seed"],
        frustration=spec["frustration"], magnitude=spec["magnitude"])
    got = planted.instance_hash(inst)
    if got != spec["sha256"]:
        raise RuntimeError(f"TTT instance hash mismatch: generated {got} vs "
                           f"provenance {spec['sha256']}")
    ell = EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols, inst.vals,
                              device="cuda")
    return ell, prov


def ttt_config():
    """The 128-replica PT configuration of the time-to-target bench."""
    from spinglass_tpu_torch.anneal import pt as pt_mod

    return pt_mod.PTConfig(n_replicas=128, exchange_interval=10,
                           min_temp=0.05, max_temp=3.0, seed=SEED)


def bench_ttt(max_sweeps: int = 0, seeds=TTT_SEEDS) -> dict:
    """Time-to-target on the planted 10k instance: median wall-clock over
    ``seeds`` fresh PT runs to reach within rel_gap of the provenance's
    best-known energy. ``max_sweeps`` 0 takes the provenance's cap."""
    from spinglass_tpu_torch.benchmarks import planted

    _need_cuda()
    ell, prov = ttt_instance()
    target, rel_gap = prov["best_known_energy"], prov["rel_gap"]
    out = planted.time_to_target(ell, target, ttt_config(), rel_gap=rel_gap,
                                 max_sweeps=max_sweeps or prov["max_sweeps"],
                                 seeds=seeds)
    return {
        "metric": "time_to_target_seconds",
        "value": out["seconds"],
        "unit": "s",
        "extras": {"n_spins": ell.n_spins, "target_energy": target,
                   "threshold": out["threshold"], "rel_gap": rel_gap,
                   "best_energy": out["best_energy"], "all_hit": out["all_hit"],
                   "sweeps": out["sweeps"], "per_seed": out["per_seed"],
                   "seconds_min": out["seconds_min"],
                   "seconds_max": out["seconds_max"], "engine": out["engine"],
                   "device": torch.cuda.get_device_name(0),
                   "nvidia_smi": device_description()},
    }


def _profile(step, sweeps: int, top: int) -> dict:
    """Where ``step`` (a closure that runs ``sweeps`` sweeps of a driver's
    loop and synchronises nothing itself) spends its time on the GPU.

    Runs it once to warm up, once on the host clock, and twice under
    ``torch.profiler``: a warm-up step (the profiler misses the first events
    it sees) and the recorded step. Returns us/sweep of the timed runs, the
    kernels' device time per sweep (one stream, so they do not overlap), the
    device-busy share (device time over the unprofiled run's wall time: the
    profiler's own host cost would otherwise count as idle) and the ``top``
    kernels.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
            prof.step()
    # kernels only: an operator's entry repeats its kernels' device time,
    # and the step annotation ("ProfilerStep*") spans the whole run
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.is_user_annotation
              and not e.key.startswith("ProfilerStep")]
    device_us = sum(e.self_device_time_total for e in events) / sweeps
    events.sort(key=lambda e: -e.self_device_time_total)
    return {
        "sweeps": sweeps,
        "us_per_sweep": wall / sweeps * 1e6,
        "profiled_us_per_sweep": prof_wall / sweeps * 1e6,
        "device_us_per_sweep": device_us,
        "device_busy_share": device_us / (wall / sweeps * 1e6),
        "kernels": [{"name": e.key, "calls": e.count,
                     "us_per_sweep": e.self_device_time_total / sweeps}
                    for e in events[:top]],
        "nvidia_smi": device_description(),
    }


def _profile_sa(problem, r: int, sweeps: int, top: int, **cfg_kw) -> dict:
    from spinglass_tpu_torch.anneal import sa

    cfg = sa.SAConfig(n_sweeps=10 * sweeps, n_replicas=r, **cfg_kw)
    engine = sa.make_sweep_engine(problem, cfg)
    state = sa.init_state(problem, cfg, engine)

    def step():
        nonlocal state
        state, _ = sa.run_chunk(problem, cfg, engine, state, sweeps)

    out = _profile(step, sweeps, top)
    out.update(n_spins=problem.n_spins, n_replicas=r, engine=engine.name)
    return out


def profile_chunk(n: int = N_SPINS, r: int = N_REPLICAS, sweeps: int = 50,
                  block_size: int = 128, top: int = 8) -> dict:
    """One chunk of ``sweeps`` sweeps of ``anneal``'s loop (``sa.run_chunk``,
    the default schedule) on the dense SK glass, profiled (``_profile``)."""
    out = _profile_sa(_sk_problem(n), r, sweeps, top, block_size=block_size)
    out["block_size"] = block_size
    return out


def profile_sparse_chunk(r: int = SPARSE_REPLICAS, sweeps: int = 50,
                         top: int = 8) -> dict:
    """One chunk of ``anneal``'s loop on the sparse bench instance (K2 at
    R=1024), profiled (``_profile``)."""
    _need_cuda()
    return _profile_sa(sparse_bench_problem(), r, sweeps, top)


def profile_ttt(super_steps: int = 20, top: int = 8) -> dict:
    """``super_steps`` PT super-steps of the time-to-target loop (the TTT
    instance and configuration, with the per-super-step 4-byte read),
    profiled (``_profile``); per-sweep figures count exchange_interval
    sweeps per super-step."""
    from spinglass_tpu_torch.anneal import pt as pt_mod

    _need_cuda()
    ell, _ = ttt_instance()
    cfg = ttt_config()
    super_step, _, engine = pt_mod.make_pt_step(ell, cfg)
    state = pt_mod.init_state(ell, cfg, torch.Generator().manual_seed(SEED),
                              engine)

    def step():
        nonlocal state
        for _ in range(super_steps):
            state, stats = super_step(state)
            float(stats["best_energy"])

    out = _profile(step, super_steps * cfg.exchange_interval, top)
    out.update(n_spins=ell.n_spins, n_replicas=cfg.n_replicas,
               engine=engine.name, super_steps=super_steps)
    return out


def profile_pt_wide(accept_kernel: str = "auto", super_steps: int = 3,
                    top: int = 6) -> dict:
    """PT at R=4096 (32 chains of 128) on the sparse bench instance, the
    path beyond K2's budget: ``super_steps`` super-steps of ``pt``'s step
    through SortedSparseTEngine(accept_kernel=...), "auto" being the K3
    path and "fused" the K4 path, profiled (``_profile``)."""
    from spinglass_tpu_torch.anneal import pt as pt_mod
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    _need_cuda()
    ell = sparse_bench_problem()
    cfg = pt_mod.PTConfig(n_replicas=128, n_chains=32, exchange_interval=10,
                          min_temp=0.05, max_temp=3.0)
    engine = SortedSparseTEngine(ell, accept_kernel=accept_kernel)
    super_step, _, engine = pt_mod.make_pt_step(ell, cfg, engine=engine)
    state = pt_mod.init_state(ell, cfg, torch.Generator().manual_seed(SEED),
                              engine)

    def step():
        nonlocal state
        for _ in range(super_steps):
            state, _ = super_step(state)

    out = _profile(step, super_steps * cfg.exchange_interval, top)
    out.update(n_spins=ell.n_spins, n_replicas=cfg.n_replicas * cfg.n_chains,
               accept_kernel=accept_kernel, launches=engine.launches)
    return out


if __name__ == "__main__":
    print(json.dumps(bench_dense(block_size=128)))
    print(json.dumps(profile_chunk()))
    print(json.dumps(profile_sparse_chunk()))
    print(json.dumps(profile_ttt()))
    for accept_kernel in ("auto", "fused"):
        print(json.dumps(profile_pt_wide(accept_kernel)))
    for bench in (bench_sparse, bench_pt10k, bench_ttt):
        print(json.dumps(bench()))
