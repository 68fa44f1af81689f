"""Headline benchmarks of the port on one GPU.

The counterparts of ``spinglass_tpu.benchmarks.headline``, at the same
shapes:
  * ``bench_dense``: SK glass, N=4096, R=1024, beta = 1, sweeps through
    ``make_engine``'s dense engine (K1), CUDA events after a warm-up;
  * ``bench_sparse``: 10k spins, average degree 6, Gaussian, R=1024, 2000
    sweeps through the transposed sparse engine (K2), CUDA events;
  * ``bench_pt10k``: wall-clock of a 10k-spin 16-replica PT run (1000
    sweeps, ``make_engine``'s engine: K4), second of two runs (the first
    captures the super-step; the second is a cache hit, as JAX's second run
    reuses its executable);
  * ``bench_ttt``: time-to-target on the planted 10k instance of
    ``spinglass_tpu/benchmarks/ttt_provenance.json`` (read as a data file,
    instance hash checked), 128-replica PT, median of three seeds.
  * ``bench_pt_wide``: ms/sweep of PT at R=4096 (32 chains of 128) on the
    sparse bench instance three ways in turns: the threshold path (K3 and
    the plain per-colour sweep), the fused path (K4 in gather mode) and K2
    with the engine's single-sweep budget lifted; ``profile_pt_wide`` gives
    each way's device breakdown; ``bench_pt16`` holds ``make_engine``'s
    engine (K4) against the plain [R, N] engine at ``bench_pt10k``'s 16
    replicas.
  * ``bench_rl``: PPO training throughput in env steps/s on the SK glass at
    N=512 with 256 envs (10 sweeps per env step through K1, rollouts of 8),
    the median of three windows of per-update wall times after a warm-up;
    ``profile_rl`` gives the device breakdown of one update and the split
    between its rollout and its learning phase.
  * ``bench_dqn``: DQN training throughput at the same shape, the DQN
    defaults (buffer 4096, batch 128, uniform replay), k act+learn steps
    per read;
    ``profile_dqn`` the device breakdown of one step and its act / learn
    split; ``bench_evaluate`` the captured ``evaluate_controllers`` against
    the eager loop of its episodes, and one ``rollout_best_energy`` call
    (its step captured anew) against the eager loop of its episode.
  * ``captured_vs_plain``: each captured driver against the eager loop of
    the same step, in turns in one process: the dense and the sparse SA
    chunk, the TTT loop and one PPO update; and whole calls of ``anneal``
    (dense and sparse, 500 sweeps) and ``pt.run`` (``bench_pt10k``'s) three
    ways: the eager loop, a first call (the capture included) and a repeat
    call (a cache hit).
The drivers (``anneal``, ``pt.run``, ``time_to_target``, ``ppo.train``) and
the ``profile_*`` functions run the captured steps (``anneal.graphs``): a
replayed graph's kernels show in ``torch.profiler`` as device kernels, so
the busy shares stay comparable with the eager loop's.
A run without a CUDA device raises: no number from the CPU is reported under
a device metric.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import time

import numpy as np
import torch

from spinglass_tpu_torch.anneal.engines import launch_counters

N_SPINS = 4096
N_REPLICAS = 1024
N_SWEEPS = 2000
SEED = 42

SPARSE_N = 10_000
SPARSE_DEG = 6.0
SPARSE_REPLICAS = 1024
SPARSE_SWEEPS = 2000

RL_SPINS = 512
RL_ENVS = 256
RL_UPDATES = 512

TTT_PROVENANCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "spinglass_tpu", "benchmarks", "ttt_provenance.json")
TTT_SEEDS = (42, 43, 44)


@functools.lru_cache(maxsize=1)
def device_description() -> str:
    """The card's name and power limit as nvidia-smi reports them (asked
    once per process)."""
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


@functools.lru_cache(maxsize=2)
def _sk_problem(n: int):
    """The SK glass at n spins on the card, built once per process and
    shared by the benches (a problem is never written)."""
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


# the kernel symbols behind each launch counter (``engines.launch_counters``)
KERNEL_SYMBOLS = {
    "metropolis_sweep": ("cluster_sweep_kernel", "tile_sweep_kernel"),
    "sparse_sweep": ("sparse_sweep_kernel",),
    "sparse_thresholds": ("sparse_thresholds_kernel",),
    "sparse_accept": ("sparse_accept_kernel",),
    "sw_labels": ("sw_labels_kernel",),
    "sw_bonds": ("sw_bonds_kernel",),
}


def _profile(step, sweeps: int, top: int, graph_launches: int = 0,
             counters=()) -> dict:
    """Where ``step`` (a closure that runs ``sweeps`` sweeps of a driver's
    loop and synchronises nothing itself) spends its time on the GPU.

    Runs it once to warm up, once on the host clock, and twice under
    ``torch.profiler``: a warm-up step (the profiler misses the first events
    it sees) and the recorded step. Returns us/sweep of the timed runs, the
    kernels' device time per sweep (one stream, so they do not overlap), the
    device-busy share (device time over the unprofiled run's wall time: the
    profiler's own host cost would otherwise count as idle) and the ``top``
    kernels. ``graph_launches`` is the number of graph replays in a step.
    ``counters`` (``engines.launch_counters``): ``launch_check`` holds, per
    counter, what it added over the recorded step against the profiler's
    count of that kernel's symbols (``KERNEL_SYMBOLS``) in the same step.
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
            before = {n: getattr(o, a) for n, o, a in counters}
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
            added = {n: getattr(o, a) - before[n] for n, o, a in counters}
            prof.step()
    # kernels only: an operator's entry repeats its kernels' device time,
    # and the step annotation ("ProfilerStep*") spans the whole run
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.is_user_annotation
              and not e.key.startswith("ProfilerStep")]
    device_us = sum(e.self_device_time_total for e in events) / sweeps
    events.sort(key=lambda e: -e.self_device_time_total)
    # PyTorch's advanced indexing (s_t[idx]) runs as index / gather kernels
    gathers = sum(e.count for e in events
                  if "index" in e.key.lower() or "gather" in e.key.lower())
    launch_check = {name: {"counter": n, "profiler": sum(
        e.count for e in events
        if any(sym in e.key for sym in KERNEL_SYMBOLS.get(name, ())))}
        for name, n in added.items()}
    return {
        "sweeps": sweeps,
        "us_per_sweep": wall / sweeps * 1e6,
        "profiled_us_per_sweep": prof_wall / sweeps * 1e6,
        "device_us_per_sweep": device_us,
        "device_busy_share": device_us / (wall / sweeps * 1e6),
        "launches_per_sweep": sum(e.count for e in events) / sweeps,
        "graph_launches_per_sweep": graph_launches / sweeps,
        "gather_launches_per_sweep": gathers / sweeps,
        "launch_check": launch_check,
        "kernels": [{"name": e.key, "calls": e.count,
                     "us_per_sweep": e.self_device_time_total / sweeps}
                    for e in events[:top]],
        "nvidia_smi": device_description(),
    }


def profile_batch(problems, top: int = 8) -> dict:
    """One batch of ``anneal.batch.BatchProcessor()`` at its defaults on
    ``problems`` (one stack of at most 16, on the card): the copy of the
    stack into the captured run's buffers, the start spins, one replay of
    the 200 stacked sweeps and one read of the results, profiled
    (``_profile``; per sweep means per stacked sweep of all P problems)."""
    from spinglass_tpu_torch.anneal import batch

    cfg = batch.BatchProcessor().sa_config
    st = batch.stack_problems(problems)
    run = batch.stacked_run(st, cfg)
    gen = torch.Generator().manual_seed(SEED)
    out = _profile(lambda: run.run(st, gen), cfg.n_sweeps, top,
                   graph_launches=1,
                   counters=[(run.sweep.kernel_name, run.sweep, "launches")])
    out.update(n_problems=st.n_problems, n_padded=st.n_padded,
               n_replicas=cfg.n_replicas)
    return out


def profile_research(problem, top: int = 8) -> dict:
    """Where the research layer's annealers spend their time on
    ``problem`` (on the card), each a repeat call profiled by ``_profile``:
    SQA at one stage of 100 sweeps (K1 at [8 N, 16], two replays of a
    50-sweep chunk), PIMC at 100 sweeps, AQIA at its defaults
    (500 replays of one captured iteration) and LESD at its defaults (300
    replays of one captured iteration). Per "sweep" means per Trotter sweep or per
    iteration (``unit``)."""
    from spinglass_tpu_torch.research import novel, quantum

    runs = {
        "SQA": (lambda: quantum.simulated_quantum_annealing(
            problem, quantum.SQAConfig(n_stages=1)), 100, 2, "sweep"),
        "PIMC": (lambda: quantum.path_integral_monte_carlo(
            problem, quantum.PIMCConfig(n_sweeps=100)), 100, 2, "sweep"),
        "AQIA": (lambda: novel.adaptive_quantum_inspired_annealing(problem),
                 500, 500, "iteration"),
        "LESD": (lambda: novel.learning_enhanced_dynamics(problem), 300,
                 300, "iteration"),
    }
    out = {}
    for name, (step, sweeps, replays, unit) in runs.items():
        out[name] = _profile(step, sweeps, top, graph_launches=replays)
        out[name]["unit"] = unit
    return out


def _sa_steppers(problem, r: int, sweeps: int, **cfg_kw) -> dict:
    """"plain" (the eager ``run_chunk``) and "captured" (its graph) runs of
    one chunk of ``anneal``, each with the chunk's one read of its four
    statistics, on states of their own; and the engine."""
    from spinglass_tpu_torch.anneal import graphs, sa

    cfg = sa.SAConfig(n_sweeps=10 * sweeps, n_replicas=r, **cfg_kw)
    engine = sa.make_sweep_engine(problem, cfg)
    state = None   # the plain run's, made at its first call
    captured = sa.capture_chunk(problem, cfg, engine,
                                sa.init_state(problem, cfg, engine), sweeps)
    read = graphs.HostRead()

    def plain():
        nonlocal state
        if state is None:
            state = sa.init_state(problem, cfg, engine)
        state, stats = sa.run_chunk(problem, cfg, engine, state, sweeps)
        torch.stack([stats[k] for k in sa.STAT_KEYS]).tolist()

    return {"plain": plain, "captured": lambda: read([captured.replay()]),
            "engine": engine}


def _profile_sa(problem, r: int, sweeps: int, top: int, **cfg_kw) -> dict:
    steps = _sa_steppers(problem, r, sweeps, **cfg_kw)
    out = _profile(steps["captured"], sweeps, top, graph_launches=1,
                   counters=launch_counters(steps["engine"]))
    out.update(n_spins=problem.n_spins, n_replicas=r,
               engine=steps["engine"].name)
    return out


def profile_chunk(n: int = N_SPINS, r: int = N_REPLICAS, sweeps: int = 50,
                  block_size: int = 128, top: int = 8) -> dict:
    """One captured chunk of ``sweeps`` sweeps of ``anneal``
    (``sa.capture_chunk``, the default schedule) on the dense SK glass,
    profiled (``_profile``)."""
    out = _profile_sa(_sk_problem(n), r, sweeps, top, block_size=block_size)
    out["block_size"] = block_size
    return out


def profile_sparse_chunk(r: int = SPARSE_REPLICAS, sweeps: int = 50,
                         top: int = 8) -> dict:
    """One captured chunk of ``anneal`` on the sparse bench instance (K2 at
    R=1024), profiled (``_profile``)."""
    _need_cuda()
    return _profile_sa(sparse_bench_problem(), r, sweeps, top)


def _pt_steppers(ell, cfg, engine, super_steps: int, read_each: bool) -> dict:
    """"plain" (the eager super-step loop) and "captured" (its graph)
    runs of ``super_steps`` PT super-steps on states of their own; with
    ``read_each`` each super-step is followed by the 4-byte read of the best
    energy (the TTT loop), else one read ends the run (``pt.run``). Also
    the engine and the super-step's launch counters (C1's too, with cluster
    moves)."""
    from spinglass_tpu_torch.anneal import graphs
    from spinglass_tpu_torch.anneal import pt as pt_mod

    super_step, _, engine = pt_mod.make_pt_step(ell, cfg, engine=engine)

    def best_of(st):
        st, stats = super_step(st)
        return st, stats["best_energy"]

    best_of.counters = super_step.counters
    state = None   # the plain run's, made at its first call
    captured = pt_mod.capture_super_step(best_of, engine, pt_mod.init_state(
        ell, cfg, torch.Generator().manual_seed(SEED), engine))
    read = graphs.HostRead()

    def plain():
        nonlocal state
        if state is None:
            state = pt_mod.init_state(
                ell, cfg, torch.Generator().manual_seed(SEED), engine)
        for _ in range(super_steps):
            state, stats = super_step(state)
            if read_each:
                float(stats["best_energy"])
        float(stats["best_energy"])

    def replayed():
        for _ in range(super_steps):
            best = captured.replay()
            if read_each:
                read([best])
        read([best])

    return {"plain": plain, "captured": replayed, "engine": engine,
            "counters": super_step.counters}


def profile_ttt(super_steps: int = 20, top: int = 8) -> dict:
    """``super_steps`` captured PT super-steps of the time-to-target loop
    (the TTT instance and configuration, with the per-super-step 4-byte
    read), profiled (``_profile``); per-sweep figures count
    exchange_interval sweeps per super-step."""
    _need_cuda()
    ell, _ = ttt_instance()
    cfg = ttt_config()
    steps = _pt_steppers(ell, cfg, None, super_steps, read_each=True)
    out = _profile(steps["captured"], super_steps * cfg.exchange_interval,
                   top, graph_launches=super_steps,
                   counters=launch_counters(steps["engine"]))
    out.update(n_spins=ell.n_spins, n_replicas=cfg.n_replicas,
               engine=steps["engine"].name, super_steps=super_steps)
    return out


PT_WIDE_PATHS = ("threshold", "fused", "single")


def pt_wide_config(**kw):
    """PT at R=4096: 32 chains of 128 replicas, the TTT ladder."""
    from spinglass_tpu_torch.anneal import pt as pt_mod

    return pt_mod.PTConfig(n_replicas=128, n_chains=32, exchange_interval=10,
                           min_temp=0.05, max_temp=3.0, **kw)


def pt_wide_engine(ell, path: str):
    """The transposed sparse engine forced down one of PT_WIDE_PATHS:
    "threshold" (K3 and the plain per-colour sweep), "fused" (K4 in gather
    mode) or "single" (K2; the engine's single-sweep budget is lifted on
    this instance so that it takes any R % 128 == 0 that fits K2's tile)."""
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    kind = {"threshold": "none", "fused": "fused", "single": "single"}[path]
    engine = SortedSparseTEngine(ell, accept_kernel=kind)
    if path == "single":
        engine.SINGLE_VMEM_SPIN_BYTES = 1 << 62
    return engine


def _pt_stepper(ell, cfg, engine, super_steps: int):
    """``super_steps`` captured super-steps through ``engine``, one read at
    the end."""
    return _pt_steppers(ell, cfg, engine, super_steps, False)["captured"]


def profile_pt_wide(path: str = "threshold", super_steps: int = 3,
                    top: int = 6) -> dict:
    """PT at R=4096 on the sparse bench instance through
    ``pt_wide_engine(path)``: ``super_steps`` captured super-steps of
    ``pt``'s step, profiled (``_profile``; ``gather_launches_per_sweep``
    counts PyTorch's index kernels)."""
    _need_cuda()
    ell = sparse_bench_problem()
    cfg = pt_wide_config()
    engine = pt_wide_engine(ell, path)
    out = _profile(_pt_stepper(ell, cfg, engine, super_steps),
                   super_steps * cfg.exchange_interval, top,
                   graph_launches=super_steps,
                   counters=launch_counters(engine))
    out.update(n_spins=ell.n_spins, n_replicas=cfg.n_replicas * cfg.n_chains,
               path=path, launches=engine.launches)
    return out


def _in_turns(steppers: dict, sweeps: int, warm_up: bool = True) -> dict:
    """Host-clock ms/sweep of each stepper (``sweeps`` per call), run a b c
    c b a after one warm-up call each (``warm_up``); label -> [first turn,
    second turn]."""
    labels = list(steppers)
    out = {label: [] for label in labels}
    for step in steppers.values() if warm_up else ():
        step()
    for label in labels + labels[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steppers[label]()
        torch.cuda.synchronize()
        out[label].append((time.perf_counter() - t0) / sweeps * 1e3)
    return out


def bench_pt_wide(super_steps: int = 5) -> dict:
    """PT at R=4096 on the sparse bench instance, ms/sweep of wall time
    through each of PT_WIDE_PATHS, in turns in one process."""
    _need_cuda()
    ell = sparse_bench_problem()
    cfg = pt_wide_config()
    steppers = {path: _pt_stepper(ell, cfg, pt_wide_engine(ell, path),
                                  super_steps) for path in PT_WIDE_PATHS}
    return {"metric": "pt_wide_ms_per_sweep", "unit": "ms/sweep",
            "value": _in_turns(steppers, super_steps * cfg.exchange_interval),
            "extras": {"n_spins": ell.n_spins, "n_replicas": 4096,
                       "super_steps": super_steps,
                       "nvidia_smi": device_description()}}


def bench_pt16(super_steps: int = 30) -> dict:
    """``bench_pt10k``'s shape (16 replicas, one chain) through the plain
    [R, N] engine, which ``make_engine`` picked there before K4 gathered its
    own fields, and through ``make_engine``'s engine (the transposed one:
    K4 at any R that K2 does not take), ms/sweep of wall time in turns."""
    from spinglass_tpu_torch.anneal import pt as pt_mod
    from spinglass_tpu_torch.anneal.engines import make_engine
    from spinglass_tpu_torch.kernels.sparse import SortedSparseEngine

    _need_cuda()
    ell = sparse_bench_problem()
    cfg = pt_mod.PTConfig(n_replicas=16, seed=SEED)
    engines = {"plain [R, N]": SortedSparseEngine(ell),
               "make_engine's": make_engine(ell, r_hint=16)}
    steppers = {label: _pt_stepper(ell, cfg, engine, super_steps)
                for label, engine in engines.items()}
    return {"metric": "pt16_ms_per_sweep", "unit": "ms/sweep",
            "value": _in_turns(steppers, super_steps * cfg.exchange_interval),
            "extras": {"n_spins": ell.n_spins, "n_replicas": 16,
                       "engines": {k: e.name for k, e in engines.items()},
                       "launches": {k: dict(getattr(e, "launches", {}))
                                    for k, e in engines.items()},
                       "nvidia_smi": device_description()}}


def rl_bench_setup(n: int = RL_SPINS, n_envs: int = RL_ENVS,
                   n_updates: int = RL_UPDATES):
    """The RL bench's problem and configurations: the SK glass at ``n``
    spins (Gaussian, scale 1/sqrt(n)), ``n_envs`` envs of 10 sweeps per
    step, episodes of 50 steps from a log-uniform start temperature in
    [0.1, 20], PPO with rollouts of 8 and two hidden layers of 128."""
    from spinglass_tpu_torch.rl.env import EnvConfig
    from spinglass_tpu_torch.rl.ppo import PPOConfig

    env_cfg = EnvConfig(n_envs=n_envs, sweeps_per_step=10, max_steps=50,
                        init_temp_range=(0.1, 20.0))
    ppo_cfg = PPOConfig(n_updates=n_updates, rollout_len=8,
                        hidden_sizes=(128, 128), seed=SEED)
    return _sk_problem(n), env_cfg, ppo_cfg


def window_rates(update_times, steps_per_update: int, n_warm: int = 2):
    """The JAX bench's windows protocol on per-update wall times: the first
    ``n_warm`` updates are left out, the rest split into three windows (one
    below six updates) with the division's remainder folded into the last,
    each window's rate over its own length. Returns (median, rates)."""
    steady = list(update_times[n_warm:])
    if not steady:
        raise ValueError(f"{len(update_times)} updates leave none after the "
                         f"{n_warm} of the warm-up")
    n_win = 3 if len(steady) >= 6 else 1
    w = len(steady) // n_win
    bounds = [i * w for i in range(n_win)] + [len(steady)]
    rates = [steps_per_update * (bounds[i + 1] - bounds[i])
             / sum(steady[bounds[i]:bounds[i + 1]]) for i in range(n_win)]
    return sorted(rates)[n_win // 2], rates


def bench_rl(n_updates: int = RL_UPDATES, n: int = RL_SPINS,
             n_envs: int = RL_ENVS) -> dict:
    """PPO training throughput (env steps/s, steady state) through
    ``rl.ppo.train`` on the card: every env step is 10 K1 sweeps at
    [n, n_envs] with a per-env beta, then the reward, the observation, the
    auto-reset and the policy in PyTorch. ``train`` holds ``rl.ppo.train``'s
    whole output (tensors: drop it before printing the result as JSON)."""
    from spinglass_tpu_torch.rl import ppo as ppo_mod

    problem, env_cfg, ppo_cfg = rl_bench_setup(n, n_envs, n_updates)
    out = ppo_mod.train(problem, env_cfg, ppo_cfg)
    n_warm = out["n_warmup"]
    sps, rates = window_rates(out["update_times"],
                              ppo_cfg.rollout_len * env_cfg.n_envs, n_warm)
    return {
        "metric": "ppo_env_steps_per_sec",
        "value": sps,
        "unit": "env_steps/s",
        "extras": {"n_spins": n, "n_envs": n_envs, "n_updates": n_updates,
                   "n_warmup_excluded": n_warm, "window_rates": rates,
                   "mean_steady_rate": out["env_steps_per_second"],
                   "sweeps_per_env_step": env_cfg.sweeps_per_step,
                   "rollout_len": ppo_cfg.rollout_len,
                   "final_mean_best_energy": out["final_mean_best_energy"],
                   "engine": out["engine"],
                   "kernel_launches": out["kernel_launches"],
                   "device": torch.cuda.get_device_name(0),
                   "nvidia_smi": device_description()},
        "train": out,
    }


def profile_rl(n: int = RL_SPINS, n_envs: int = RL_ENVS, top: int = 8) -> dict:
    """One captured PPO update at the RL bench's shape (``ppo.train``'s
    step, with its metrics read), profiled (``_profile``, with an env step
    of the whole batch where the other profiles have a sweep), and the eager
    update's wall time split into its rollout (the env steps, the
    auto-resets and the policy's forward passes) and its learning phase
    (GAE and the minibatch Adam steps), each synchronised."""
    steps = _rl_steppers(n, n_envs)
    init_fn, update_fn = steps["init_fn"], steps["update_fn"]
    rollout_len = steps["env_steps"] // n_envs
    prof = _profile(steps["captured"], rollout_len, top, graph_launches=1,
                    counters=launch_counters(update_fn.engine))
    state = init_fn()
    split = {"rollout": [], "learn": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, traj, last_value = update_fn.rollout(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = update_fn.learn(state, traj, last_value)
        torch.cuda.synchronize()
        split["rollout"].append(t1 - t0)
        split["learn"].append(time.perf_counter() - t1)
    sweep_us = sum(k["us_per_sweep"] for k in prof["kernels"]
                   if "sweep_kernel" in k["name"])
    out = {key.replace("sweep", "env_step"): value
           for key, value in prof.items() if key != "kernels"}
    out.update(
        kernels=[{"name": k["name"], "calls": k["calls"],
                  "us_per_env_step": k["us_per_sweep"]}
                 for k in prof["kernels"]],
        n_spins=n, n_envs=n_envs, env_steps=rollout_len,
        sweep_kernel_share=sweep_us / prof["device_us_per_sweep"],
        rollout_seconds=min(split["rollout"]),
        learn_seconds=min(split["learn"]),
        engine=update_fn.engine.name, launches=dict(update_fn.engine.launches))
    return out


def _dqn_setup(n: int, n_envs: int, k: int):
    """The RL bench's problem and env with the DQN defaults (buffer 4096,
    batch 128, hidden (128, 128), uniform replay); ``make_dqn``'s (init_fn, act_and_learn)
    and the config."""
    from spinglass_tpu_torch.rl import dqn as dqn_mod

    problem, env_cfg, _ = rl_bench_setup(n, n_envs, 1)
    cfg = dqn_mod.DQNConfig(steps_per_dispatch=k, seed=SEED)
    init_fn, step_fn, _ = dqn_mod.make_dqn(problem, env_cfg, cfg)
    return problem, env_cfg, cfg, init_fn, step_fn


def bench_dqn(n_steps: int = 512, k: int = 1, n: int = RL_SPINS,
              n_envs: int = RL_ENVS) -> dict:
    """DQN training throughput (env steps/s) on the card at the RL bench's
    shape: ``act_and_learn`` (10 K1 sweeps at [n, n_envs] per env step,
    then the push, the auto-reset and one TD step on a batch of 128)
    captured (``dqn.CapturedSteps``) and replayed ``k`` steps per read of
    the metrics, as ``RLTrainingPipeline`` runs it with
    ``steps_per_dispatch=k``. ``value`` is the steady rate (the blocks after
    the first, which holds the capture); ``whole_call_rate`` counts every
    step over the whole time, the capture included. Host clock: each block
    ends in its read of the metrics."""
    from spinglass_tpu_torch.rl import dqn as dqn_mod

    _need_cuda()
    if n_steps % k or n_steps < 2 * k:
        raise ValueError(f"n_steps {n_steps} must be a multiple of k {k}, "
                         f"at least two blocks")
    problem, env_cfg, cfg, init_fn, step_fn = _dqn_setup(n, n_envs, k)
    state = init_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cap = dqn_mod.CapturedSteps(step_fn, state, k)
    capture_s = time.perf_counter() - t0
    blocks, rows = [], []
    for _ in range(n_steps // k):
        t = time.perf_counter()
        for _ in range(k):
            cap.replay()
        rows += cap.read(k)
        blocks.append(time.perf_counter() - t)
    total = time.perf_counter() - t0
    steady = sum(blocks[1:])
    return {
        "metric": "dqn_env_steps_per_sec",
        "value": (n_steps - k) * n_envs / steady,
        "unit": "env_steps/s",
        "extras": {"n_spins": n, "n_envs": n_envs, "n_steps": n_steps,
                   "steps_per_read": k,
                   "whole_call_rate": n_steps * n_envs / total,
                   "capture_seconds": capture_s,
                   "first_block_seconds": blocks[0],
                   "buffer_size": cfg.buffer_size,
                   "batch_size": cfg.batch_size,
                   "sweeps_per_env_step": env_cfg.sweeps_per_step,
                   "final": rows[-1],
                   "finite": all(np.isfinite(v) for r in rows
                                 for v in r.values()),
                   "final_mean_best_energy_per_spin":
                       rows[-1]["mean_best_energy"] / problem.n_spins,
                   "engine": step_fn.engine.name,
                   "kernel_launches": dict(step_fn.engine.launches),
                   "device": torch.cuda.get_device_name(0),
                   "nvidia_smi": device_description()},
    }


def profile_dqn(n: int = RL_SPINS, n_envs: int = RL_ENVS,
                top: int = 8) -> dict:
    """One captured DQN step at the RL bench's shape (``act_and_learn``
    replayed, its metrics read), profiled (``_profile``, with an env step of
    the whole batch where the other profiles have a sweep), and the eager
    step's wall time split into ``act`` (the hybrid decision, ``env.step``,
    the push, the auto-reset) and ``learn`` (the sample, the TD loss and its
    backward pass, Adam, the soft target update), each synchronised, after
    16 steps have filled the buffer past a batch."""
    from spinglass_tpu_torch.rl import dqn as dqn_mod

    _need_cuda()
    _, _, _, init_fn, step_fn = _dqn_setup(n, n_envs, 1)
    cap = dqn_mod.CapturedSteps(step_fn, init_fn(), 1)
    for _ in range(16):
        cap.replay()

    def replayed():
        cap.replay()
        cap.read(1)

    prof = _profile(replayed, 1, top, graph_launches=1,
                    counters=launch_counters(step_fn.engine))
    state = init_fn()
    split = {"act": [], "learn": []}
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, reward = step_fn.act(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = step_fn.learn(state, reward)
        torch.cuda.synchronize()
        if i >= 16:
            split["act"].append(t1 - t0)
            split["learn"].append(time.perf_counter() - t1)
    sweep_us = sum(k["us_per_sweep"] for k in prof["kernels"]
                   if "sweep_kernel" in k["name"])
    out = {key.replace("sweep", "env_step"): value
           for key, value in prof.items() if key != "kernels"}
    out.update(
        kernels=[{"name": k["name"], "calls": k["calls"],
                  "us_per_env_step": k["us_per_sweep"]}
                 for k in prof["kernels"]],
        n_spins=n, n_envs=n_envs,
        sweep_kernel_share=sweep_us / prof["device_us_per_sweep"],
        eager_act_seconds=min(split["act"]),
        eager_learn_seconds=min(split["learn"]),
        engine=step_fn.engine.name, launches=dict(step_fn.engine.launches))
    return out


def bench_evaluate(n_seeds: int = 5, n: int = RL_SPINS,
                   n_envs: int = RL_ENVS) -> dict:
    """``evaluate_controllers`` (each policy's episode step captured once,
    every seed's start loaded into it) against the eager loop of the same
    episodes (``eager_rollout`` per seed) at the RL bench's shape, with the
    geometric and the random controllers: each call's wall time on the host
    clock (synchronised), in turns eager, captured, captured, eager; the
    per-seed results of every call must be equal. The same for one
    ``rollout_best_energy`` call, which captures its step anew (a warm-up
    env step on a throwaway copy, then the capture) on every call, against
    ``eager_rollout`` of its episode (the geometric policy, seed 0)."""
    from spinglass_tpu_torch.rl import env as env_mod
    from spinglass_tpu_torch.rl import evaluate as ev

    _need_cuda()
    problem, env_cfg, _ = rl_bench_setup(n, n_envs, 1)
    engine = env_mod.default_engine(problem, env_cfg)
    policies = {"geometric": ev.make_geometric_policy(env_cfg),
                "random": ev.make_random_policy()}

    def captured():
        return ev.evaluate_controllers(problem, env_cfg, policies,
                                       n_seeds=n_seeds, engine=engine)[1]

    def eager():
        return {name: np.asarray([float(torch.mean(eager_rollout(
            problem, env_cfg, fn, ev.seed_generator(name, 0, s), engine)))
            for s in range(n_seeds)]) for name, fn in policies.items()}

    def one(rollout):
        gen = ev.seed_generator("geometric", 0, 0)
        return rollout(problem, env_cfg, policies["geometric"], gen,
                       engine).cpu()

    def in_turns(calls):
        times, results = {"eager": [], "captured": []}, []
        for way in ("eager", "captured", "captured", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(calls[way]())
            torch.cuda.synchronize()
            times[way].append(time.perf_counter() - t0)
        return times, results

    times, results = in_turns({"eager": eager, "captured": captured})
    r_times, r_results = in_turns({
        "eager": lambda: one(eager_rollout),
        "captured": lambda: one(ev.rollout_best_energy)})
    equal = all(np.array_equal(r[name], results[0][name]) for r in results
                for name in policies)
    rollout_equal = all(torch.equal(r, r_results[0]) for r in r_results)
    first = results[0]
    return {"eager_seconds": times["eager"],
            "captured_seconds": times["captured"], "equal": equal,
            "rollout_eager_seconds": r_times["eager"],
            "rollout_captured_seconds": r_times["captured"],
            "rollout_equal": rollout_equal,
            "n_seeds": n_seeds, "episode_steps": env_cfg.max_steps,
            "mean_best_energy": {k: float(v.mean()) for k, v in first.items()},
            "nvidia_smi": device_description()}


def _rl_steppers(n: int = RL_SPINS, n_envs: int = RL_ENVS) -> dict:
    """One PPO update at the RL bench's shape with its metrics read: "plain"
    (the eager update_fn) and "captured" (``ppo.CapturedUpdates``), each on
    a training state of its own; and ``make_ppo``'s init_fn and
    update_fn."""
    from spinglass_tpu_torch.rl import ppo as ppo_mod

    problem, env_cfg, ppo_cfg = rl_bench_setup(n, n_envs, 1)
    init_fn, update_fn, _ = ppo_mod.make_ppo(problem, env_cfg, ppo_cfg)
    state = init_fn()
    captured = ppo_mod.CapturedUpdates(update_fn, init_fn())

    def plain():
        nonlocal state
        state, metrics = update_fn(state)
        torch.stack([metrics[k] for k in ppo_mod.METRIC_KEYS]).tolist()

    def replayed():
        captured.replay()
        captured.read(1)

    return {"plain": plain, "captured": replayed, "init_fn": init_fn,
            "update_fn": update_fn,
            "env_steps": ppo_cfg.rollout_len * env_cfg.n_envs}


def eager_rollout(problem, env_cfg, policy, generator, engine,
                  n_steps=None):
    """``evaluate.rollout_best_energy``'s episode as the eager loop of the
    step it captures (``evaluate.episode_step``): the best energy per env
    [B]."""
    from spinglass_tpu_torch.rl import env as env_mod
    from spinglass_tpu_torch.rl.evaluate import episode_step

    step = episode_step(problem, env_cfg, policy, engine)
    with torch.no_grad():
        env_state, obs = env_mod.reset(problem, env_cfg, generator, engine)
        st = {"env_state": env_state, "obs": obs, "generator": generator}
        for _ in range(n_steps or env_cfg.max_steps):
            st, _ = step(st)
    return st["env_state"].best_energy


def eager_anneal(problem, cfg):
    """``anneal``'s run as the eager loop of the step it captures
    (``sa.run_chunk``): the engine, the start state, and one read of the
    four statistics per chunk. Returns (state, [n_chunks, 4] history,
    engine)."""
    from spinglass_tpu_torch.anneal import sa

    engine = sa.make_sweep_engine(problem, cfg)
    state = sa.init_state(problem, cfg, engine)
    hist, done = [], 0
    while done < cfg.n_sweeps:
        n = min(cfg.record_interval, cfg.n_sweeps - done)
        state, st = sa.run_chunk(problem, cfg, engine, state, n)
        hist.append(torch.stack([st[k] for k in sa.STAT_KEYS]).tolist())
        done += n
    return state, np.asarray(hist), engine


def eager_pt(problem, cfg):
    """``pt.run``'s run as the eager loop of the super-step it captures,
    read once at the end: (state, stacked stats, engine)."""
    from spinglass_tpu_torch.anneal import pt as pt_mod

    super_step, _, engine = pt_mod.make_pt_step(problem, cfg)
    state = pt_mod.init_state(problem, cfg,
                              torch.Generator().manual_seed(cfg.seed), engine)
    hist = []
    for _ in range(max(1, cfg.n_sweeps // cfg.exchange_interval)):
        state, st = super_step(state)
        hist.append({k: v.clone() for k, v in st.items()})
    stacked = {k: torch.stack([h[k] for h in hist]) for k in hist[0]}
    stacked["best_energy"].cpu()
    return state, stacked, engine


def _call_turns(eager, captured) -> dict:
    """Seconds of wall time per call, in turns: the eager loop, a first
    call of the captured driver (the caches cleared: it captures) and a
    repeat call (a cache hit)."""
    from spinglass_tpu_torch.anneal import graphs

    def first():
        graphs.clear_caches()
        captured()

    # no warm-up calls: the kernels are loaded, and each call builds its
    # own engine (the eager loop, the first call) or hits the cache
    turns = _in_turns({"eager": eager, "first call": first,
                       "repeat call": captured}, 1, warm_up=False)
    return {k: [v / 1e3 for v in t] for k, t in turns.items()}


def captured_vs_plain(ttt_super_steps: int = 20, chunk: int = 50,
                      anneal_sweeps: int = 500,
                      pt10k_sweeps: int = 1000) -> dict:
    """Each captured driver against the eager loop of its step, in turns
    (plain, captured, captured, plain after a warm-up call each) in one
    process, host clock around synchronised runs: us/sweep of one chunk of
    the dense SA (SK 4096 x 1024, K1) and the sparse SA (10k x 1024, K2),
    with the chunk's read; us/sweep of ``ttt_super_steps`` TTT
    super-steps, each with its 4-byte read; env steps/s of one PPO update at
    the RL bench's shape, with its read. Then whole calls, set-up included,
    three ways in turns (``_call_turns``): ``anneal`` of ``anneal_sweeps``
    sweeps on both SA instances, ``pt.run`` at ``bench_pt10k``'s
    configuration (its repeat call is ``bench_pt10k``'s metric).
    label -> {way: [first turn, second turn]}."""
    from spinglass_tpu_torch.anneal import pt as pt_mod
    from spinglass_tpu_torch.anneal import sa

    _need_cuda()
    out = {}
    problems = {"dense": _sk_problem(N_SPINS), "sparse": sparse_bench_problem()}
    for kind, problem in problems.items():
        steps = _sa_steppers(problem, N_REPLICAS, chunk)
        turns = _in_turns({k: steps[k] for k in ("plain", "captured")}, chunk)
        out[f"{kind} SA chunk us/sweep"] = {k: [1e3 * v for v in t]
                                            for k, t in turns.items()}
        del steps
    ell, _ = ttt_instance()
    cfg = ttt_config()
    steps = _pt_steppers(ell, cfg, None, ttt_super_steps, read_each=True)
    turns = _in_turns({k: steps[k] for k in ("plain", "captured")},
                      ttt_super_steps * cfg.exchange_interval)
    out["TTT us/sweep"] = {k: [1e3 * v for v in t] for k, t in turns.items()}
    steps = _rl_steppers()
    turns = _in_turns({k: steps[k] for k in ("plain", "captured")}, 1)
    out["PPO update env steps/s"] = {
        k: [steps["env_steps"] / (v / 1e3) for v in t]
        for k, t in turns.items()}
    del steps
    for kind, problem in problems.items():
        cfg = sa.SAConfig(n_sweeps=anneal_sweeps, n_replicas=N_REPLICAS)
        out[f"{kind} anneal call s ({anneal_sweeps} sweeps)"] = _call_turns(
            lambda: eager_anneal(problem, cfg),
            lambda: sa.anneal(problem, cfg))
    cfg = pt_mod.PTConfig(n_replicas=16, n_sweeps=pt10k_sweeps, seed=SEED)
    out[f"pt.run call s (bench_pt10k, {pt10k_sweeps} sweeps)"] = _call_turns(
        lambda: eager_pt(problems["sparse"], cfg),
        lambda: pt_mod.run(problems["sparse"], cfg))
    return {"metric": "captured_vs_plain", "value": out,
            "extras": {"nvidia_smi": device_description()}}


# the five bench paths by the JAX package's names (``sgt-torch bench``)
PATHS = {
    "dense": bench_dense,
    "sparse": bench_sparse,
    "pt10k": bench_pt10k,
    "ttt": bench_ttt,
    "rl": bench_rl,
}
