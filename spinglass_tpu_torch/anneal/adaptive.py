"""Adaptive simulated annealing: restarts, reheating, population resampling.

The counterpart of ``spinglass_tpu.anneal.adaptive``: stagnation-triggered
reheats and restarts of the worst replicas from elite replicas or fresh
spins, on the batched replica axis. The SA chunk of ``record_interval``
sweeps is the captured step of ``sa.capture_chunk`` (one replay and one
read of its [4] statistics per chunk, as the JAX driver reads its chunk's);
``_intervene`` runs between replays and writes its new spins, energies and
temperature into the captured step's static state (``graphs.assign``), so
the next replay anneals them. The engine is ``sa.make_sweep_engine``'s: K1
on a dense problem on the card, K2 or K4 on an ``EllProblem``, as
``sa.anneal`` picks.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field as dfield
from typing import Optional

import numpy as np
import torch

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.anneal.engines import best_row
from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.anneal.sa import (SAConfig, SAState, capture_chunk,
                                           init_state, make_sweep_engine,
                                           step_kernels)
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu_torch.core import rng
from spinglass_tpu_torch.core.problem import random_spins
from spinglass_tpu_torch.kernels import build


@dataclass(frozen=True)
class AdaptiveSAConfig:
    """The JAX ``AdaptiveSAConfig``, with the same defaults."""

    base: SAConfig = dfield(default_factory=lambda: SAConfig(
        n_sweeps=2000, n_replicas=32,
        schedule=ScheduleConfig(ScheduleType.GEOMETRIC, initial_temp=5.0,
                                final_temp=0.01, alpha=0.995)))
    stagnation_chunks: int = 5       # chunks without improvement -> intervene
    reheat_factor: float = 5.0       # temperature boost on stagnation
    restart_fraction: float = 0.25   # worst replicas re-randomized
    elite_fraction: float = 0.25     # resampling copies from elites
    max_interventions: int = 20


@graphs.serialized
def adaptive_anneal(problem, cfg: Optional[AdaptiveSAConfig] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> AnnealResult:
    """Adaptive SA on ``problem`` (an ``IsingProblem`` or an
    ``EllProblem``): ``n_sweeps // record_interval`` chunks, each one
    replay of the captured chunk and one read of its statistics; after
    ``stagnation_chunks`` chunks without a new best energy, ``_intervene``
    (at most ``max_interventions`` times). ``metadata`` holds
    ``interventions``, the engine and this call's ``kernel_launches``."""
    cfg = cfg or AdaptiveSAConfig()
    sa = cfg.base
    engine = make_sweep_engine(problem, sa)
    launches0 = build.launch_snapshot()
    state = init_state(problem, sa, engine, generator)
    generator = state.generator
    step = capture_chunk(problem, sa, engine, state, sa.record_interval)
    read = graphs.HostRead()

    n_chunks = max(1, sa.n_sweeps // sa.record_interval)
    best_global = np.inf
    stagnant = 0
    interventions = 0
    e_hist, t_hist, a_hist = [], [], []
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        be, _, temp, acc = read([step.replay(generator)])[0].tolist()
        e_hist.append(be)
        t_hist.append(temp)
        a_hist.append(acc)
        if be < best_global - 1e-9:
            best_global = be
            stagnant = 0
        else:
            stagnant += 1
        if (stagnant >= cfg.stagnation_chunks
                and interventions < cfg.max_interventions):
            graphs.assign(step.state, _intervene(problem, sa, engine, cfg,
                                                 step.state, generator))
            stagnant = 0
            interventions += 1
    state = step.state
    if problem.device.type == "cuda":
        torch.cuda.synchronize(problem.device)
    total = time.perf_counter() - t0

    b = torch.argmin(state.best_energy)
    best = best_row(engine, state.best_spins, b).cpu().numpy()
    sweeps = n_chunks * sa.record_interval
    return AnnealResult(
        best_spins=best[: problem.n_spins],
        best_energy=float(state.best_energy[b]),
        replica_best_energy=state.best_energy.to("cpu", copy=True).numpy(),
        energy_history=np.asarray(e_hist),
        mean_energy_history=np.asarray(e_hist),
        temperature_history=np.asarray(t_hist),
        acceptance_history=np.asarray(a_hist),
        n_sweeps=sweeps, n_replicas=sa.n_replicas, total_time=total,
        sweeps_per_second=sweeps / total,
        spin_flips_per_second=sweeps * sa.n_replicas * problem.n_spins / total,
        algorithm=f"adaptive_sa/{engine.name}",
        device=problem.device.type, seed=sa.seed,
        metadata={"interventions": interventions, "engine": engine.name,
                  "kernel_launches": build.launches_since(
                      launches0, step_kernels(engine)),
                  "capture_seconds": step.capture_seconds},
    )


def _intervene(problem, sa: SAConfig, engine, cfg: AdaptiveSAConfig,
               state: SAState, generator: Optional[torch.Generator] = None,
               draws: Optional[tuple] = None) -> SAState:
    """Reheat + restart the worst replicas from elites or fresh spins (the
    JAX ``_intervene``). Returns a new state of ``state``'s tree: the caller
    assigns it into the captured step's static state.

    The replicas are ranked by best energy (a stable argsort); the worst
    ``restart_fraction`` are replaced, even positions by a random elite of
    the best ``elite_fraction``, odd ones by fresh spins; the exact energy
    is recomputed and the temperature rises to ``min(temp * reheat_factor,
    initial_temp)``. ``draws`` = (elite indices [n_restart] into the elites,
    fresh spins [n_restart, Np]) replaces the draws from ``generator`` (a
    device generator seeded by one host draw): the tests feed JAX's."""
    r = sa.n_replicas
    order = torch.argsort(state.best_energy, stable=True)  # best first
    n_restart = max(1, int(cfg.restart_fraction * r))
    n_elite = max(1, int(cfg.elite_fraction * r))
    worst = order[-n_restart:]
    elites = order[:n_elite]
    dev = state.best_energy.device

    spins_rn = engine.from_layout(state.spins).to(torch.float32)
    if draws is None:
        gen = rng.device_generator(generator, dev)
        pick = rng.randint(gen, n_elite, (n_restart,), dev)
        fresh = random_spins(gen, (n_restart, problem.n_padded),
                             problem.active_mask)
    else:
        pick, fresh = (torch.as_tensor(np.array(d)).to(dev) for d in draws)
    elite_pick = elites[pick.long()]
    copy_mask = (torch.arange(n_restart, device=dev) % 2 == 0)[:, None]
    new_rows = torch.where(copy_mask, spins_rn[elite_pick],
                           fresh.to(torch.float32))
    spins_rn = spins_rn.clone()
    spins_rn[worst] = new_rows

    spins = engine.to_layout(spins_rn)
    energy = engine.energy(spins)
    sched = dataclasses.replace(state.sched, temp=torch.clamp(
        state.sched.temp * cfg.reheat_factor, max=sa.schedule.initial_temp))
    return dataclasses.replace(state, spins=spins, energy=energy, sched=sched)
