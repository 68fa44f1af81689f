"""Simulated-annealing driver: chunks of sweeps over a batch of replicas.

The counterpart of ``spinglass_tpu.anneal.sa``. The JAX driver runs each
chunk of ``record_interval`` sweeps as one jitted scan; here a chunk is a
Python loop of sweeps whose tensors never leave the device: beta and the
schedule state are device tensors, each sweep's randomness comes from the
host ``torch.Generator`` in the state, and the chunk's statistics are read
back once, at its end. The exact energy is recomputed at the end of every
chunk, which removes the float32 drift of the incremental energies.

Annealing state lives in the engine's layout (see ``engines``). The kernel
engines (K1, and K2 for sparse problems) update ``SAState.spins`` in place;
``best_spins`` is always a separate tensor. ``anneal`` takes a dense
``IsingProblem`` or a sparse ``kernels.sparse.EllProblem``: anything with
``n_padded``, ``active_mask``, ``n_spins`` and ``device``.

Early stopping: relative std of the last 20 recorded best energies below
``convergence_tolerance``, checked between chunks.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field as dfield
from typing import Optional, Tuple

import numpy as np
import torch

from spinglass_tpu_torch.anneal import schedules
from spinglass_tpu_torch.anneal.engines import (SweepEngine, best_row,
                                                kernel_launches, make_engine)
from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig, ScheduleState
from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
from spinglass_tpu_torch.kernels.metropolis_cuda import J_DTYPES


@dataclass(frozen=True)
class SAConfig:
    """Static annealer configuration (the JAX ``SAConfig`` with
    ``use_pallas`` renamed ``use_kernel``)."""

    n_sweeps: int = 1000
    n_replicas: int = 32
    schedule: ScheduleConfig = dfield(default_factory=ScheduleConfig)
    update_rule: str = "metropolis"          # metropolis | glauber
    sweep_method: str = "auto"               # auto | colored | blocked | sparse | sparse_t
    block_size: int = 128
    max_colors_for_colored: int = 8          # auto: colored if coloring is this small
    record_interval: int = 50
    convergence_tolerance: float = 1e-6
    enable_early_stop: bool = True
    use_kernel: str = "auto"                 # auto | never | always
    j_dtype: str = "float32"                 # float32 | bfloat16: the J the fused
                                             # kernel sweeps on (rounded once)
    seed: int = 42

    def __post_init__(self):
        if self.j_dtype not in J_DTYPES:
            raise ValueError(f"j_dtype must be one of {J_DTYPES}, got "
                             f"{self.j_dtype!r}")
        # keep the cooling horizon in sync with the sweep budget
        if self.schedule.total_sweeps != self.n_sweeps and self.n_sweeps > 0:
            object.__setattr__(
                self, "schedule",
                dataclasses.replace(self.schedule, total_sweeps=self.n_sweeps))


@dataclass
class SAState:
    """Carried annealing state. ``spins``/``best_spins`` are in the engine's
    layout; the tensors live on the problem's device, ``generator`` on the
    host."""

    spins: torch.Tensor
    energy: torch.Tensor        # [R] f32 (incrementally tracked)
    best_energy: torch.Tensor   # [R]
    best_spins: torch.Tensor
    sched: ScheduleState
    generator: torch.Generator
    sweep: int
    acc_rate: torch.Tensor      # [R] last sweep's acceptance rate


def make_sweep_engine(problem: IsingProblem, config: SAConfig) -> SweepEngine:
    return make_engine(
        problem,
        sweep_method=config.sweep_method,
        update_rule=config.update_rule,
        block_size=config.block_size,
        use_kernel=config.use_kernel,
        max_colors=config.max_colors_for_colored,
        j_dtype=config.j_dtype,
        r_hint=config.n_replicas,
    )


def init_state(problem: IsingProblem, config: SAConfig, engine: SweepEngine,
               generator: Optional[torch.Generator] = None,
               init_spins: Optional[torch.Tensor] = None) -> SAState:
    """init_spins, when given, is [R, Np] whatever the engine's layout; it is
    copied, never modified."""
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    if init_spins is None:
        spins_rn = random_spins(generator, (config.n_replicas, problem.n_padded),
                                problem.active_mask)
    else:
        spins_rn = init_spins.to(device=problem.device, dtype=torch.float32)
    spins = engine.to_layout(spins_rn)
    e = engine.energy(spins)
    return SAState(
        spins=spins,
        energy=e,
        best_energy=e.clone(),
        best_spins=spins.clone(),
        sched=schedules.init_state(config.schedule, device=problem.device),
        generator=generator,
        sweep=0,
        acc_rate=torch.zeros(spins_rn.shape[0], dtype=torch.float32,
                             device=problem.device),
    )


def _one_sweep(problem: IsingProblem, config: SAConfig, engine: SweepEngine,
               state: SAState) -> SAState:
    beta = 1.0 / torch.clamp(state.sched.temp, min=1e-10)
    spins, de, cnt = engine.sweep(state.spins, beta, state.generator)
    energy = state.energy + de
    improved = energy < state.best_energy
    imp_b = improved[None, :] if engine.layout == "nr" else improved[:, None]
    best_energy = torch.where(improved, energy, state.best_energy)
    best_spins = torch.where(imp_b, spins, state.best_spins)
    acc_rate = cnt.to(torch.float32) / problem.n_spins
    sched = schedules.update(config.schedule, state.sched, state.sweep,
                             torch.mean(acc_rate))
    return SAState(spins=spins, energy=energy, best_energy=best_energy,
                   best_spins=best_spins, sched=sched,
                   generator=state.generator, sweep=state.sweep + 1,
                   acc_rate=acc_rate)


def run_chunk(problem: IsingProblem, config: SAConfig, engine: SweepEngine,
              state: SAState, n_sweeps: int) -> Tuple[SAState, dict]:
    """n_sweeps sweeps without a host sync; returns the state and summary
    stats as device scalars. Ends with an exact-energy resync."""
    for _ in range(n_sweeps):
        state = _one_sweep(problem, config, engine, state)
    state = dataclasses.replace(state, energy=engine.energy(state.spins))
    stats = {
        "best_energy": torch.min(state.best_energy),
        "mean_energy": torch.mean(state.energy),
        "temperature": state.sched.temp,
        "acceptance": torch.mean(state.acc_rate),
    }
    return state, stats


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def anneal(problem: IsingProblem, config: Optional[SAConfig] = None,
           generator: Optional[torch.Generator] = None,
           init_spins: Optional[torch.Tensor] = None,
           checkpoint_dir: Optional[str] = None,
           checkpoint_every: int = 10,
           resume: bool = False) -> AnnealResult:
    """Full annealing run with history recording and optional early stop.

    The host reads the device once per chunk of ``record_interval`` sweeps
    (the four history values). The best replica is picked on the device and
    only its row is copied to the host. Checkpoint/resume is not ported yet
    and raises.
    """
    if checkpoint_dir is not None or resume:
        raise NotImplementedError("SA checkpoint/resume is not ported yet")
    del checkpoint_every
    config = config or SAConfig()
    engine = make_sweep_engine(problem, config)
    state = init_state(problem, config, engine, generator, init_spins)
    n_chunks = max(1, -(-config.n_sweeps // config.record_interval))
    e_hist, me_hist, t_hist, a_hist = [], [], [], []
    converged, conv_sweep = False, None
    sweeps_done = 0

    _sync(problem.device)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        n = min(config.record_interval, config.n_sweeps - sweeps_done)
        if n <= 0:
            break
        state, stats = run_chunk(problem, config, engine, state, n)
        sweeps_done += n
        e, me, t, a = torch.stack([stats["best_energy"], stats["mean_energy"],
                                   stats["temperature"],
                                   stats["acceptance"]]).tolist()
        e_hist.append(e)
        me_hist.append(me)
        t_hist.append(t)
        a_hist.append(a)
        if config.enable_early_stop and len(e_hist) >= 20:
            tail = np.asarray(e_hist[-20:])
            denom = max(abs(float(np.mean(tail))), 1e-10)
            if float(np.std(tail)) / denom < config.convergence_tolerance:
                converged, conv_sweep = True, sweeps_done
                break
    _sync(problem.device)
    total = time.perf_counter() - t0

    best_r = torch.argmin(state.best_energy)
    best_spins = best_row(engine, state.best_spins, best_r).cpu().numpy()[
        : problem.n_spins]
    flips = sweeps_done * config.n_replicas * problem.n_spins
    return AnnealResult(
        best_spins=best_spins,
        best_energy=float(state.best_energy[best_r]),
        replica_best_energy=state.best_energy.cpu().numpy(),
        energy_history=np.asarray(e_hist),
        mean_energy_history=np.asarray(me_hist),
        temperature_history=np.asarray(t_hist),
        acceptance_history=np.asarray(a_hist),
        n_sweeps=sweeps_done,
        n_replicas=config.n_replicas,
        total_time=total,
        sweeps_per_second=sweeps_done / total if total > 0 else 0.0,
        spin_flips_per_second=flips / total if total > 0 else 0.0,
        algorithm=f"sa/{engine.name}/{config.update_rule}",
        device=problem.device.type,
        seed=config.seed,
        converged=converged,
        convergence_sweep=conv_sweep,
        metadata={"schedule": config.schedule.schedule_type.value,
                  "engine": engine.name,
                  "kernel_launches": kernel_launches(engine)},
    )


def anneal_scan(problem: IsingProblem, config: Optional[SAConfig] = None,
                generator: Optional[torch.Generator] = None):
    """The JAX package's single-dispatch anneal (benchmark / RL inner loop)
    is not ported yet; ``anneal`` is the port's entry point."""
    raise NotImplementedError("anneal_scan is not ported yet; use anneal")
