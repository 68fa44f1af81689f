"""Simulated-annealing driver: chunks of sweeps over a batch of replicas.

The counterpart of ``spinglass_tpu.anneal.sa``. The JAX driver runs each
chunk of ``record_interval`` sweeps as one jitted scan; here ``run_chunk``
is the eager step, a Python loop of sweeps whose tensors never leave the
device (beta, the schedule state and the sweep counter are device tensors,
each sweep's randomness comes from the host ``torch.Generator`` in the
state), and ``anneal`` / ``anneal_scan`` replay it captured as a CUDA graph
(``capture_chunk``, ``graphs.CapturedStep``; on the CPU the same step runs
eagerly through the same random tape). ``anneal`` reads the chunk's four
statistics once per chunk, as the JAX driver does; ``anneal_scan`` reads
nothing until the end. The exact energy is recomputed at the end of every
chunk, which removes the float32 drift of the incremental energies.

Annealing state lives in the engine's layout (see ``engines``). The kernel
engines (K1, and K2 for sparse problems) update ``SAState.spins`` in place;
``best_spins`` is always a separate tensor. ``anneal`` takes a dense
``IsingProblem`` or a sparse ``kernels.sparse.EllProblem``: anything with
``n_padded``, ``active_mask``, ``n_spins`` and ``device``.

Early stopping: relative std of the last 20 recorded best energies below
``convergence_tolerance``, checked between chunks.

Checkpoint/resume (``anneal(checkpoint_dir=..., resume=...)``): the state
(the captured chunk's static tensors, its device sweep counter and the
schedule included), the run's generator, the four histories and the sweeps
done are saved every ``checkpoint_every`` chunks (``utils.checkpoint``).
Every draw of a run comes from its one host generator, so a resumed run
equals the uninterrupted run bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field as dfield
from typing import Optional, Tuple

import numpy as np
import torch

from spinglass_tpu_torch.anneal import graphs, schedules
from spinglass_tpu_torch.anneal.engines import (GivenUniforms, SweepEngine,
                                                best_row, kernel_launches,
                                                launch_counters, make_engine)
from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig, ScheduleState
from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
from spinglass_tpu_torch.kernels.metropolis_cuda import J_DTYPES
from spinglass_tpu_torch.utils.checkpoint import CheckpointManager


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
    sweep: object               # sweeps done: an int, or a 0-d int64 device
    # tensor (the captured drivers' counter; schedules read either)
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


STAT_KEYS = ("best_energy", "mean_energy", "temperature", "acceptance")


def run_chunk(problem: IsingProblem, config: SAConfig, engine: SweepEngine,
              state: SAState, n_sweeps: int) -> Tuple[SAState, dict]:
    """n_sweeps sweeps without a host sync; returns the state and summary
    stats (``STAT_KEYS``) as device scalars. Ends with an exact-energy
    resync. The eager step that ``capture_chunk`` captures."""
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


def capture_chunk(problem: IsingProblem, config: SAConfig,
                  engine: SweepEngine, state: SAState, n_sweeps: int,
                  record: int = 0) -> graphs.CapturedStep:
    """``run_chunk`` of ``n_sweeps`` sweeps as a captured step on ``state``
    (its sweep counter made a device tensor). Each replay's output is the
    [4] vector of the chunk's ``STAT_KEYS``; ``record`` > 0 keeps the last
    ``record`` of them in the step's ``history`` ([record, 4])."""

    def chunk(st):
        st, stats = run_chunk(problem, config, engine, st, n_sweeps)
        return st, torch.stack([stats[k].reshape(()) for k in STAT_KEYS])

    state = graphs.device_counter(state)
    return graphs.CapturedStep(chunk, state, state.generator,
                               launch_counters(engine), record=record)


def _chunk_lengths(config: SAConfig) -> list:
    n_chunks = max(1, -(-config.n_sweeps // config.record_interval))
    return [n for n in (min(config.record_interval, config.n_sweeps - c *
                            config.record_interval) for c in range(n_chunks))
            if n > 0]


HIST_KEYS = ("e", "me", "t", "a")   # a checkpoint's four histories


def _ckpt_tree(state: SAState, generator: torch.Generator, hists: dict,
               sweeps_done: int) -> dict:
    """What a checkpoint holds: the state with the run's generator (the
    static state's own may be an earlier run's), the histories as float32
    arrays and the sweeps done."""
    return {"state": dataclasses.replace(state, generator=generator),
            "hist": {k: np.asarray(v, np.float32) for k, v in hists.items()},
            "sweeps_done": np.int64(sweeps_done)}


@graphs.serialized
def anneal(problem: IsingProblem, config: Optional[SAConfig] = None,
           generator: Optional[torch.Generator] = None,
           init_spins: Optional[torch.Tensor] = None,
           checkpoint_dir: Optional[str] = None,
           checkpoint_every: int = 10,
           resume: bool = False) -> AnnealResult:
    """Full annealing run with history recording and optional early stop.

    Each chunk of ``record_interval`` sweeps is one replay of the captured
    chunk (``capture_chunk``; a shorter last chunk has a graph of its own),
    and the host reads the device once per chunk: the four history values,
    through a pinned buffer. The best replica is picked on the device and
    only its row is copied to the host.

    ``checkpoint_dir`` saves (state, generator, histories, sweeps done) every
    ``checkpoint_every`` chunks as ``ckpt_{chunks}.pt``; ``resume=True``
    loads the latest checkpoint there into the captured chunk, sets the
    run's generator to its state and runs the chunks that remain: the result
    equals the uninterrupted run's bit for bit.

    The engine and the captured chunks are kept per (problem object,
    config without its seed) (``graphs.SA_CACHE``, ``graphs.config_key``):
    the first call captures, a repeat call
    copies its start state in and replays. ``total_time`` is the wall time
    from the start state to the last read, as the JAX driver times it: on
    the first call it includes the capture (the JAX package's compile falls
    there too), on a repeat call there is none (``capture_seconds`` in the
    metadata says what it took). ``kernel_launches`` are this call's.
    """
    config = config or SAConfig()
    lengths = _chunk_lengths(config)
    key = ("anneal", graphs.config_key(config))
    entry = graphs.SA_CACHE.get(problem, key)
    engine = entry[0] if entry else make_sweep_engine(problem, config)
    launches0 = kernel_launches(engine)
    state = init_state(problem, config, engine, generator, init_spins)
    generator = state.generator
    e_hist, me_hist, t_hist, a_hist = [], [], [], []
    converged, conv_sweep = False, None
    sweeps_done = 0
    read = graphs.HostRead()

    _sync(problem.device)
    t0 = time.perf_counter()
    if entry is None:
        steps = {}   # chunk length -> its captured step, all on one state
        for n in lengths:
            if n not in steps:
                steps[n] = capture_chunk(problem, config, engine, state, n)
                state = steps[n].state
        graphs.SA_CACHE.put(problem, key, (engine, steps))
        capture_s = sum(st.capture_seconds for st in steps.values())
    else:
        capture_s = 0.0
        steps = entry[1]
        if steps:   # all on one state
            steps[lengths[0]].load(graphs.device_counter(state))
            state = steps[lengths[0]].state
    mgr = None
    if checkpoint_dir is not None:
        mgr = CheckpointManager(checkpoint_dir, every=checkpoint_every)
        if resume:
            restored = mgr.restore_latest(_ckpt_tree(
                state, generator, {k: np.zeros(0) for k in HIST_KEYS}, 0))
            if restored is not None:
                steps[lengths[0]].load(restored["state"])
                generator.set_state(restored["state"].generator.get_state())
                hist = restored["hist"]
                e_hist, me_hist, t_hist, a_hist = (
                    hist[k].tolist() for k in HIST_KEYS)
                sweeps_done = int(restored["sweeps_done"])
    for n in lengths[len(e_hist):]:
        e, me, t, a = read([steps[n].replay(generator)])[0].tolist()
        sweeps_done += n
        e_hist.append(e)
        me_hist.append(me)
        t_hist.append(t)
        a_hist.append(a)
        if mgr is not None:
            mgr.maybe_save(len(e_hist), _ckpt_tree(
                state, generator, {"e": e_hist, "me": me_hist, "t": t_hist,
                                   "a": a_hist}, sweeps_done))
        if config.enable_early_stop and len(e_hist) >= 20:
            tail = np.asarray(e_hist[-20:])
            denom = max(abs(float(np.mean(tail))), 1e-10)
            if float(np.std(tail)) / denom < config.convergence_tolerance:
                converged, conv_sweep = True, sweeps_done
                break
    _sync(problem.device)
    total = time.perf_counter() - t0
    return _result(problem, config, engine, state, launches0,
                   (e_hist, me_hist, t_hist, a_hist), sweeps_done, total,
                   capture_s, converged, conv_sweep)


def _anneal_given(problem: IsingProblem, config: SAConfig, uniforms,
                  generator: Optional[torch.Generator] = None,
                  init_spins: Optional[torch.Tensor] = None) -> AnnealResult:
    """``anneal`` of a dense problem on given uniforms [S, R, Np]: sweep t
    reads row t (``engines.GivenUniforms``) in place of the generator's
    draws; the start spins still come from ``init_spins`` or the generator.
    The chunks run eagerly (``run_chunk``), nothing is captured or cached,
    and every sweep runs (no early stop). The research functions' ``draws``
    come here: the tests feed them the JAX package's own."""
    if config.enable_early_stop:
        raise ValueError("given uniforms run every sweep: no early stop")
    engine = GivenUniforms(make_sweep_engine(problem, config), uniforms)
    launches0 = kernel_launches(engine)
    state = init_state(problem, config, engine, generator, init_spins)
    hists = ([], [], [], [])
    t0 = time.perf_counter()
    for n in _chunk_lengths(config):
        state, stats = run_chunk(problem, config, engine, state, n)
        for h, k in zip(hists, STAT_KEYS):
            h.append(float(stats[k]))
    _sync(problem.device)
    return _result(problem, config, engine, state, launches0, hists,
                   config.n_sweeps, time.perf_counter() - t0, 0.0)


def _result(problem, config, engine, state, launches0, hists, sweeps_done,
            total, capture_s, converged=False, conv_sweep=None
            ) -> AnnealResult:
    """The run's ``AnnealResult`` from its last state and the histories
    (best, mean energy, temperature, acceptance per chunk), published."""
    e_hist, me_hist, t_hist, a_hist = hists
    best_r = torch.argmin(state.best_energy)
    best_spins = best_row(engine, state.best_spins, best_r).cpu().numpy()[
        : problem.n_spins]
    flips = sweeps_done * config.n_replicas * problem.n_spins
    launches = kernel_launches(engine)
    result = AnnealResult(
        best_spins=best_spins,
        best_energy=float(state.best_energy[best_r]),
        # one copy on either device: on the CPU .cpu() would be the cached
        # state's own tensor
        replica_best_energy=state.best_energy.to("cpu", copy=True).numpy(),
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
                  "kernel_launches": {k: v - launches0.get(k, 0)
                                      for k, v in launches.items()},
                  "capture_seconds": capture_s},
    )
    try:  # prometheus gauges (host values only: no read of the device)
        from spinglass_tpu_torch.utils.metrics_exporter import (
            publish_anneal_result)

        publish_anneal_result(result, solver="sa")
    except Exception:  # metrics must never break a solve
        pass
    return result


@graphs.serialized
def anneal_scan(problem: IsingProblem, config: Optional[SAConfig] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[SAState, dict]:
    """The JAX package's single-dispatch anneal (no early stop, no host
    read until the end; the benchmark / RL inner loop): the captured chunk of
    ``record_interval`` sweeps replayed n_rec = n_sweeps // record_interval
    times, each replay writing its statistics into row n of the history at
    a device counter. Returns (state, hist): the state in the engine's
    layout (its sweep counter a device tensor, its generator the run's), and
    hist a dict of [n_rec] tensors on the device under the JAX keys
    (``STAT_KEYS``); both are the call's own copies. The engine and the
    captured chunk are kept per (problem object, config), as ``anneal``
    keeps them."""
    config = config or SAConfig()
    n_rec = max(1, config.n_sweeps // config.record_interval)
    key = ("anneal_scan", graphs.config_key(config))
    entry = graphs.SA_CACHE.get(problem, key)
    engine = entry[0] if entry else make_sweep_engine(problem, config)
    state = init_state(problem, config, engine, generator)
    if entry is None:
        step = capture_chunk(problem, config, engine, state,
                             config.record_interval, record=n_rec)
        graphs.SA_CACHE.put(problem, key, (engine, step))
    else:
        step = entry[1]
        step.load(graphs.device_counter(state))
    for _ in range(n_rec):
        step.replay(state.generator)
    out = dataclasses.replace(graphs.clone(step.state),
                              generator=state.generator)
    return out, {k: step.history[:, i].clone()
                 for i, k in enumerate(STAT_KEYS)}
