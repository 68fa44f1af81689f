"""Parallel tempering: lockstep replica-exchange Monte Carlo.

The counterpart of ``spinglass_tpu.anneal.pt``:

* replicas are a batched axis swept in lockstep by one engine sweep;
* exchanges swap temperatures, not states: each replica carries a ladder
  slot, and an accepted exchange permutes slots, so only [R] vectors move;
* even/odd nearest-neighbour pairing (or a random perfect matching,
  ``exchange_method="all_pairs"``) with acceptance
  p = min(1, exp((beta_i - beta_j) (E_i - E_j))).

A super-step is ``exchange_interval`` sweeps, one exchange pass and an exact
energy resync. The JAX driver runs the whole run as one jitted scan
(``run_all``); here ``make_pt_step``'s super-step is the eager step, whose
tensors never leave the device (the randomness comes from the host
``torch.Generator`` in the state, one seed per sweep and one device draw
per exchange pass; the sweep counter, and with it the exchange parity, is a
device tensor), and ``run`` replays it captured as a CUDA graph
(``capture_super_step``, ``graphs.CapturedStep``) n_super times, each
replay writing its statistics into the [n_super, ...] history at a device
counter. The host reads the device once, at the end. The best replica is
chosen on the device and only its row is copied back. The kernel engines
update ``PTState.spins`` in place; ``best_spins`` is always a separate
tensor.

``cluster_moves`` > 0 mixes Swendsen-Wang sweeps (``core/cluster.py``) into
every super-step after its sweeps, at each replica's current temperature;
on the card an SW sweep is the C2 and C1 kernels (bonds, then labels and
flips) drawing from one seed slot, so the super-step stays one captured
graph. ``run(checkpoint_dir=...)`` saves the state every
``checkpoint_every`` replays of the same captured super-step (the JAX
``_run_segmented``), and ``tune_ladder`` respaces the ladder from pilot
runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.anneal.engines import (SweepEngine, best_row,
                                                launch_counters, make_engine)
from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.core import dynamics_analysis as dyn
from spinglass_tpu_torch.core import energy as energy_ops
from spinglass_tpu_torch.core.cluster import SwendsenWang
from spinglass_tpu_torch.core.problem import random_spins
from spinglass_tpu_torch.core.rng import device_uniforms, host_seed
from spinglass_tpu_torch.kernels import cluster_cuda
from spinglass_tpu_torch.kernels.metropolis_cuda import J_DTYPES
from spinglass_tpu_torch.utils.checkpoint import CheckpointManager
from spinglass_tpu_torch.utils.exceptions import CheckpointError


@dataclass(frozen=True)
class PTConfig:
    """Static PT parameters (the JAX ``PTConfig`` with ``use_pallas``
    renamed ``use_kernel``). ``j_dtype`` "bfloat16" makes the fused dense
    kernel sweep on J rounded to bfloat16, as ``make_engine`` describes."""

    n_replicas: int = 8
    n_chains: int = 1          # independent PT chains swept together, one
    # ladder each; the replica axis holds C * n_replicas replicas
    n_sweeps: int = 1000
    min_temp: float = 0.1
    max_temp: float = 10.0
    ladder: str = "geometric"          # geometric | linear | exponential
    exchange_interval: int = 10
    exchange_method: str = "nearest_neighbor"  # | "all_pairs"
    cluster_moves: int = 0             # Swendsen-Wang sweeps per super-step
    update_rule: str = "metropolis"
    sweep_method: str = "auto"
    block_size: int = 128
    use_kernel: str = "auto"
    j_dtype: str = "float32"
    record_interval: int = 50
    seed: int = 42

    def __post_init__(self):
        if self.j_dtype not in J_DTYPES:
            raise ValueError(f"j_dtype must be one of {J_DTYPES}, got "
                             f"{self.j_dtype!r}")


@dataclass
class PTState:
    """Carried PT state. ``spins``/``best_spins`` are in the engine's
    layout; the tensors live on the problem's device, ``generator`` on the
    host."""

    spins: torch.Tensor
    slot: torch.Tensor          # [R] int32: ladder slot held by each replica
    energy: torch.Tensor        # [R] float32
    best_energy: torch.Tensor   # [R]
    best_spins: torch.Tensor
    generator: torch.Generator
    sweep: object               # sweeps done: an int, or a 0-d int64 device
    # tensor (the captured drivers' counter)
    exch_attempts: torch.Tensor  # [n_replicas - 1] per-ladder-pair attempts
    exch_accepts: torch.Tensor   # [n_replicas - 1]
    acc_rate: torch.Tensor       # [R]


def temperature_ladder(cfg: PTConfig) -> np.ndarray:
    """Sorted temperature ladder; slot 0 is the COLDEST."""
    r = cfg.n_replicas
    if cfg.ladder == "geometric":
        temps = np.geomspace(cfg.min_temp, cfg.max_temp, r)
    elif cfg.ladder == "linear":
        temps = np.linspace(cfg.min_temp, cfg.max_temp, r)
    elif cfg.ladder == "exponential":
        temps = cfg.min_temp * np.expm1(
            np.linspace(0, np.log(cfg.max_temp / cfg.min_temp + 1), r))
        temps = np.clip(temps + cfg.min_temp, cfg.min_temp, cfg.max_temp)
        temps[0], temps[-1] = cfg.min_temp, cfg.max_temp
    else:
        raise ValueError(cfg.ladder)
    return temps.astype(np.float32)


def _energy_in_layout(problem, engine, spins):
    if engine is not None:
        return engine.energy(spins)
    if hasattr(problem, "idx"):  # EllProblem
        from spinglass_tpu_torch.kernels.sparse import sparse_energy

        return sparse_energy(problem, spins)
    return energy_ops.energy(problem, spins)


def init_state(problem, cfg: PTConfig,
               generator: Optional[torch.Generator] = None,
               engine: Optional[SweepEngine] = None) -> PTState:
    """State with spins stored in the engine's layout ([R, Np] when
    engine=None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    r_total = cfg.n_replicas * cfg.n_chains
    dev = problem.device
    spins = random_spins(generator, (r_total, problem.n_padded),
                         problem.active_mask)
    if engine is not None:
        spins = engine.to_layout(spins)
    e = _energy_in_layout(problem, engine, spins)
    return PTState(
        spins=spins,
        slot=torch.arange(cfg.n_replicas, dtype=torch.int32,
                          device=dev).repeat(cfg.n_chains),
        energy=e,
        best_energy=e.clone(),
        best_spins=spins.clone(),
        generator=generator,
        sweep=0,
        exch_attempts=torch.zeros(cfg.n_replicas - 1, dtype=torch.int32,
                                  device=dev),
        exch_accepts=torch.zeros(cfg.n_replicas - 1, dtype=torch.int32,
                                 device=dev),
        acc_rate=torch.zeros(r_total, dtype=torch.float32, device=dev),
    )


def exchange_step(state: PTState, betas_ladder: torch.Tensor, parity,
                  u: torch.Tensor, n_chains: int = 1) -> PTState:
    """One even/odd nearest-neighbour exchange pass, vectorised.

    Works on ladder-sorted views: inv[k] = replica holding slot k. Pair
    (k, k+1) with k % 2 == parity is accepted iff
    log(u[c, k]) < (beta_k - beta_{k+1})(E_k - E_{k+1}); ``u`` [C, R-1] are
    the caller's uniforms. With ``n_chains`` C > 1 replicas [c*R:(c+1)*R]
    form chain c; the per-pair counters sum over chains."""
    nr = betas_ladder.shape[0]
    c = n_chains
    dev = state.slot.device
    slot_c = state.slot.reshape(c, nr)
    e_c = state.energy.reshape(c, nr)
    inv = torch.argsort(slot_c, dim=1)                 # [C, R] replica at slot k
    e_sorted = torch.gather(e_c, 1, inv)
    k_idx = torch.arange(nr - 1, device=dev)
    delta_beta = (betas_ladder[:-1] - betas_ladder[1:])[None, :]
    log_p = delta_beta * (e_sorted[:, :-1] - e_sorted[:, 1:])
    eligible = ((k_idx % 2) == parity)[None, :]
    accept = eligible & (torch.log(torch.clamp(u, min=1e-38)) < log_p)

    # slot k moves to k+1 if pair (k, k+1) accepted, to k-1 if (k-1, k) was
    zpad = torch.zeros(c, 1, dtype=torch.bool, device=dev)
    accept_pad = torch.cat([accept, zpad], dim=1)
    accept_prev = torch.cat([zpad, accept], dim=1)
    pos = torch.arange(nr, device=dev)[None, :]
    new_pos = torch.where(accept_pad, pos + 1,
                          torch.where(accept_prev, pos - 1, pos))
    slot_c = torch.zeros_like(slot_c).scatter(1, inv, new_pos.to(torch.int32))
    return dataclasses.replace(
        state,
        slot=slot_c.reshape(-1),
        exch_attempts=state.exch_attempts
        + torch.sum(torch.broadcast_to(eligible, accept.shape), dim=0,
                    dtype=torch.int32),
        exch_accepts=state.exch_accepts + torch.sum(accept, dim=0,
                                                    dtype=torch.int32),
    )


def exchange_step_all_pairs(state: PTState, betas_ladder: torch.Tensor,
                            perm: torch.Tensor, u: torch.Tensor,
                            n_chains: int = 1) -> PTState:
    """Random-matching exchange pass: the ladder permutation ``perm`` [R]
    pairs slot perm[i] with perm[R//2 + i], all pairs attempt at once (one
    matching shared by the chains, uniforms ``u`` [C, R//2] per chain).
    Statistics are keyed by the lower slot of each attempted pair."""
    nr = betas_ladder.shape[0]
    c = n_chains
    slot_c = state.slot.reshape(c, nr)
    e_c = state.energy.reshape(c, nr)
    inv = torch.argsort(slot_c, dim=1)
    e_sorted = torch.gather(e_c, 1, inv)
    perm = perm.to(torch.int64)
    a_slots = perm[: nr // 2]
    b_slots = perm[nr // 2: 2 * (nr // 2)]
    lo = torch.minimum(a_slots, b_slots)
    delta_beta = betas_ladder[a_slots] - betas_ladder[b_slots]
    log_p = delta_beta[None, :] * (e_sorted[:, a_slots] - e_sorted[:, b_slots])
    accept = torch.log(torch.clamp(u, min=1e-38)) < log_p

    rep_a, rep_b = inv[:, a_slots], inv[:, b_slots]
    new_a = torch.where(accept, b_slots[None, :], a_slots[None, :])
    new_b = torch.where(accept, a_slots[None, :], b_slots[None, :])
    slot_c = slot_c.clone()
    slot_c.scatter_(1, rep_a, new_a.to(torch.int32))
    slot_c.scatter_(1, rep_b, new_b.to(torch.int32))

    lo_idx = torch.clamp(lo, 0, max(nr - 2, 0))
    zeros = torch.zeros(nr - 1, dtype=torch.int32, device=slot_c.device)
    att = zeros.index_add(0, lo_idx, torch.full_like(lo_idx, c,
                                                     dtype=torch.int32))
    acc = zeros.index_add(0, lo_idx, torch.sum(accept, dim=0, dtype=torch.int32))
    return dataclasses.replace(
        state, slot=slot_c.reshape(-1),
        exch_attempts=state.exch_attempts + att,
        exch_accepts=state.exch_accepts + acc)


def _exchange_draws(cfg: PTConfig, generator: torch.Generator, device):
    """The randomness of one exchange pass, drawn on ``device``: (perm or
    None, uniforms)."""
    nr, c = cfg.n_replicas, cfg.n_chains
    if cfg.exchange_method == "all_pairs":
        perm = torch.argsort(device_uniforms(generator, (nr,), device))
        return perm, device_uniforms(generator, (c, nr // 2), device)
    return None, device_uniforms(generator, (c, nr - 1), device)


def _one_sweep(problem, engine: SweepEngine, state: PTState,
               betas: torch.Tensor) -> PTState:
    beta = betas[state.slot.long()]
    spins, de, cnt = engine.sweep(state.spins, beta, state.generator)
    energy = state.energy + de
    improved = energy < state.best_energy
    imp_b = improved[None, :] if engine.layout == "nr" else improved[:, None]
    return dataclasses.replace(
        state, spins=spins, energy=energy,
        best_energy=torch.where(improved, energy, state.best_energy),
        best_spins=torch.where(imp_b, spins, state.best_spins),
        sweep=state.sweep + 1,
        acc_rate=cnt.to(torch.float32) / problem.n_spins)


def _cluster_moves(engine: SweepEngine, sw: SwendsenWang, state: PTState,
                   betas: torch.Tensor, n_moves: int) -> PTState:
    """``n_moves`` Swendsen-Wang sweeps at each replica's temperature, on
    the [R, Np] spins (``from_layout`` and back), then the energies and the
    best spins as after a sweep."""
    s_rn = engine.from_layout(state.spins)
    de = torch.zeros(s_rn.shape[0], dtype=torch.float32, device=s_rn.device)
    for _ in range(n_moves):
        s_rn, de_i, _ = sw.sweep(s_rn, betas[state.slot.long()],
                                 state.generator)
        de = de + de_i
    spins = engine.to_layout(s_rn)
    energy = state.energy + de
    improved = energy < state.best_energy
    imp_b = improved[None, :] if engine.layout == "nr" else improved[:, None]
    return dataclasses.replace(
        state, spins=spins, energy=energy,
        best_energy=torch.where(improved, energy, state.best_energy),
        best_spins=torch.where(imp_b, spins, state.best_spins))


def make_pt_step(problem, cfg: PTConfig,
                 ladder_override: Optional[np.ndarray] = None,
                 engine: Optional[SweepEngine] = None
                 ) -> Tuple[Callable, torch.Tensor, SweepEngine]:
    """The PT super-step: ``exchange_interval`` sweeps, ``cluster_moves``
    Swendsen-Wang sweeps, one exchange pass and an exact energy resync.
    Returns (super_step, betas_ladder, engine); ``super_step(state,
    betas=None)`` returns (state, stats) with the stats as device tensors,
    and ``super_step.counters`` lists the launch counters of the kernels it
    runs (the engine's, and C2's and C1's with cluster moves). ``engine``
    overrides make_engine's choice."""
    if engine is None:
        engine = make_engine(problem, sweep_method=cfg.sweep_method,
                             update_rule=cfg.update_rule,
                             block_size=cfg.block_size,
                             use_kernel=cfg.use_kernel,
                             j_dtype=cfg.j_dtype,
                             r_hint=cfg.n_replicas * cfg.n_chains)
    temps = (np.asarray(ladder_override, np.float32)
             if ladder_override is not None else temperature_ladder(cfg))
    betas_ladder = torch.as_tensor(1.0 / temps, device=problem.device)
    sw = SwendsenWang(problem) if cfg.cluster_moves > 0 else None

    def super_step(state: PTState, betas: Optional[torch.Tensor] = None):
        betas = betas_ladder if betas is None else betas
        for _ in range(cfg.exchange_interval):
            state = _one_sweep(problem, engine, state, betas)
        if sw is not None:
            state = _cluster_moves(engine, sw, state, betas, cfg.cluster_moves)
        perm, u = _exchange_draws(cfg, state.generator, betas.device)
        if cfg.exchange_method == "all_pairs":
            state = exchange_step_all_pairs(state, betas, perm, u,
                                            n_chains=cfg.n_chains)
        else:
            parity = (state.sweep // cfg.exchange_interval) % 2
            state = exchange_step(state, betas, parity, u,
                                  n_chains=cfg.n_chains)
        # exact energies once per super-step (float32 drift)
        state = dataclasses.replace(
            state, energy=_energy_in_layout(problem, engine, state.spins))
        e_c = state.energy.reshape(cfg.n_chains, cfg.n_replicas)
        inv_c = torch.argsort(state.slot.reshape(cfg.n_chains, cfg.n_replicas),
                              dim=1)
        e_by_slot = torch.gather(e_c, 1, inv_c)                # [C, R]
        stats = {
            "best_energy": torch.min(state.best_energy),
            "cold_energy": torch.mean(e_by_slot[:, 0]),
            "mean_acceptance": torch.mean(state.acc_rate),
            "slot_energy": torch.mean(e_by_slot, dim=0),
            "slot_of_replica": state.slot,
        }
        return state, stats

    super_step.counters = launch_counters(engine) + (
        [(cluster_cuda.BONDS_KERNEL, sw.bonds, "launches"),
         (cluster_cuda.KERNEL_NAME, sw.labeller, "launches")] if sw else [])
    super_step.sw = sw
    return super_step, betas_ladder, engine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def capture_super_step(super_step: Callable, engine, state: PTState,
                       record: int = 0) -> graphs.CapturedStep:
    """``super_step`` (``make_pt_step``'s) as a captured step on ``state``
    (its sweep counter made a device tensor); each replay's output is the
    super-step's stats, and ``record`` > 0 keeps the last ``record`` of
    them in the step's ``history`` (each stat with a leading [record]
    axis)."""
    state = graphs.device_counter(state)
    counters = getattr(super_step, "counters", None)
    return graphs.CapturedStep(super_step, state, state.generator,
                               launch_counters(engine) if counters is None
                               else counters, record=record)


def _counts(counters) -> dict:
    return {name: getattr(obj, attr) for name, obj, attr in counters}


@graphs.serialized
def run(problem, cfg: Optional[PTConfig] = None,
        generator: Optional[torch.Generator] = None,
        ladder_override: Optional[np.ndarray] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 10,
        resume: bool = False) -> AnnealResult:
    """Full PT run on a dense ``IsingProblem`` or an ``EllProblem``: the
    JAX ``run_all``, as the captured super-step (``capture_super_step``)
    replayed n_super times with no read in between. ``ladder_override``: an
    explicit temperature ladder instead of the config's spacing.

    ``checkpoint_dir`` (the JAX ``_run_segmented``): after every
    ``checkpoint_every`` replays the state and the run's generator are saved
    as ``ckpt_{super-steps}.pt`` and the history rows so far as
    ``history.npz``, with the engine's name, ``sweep_method``,
    ``update_rule`` and state dtype in ``engine_meta.json``; ``resume=True``
    loads the latest checkpoint, the history rows up to it and the row
    counter into the captured step and replays the rest. The same captured
    step serves both, and a resumed run equals the uninterrupted one bit
    for bit.

    The engine and the captured super-step are kept per (problem object,
    config without its seed) (``graphs.PT_CACHE``, ``graphs.config_key``);
    the ladder is copied into the cached step's beta tensor at every call,
    as the JAX run takes it as an argument. ``total_time`` is the JAX
    ``run_all``'s window: the start state, the replays and the final read,
    plus the capture on the first call (where the JAX package compiles;
    ``capture_seconds`` in the metadata) and the checkpoints.
    ``kernel_launches`` are this call's."""
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True requires checkpoint_dir")
    cfg = cfg or PTConfig()
    n_super = max(1, cfg.n_sweeps // cfg.exchange_interval)
    key = ("run", graphs.config_key(cfg))
    entry = graphs.PT_CACHE.get(problem, key)
    if entry is None:
        super_step, betas_ladder, engine = make_pt_step(problem, cfg,
                                                        ladder_override)
        counters = super_step.counters
    else:
        betas_ladder, engine, step = entry
        temps = (np.asarray(ladder_override, np.float32)
                 if ladder_override is not None else temperature_ladder(cfg))
        betas_ladder.copy_(torch.as_tensor(1.0 / temps))
        counters = step.counters
    launches0 = _counts(counters)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    _sync(problem.device)
    t0 = time.perf_counter()
    state = init_state(problem, cfg, generator, engine)
    if entry is None:
        step = capture_super_step(super_step, engine, state, record=n_super)
        graphs.PT_CACHE.put(problem, key,
                            (betas_ladder, engine, step))
        capture_s = step.capture_seconds
    else:
        step.load(graphs.device_counter(state))
        capture_s = 0.0
    if checkpoint_dir is None:
        for _ in range(n_super):
            step.replay(generator)
    else:
        _run_segmented(step, engine, cfg, generator, checkpoint_dir,
                       checkpoint_every, resume, n_super)
    state = step.state
    best_r = torch.argmin(state.best_energy)
    dev_out = {
        "best_spins": best_row(engine, state.best_spins, best_r),
        "best_energy": torch.min(state.best_energy),
        "replica_best": state.best_energy,
        "exch_attempts": state.exch_attempts,
        "exch_accepts": state.exch_accepts,
    }
    # read at the end, as one copy on either device: on the CPU .cpu() would
    # be the cached step's own tensor, which the next call overwrites
    out = {k: v.to("cpu", copy=True).numpy() for k, v in dev_out.items()}
    out["hist"] = {k: v.to("cpu", copy=True).numpy()
                   for k, v in step.history.items()}
    _sync(problem.device)
    total = time.perf_counter() - t0
    launches = _counts(counters)
    res = _assemble_result(problem, cfg, out, betas_ladder, n_super, total,
                           engine, {k: v - launches0.get(k, 0)
                                    for k, v in launches.items()})
    res.metadata["capture_seconds"] = capture_s
    try:  # prometheus gauges (host values only: no read of the device)
        from spinglass_tpu_torch.utils.metrics_exporter import (
            publish_anneal_result)

        publish_anneal_result(res, solver="pt")
    except Exception:  # metrics must never break a solve
        pass
    return res


def _run_segmented(step: graphs.CapturedStep, engine, cfg: PTConfig,
                   generator: torch.Generator, checkpoint_dir: str,
                   checkpoint_every: int, resume: bool, n_super: int) -> None:
    """The checkpointed replays of ``run`` on the loaded captured ``step``
    (its static state holds the run's start state)."""
    mgr = CheckpointManager(checkpoint_dir, every=1)
    # the engine and its state dtype decide the layout of the saved state
    # (float32 [NS, R] under K2, int8 under K4): record them, and refuse a
    # resume under another with advice rather than a shape error
    meta = {"engine": engine.name, "sweep_method": cfg.sweep_method,
            "update_rule": cfg.update_rule,
            "spin_dtype": str(step.state.spins.dtype)}
    meta_path = os.path.join(checkpoint_dir, "engine_meta.json")
    # resume keeps an existing (matching) sidecar; a fresh run writes its
    # own on its first save, since it overwrites the checkpoints
    wrote_meta = resume and os.path.exists(meta_path)
    if resume and os.path.exists(meta_path):
        with open(meta_path) as f:
            saved = json.load(f)
        saved_engine = saved.get("engine")
        saved_dtype = saved.get("spin_dtype", meta["spin_dtype"])
        if saved_engine != engine.name or saved_dtype != meta["spin_dtype"]:
            raise CheckpointError(
                f"checkpoint in {checkpoint_dir} was written by engine "
                f"'{saved_engine}' (spin dtype {saved_dtype!r}) but the "
                f"current dispatch picked '{engine.name}' (spin dtype "
                f"{meta['spin_dtype']!r}) — different state layout. Pin "
                f"PTConfig(sweep_method=...) (and on the card the engine's "
                f"accept_kernel) to the original configuration to resume, "
                f"or point checkpoint_dir at a fresh directory.")
    hist_path = os.path.join(checkpoint_dir, "history.npz")
    done = 0
    if resume:
        restored = mgr.restore_latest(
            {"state": dataclasses.replace(step.state, generator=generator),
             "done_super": np.int64(0)})
        if restored is not None:
            step.load(restored["state"])
            generator.set_state(restored["state"].generator.get_state())
            done = int(restored["done_super"])
            # the history on disk can be ahead of the restored state (a
            # crash between its write and the state's save, or a deleted
            # checkpoint): keep its first `done` rows only
            if os.path.exists(hist_path):
                with np.load(hist_path) as z:
                    for k, h in step.history.items():
                        h[:done].copy_(torch.as_tensor(z[k][:done]))
            step.row.fill_(done % n_super)
    while done < n_super:
        n_steps = min(checkpoint_every, n_super - done)
        for _ in range(n_steps):
            step.replay(generator)
        done += n_steps
        np.savez_compressed(hist_path, **{
            k: h[:done].to("cpu", copy=True).numpy()
            for k, h in step.history.items()})
        mgr.maybe_save(done, {
            "state": dataclasses.replace(step.state, generator=generator),
            "done_super": np.int64(done)})
        if not wrote_meta:
            with open(meta_path, "w") as f:
                json.dump(meta, f)
            wrote_meta = True


def _assemble_result(problem, cfg: PTConfig, out: dict, betas_ladder,
                     n_super: int, total: float,
                     engine: SweepEngine, launches: dict) -> AnnealResult:
    hist = out["hist"]
    betas = betas_ladder.cpu().numpy()
    sweeps_done = n_super * cfg.exchange_interval
    attempts = np.maximum(out["exch_attempts"], 1)
    exchange_rates = out["exch_accepts"] / attempts
    flips = sweeps_done * cfg.n_replicas * cfg.n_chains * problem.n_spins
    return AnnealResult(
        best_spins=out["best_spins"][: problem.n_spins],
        best_energy=float(out["best_energy"]),
        replica_best_energy=out["replica_best"],
        energy_history=hist["best_energy"],
        mean_energy_history=hist["cold_energy"],
        temperature_history=np.broadcast_to(1.0 / betas[0], (n_super,)).copy(),
        acceptance_history=hist["mean_acceptance"],
        n_sweeps=sweeps_done,
        n_replicas=cfg.n_replicas,
        total_time=total,
        sweeps_per_second=sweeps_done / total if total > 0 else 0.0,
        spin_flips_per_second=flips / total if total > 0 else 0.0,
        algorithm=f"pt/{cfg.update_rule}",
        device=problem.device.type,
        seed=cfg.seed,
        metadata={
            "ladder": (1.0 / betas).tolist(),
            "exchange_rates": exchange_rates.tolist(),
            "exchange_interval": cfg.exchange_interval,
            # per-slot energies (cold -> hot) averaged over the second half
            "slot_energy": hist["slot_energy"][n_super // 2:].mean(
                axis=0).tolist(),
            # per-super-step replica -> slot record [n_super, R_total]
            "slot_trajectory": np.asarray(hist["slot_of_replica"]),
            # per-super-step slot-energy record [n_super, R]
            "slot_energy_history": np.asarray(hist["slot_energy"]),
            "exchange_method": cfg.exchange_method,
            "engine": getattr(engine, "name", None),
            "kernel_launches": launches,
        },
    )


def tune_ladder(problem, cfg: PTConfig, n_pilot_sweeps: int = 200,
                n_iters: int = 2, generator: Optional[torch.Generator] = None):
    """Feedback-optimised temperature ladder (the JAX ``tune_ladder``).

    Short pilot runs (``run`` with ``ladder_override``) measure the mean
    energy per ladder slot, and the inverse temperatures are respaced so
    that the predicted pairwise acceptance, log p ~ -(dbeta)^2 |E'(beta)|, is
    equal across pairs: equal increments of M(beta) = int sqrt(|E'(beta)|)
    dbeta. Each iteration re-measures on the improved ladder. A pilot counts
    only once its coldest slot's energy series passes the two-window
    equilibration test (``dynamics_analysis.is_equilibrated``); until then
    it doubles, up to 3 tries. The pilots of an iteration start from one
    generator state, and the generator (seeded ``cfg.seed + 1`` by default)
    moves on by one draw per iteration, as the JAX key splits.

    Each pilot length is a configuration of its own, so its first run
    captures a super-step (``graphs.PT_CACHE``). Returns (temperatures
    sorted ascending like ``temperature_ladder``, diagnostics)."""
    cfg_pilot = dataclasses.replace(cfg, n_sweeps=n_pilot_sweeps)
    temps = temperature_ladder(cfg)                      # ascending (cold->hot)
    diag = {"iterations": []}
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed + 1)
    for _ in range(n_iters):
        betas = 1.0 / temps
        start = generator.get_state()
        pilot = cfg_pilot
        for _attempt in range(3):
            used_sweeps = pilot.n_sweeps
            res = run(problem, pilot,
                      generator=torch.Generator().set_state(start),
                      ladder_override=temps)
            e_hist = np.asarray(res.metadata["slot_energy_history"])
            cold_tail = e_hist[e_hist.shape[0] // 2:, 0]
            if len(cold_tail) >= 8 and dyn.is_equilibrated(cold_tail):
                break
            pilot = dataclasses.replace(pilot, n_sweeps=pilot.n_sweeps * 2)
        diag.setdefault("pilot_sweeps", []).append(used_sweeps)
        host_seed(generator)
        e_slot = np.asarray(res.metadata["slot_energy"])  # [R] cold -> hot
        rates = np.asarray(res.metadata["exchange_rates"])
        # energy is monotone in T; enforce it for stability
        e_slot = np.maximum.accumulate(e_slot)
        # equal acceptance <=> equal increments of M(beta): interpolate E on
        # a fine beta grid, integrate the measure, place betas at equal M
        b_nodes = betas[::-1]                # ascending (hot -> cold beta)
        e_nodes = e_slot[::-1]
        b_fine = np.linspace(b_nodes[0], b_nodes[-1], 1024)
        e_fine = np.interp(b_fine, b_nodes, e_nodes)
        e_prime = np.abs(np.gradient(e_fine, b_fine)) + 1e-12
        mu = np.sqrt(e_prime)
        m_cum = np.concatenate(
            [[0.0], np.cumsum(0.5 * (mu[1:] + mu[:-1]) * np.diff(b_fine))])
        m_targets = np.linspace(0.0, m_cum[-1], len(temps))
        new_betas = np.interp(m_targets, m_cum, b_fine)
        new_betas[0], new_betas[-1] = b_nodes[0], b_nodes[-1]
        temps = np.sort(1.0 / new_betas).astype(np.float32)
        diag["iterations"].append({
            "exchange_rates": rates.tolist(),
            "rate_spread": float(rates.max() - rates.min()) if rates.size
            else 0.0,
            "temps": temps.tolist(),
        })
    return temps, diag


def exchange_rate_summary(result: AnnealResult) -> dict:
    """Exchange statistics of a PT result."""
    rates = np.asarray(result.metadata.get("exchange_rates", []))
    return {
        "mean_exchange_rate": float(rates.mean()) if rates.size else 0.0,
        "min_exchange_rate": float(rates.min()) if rates.size else 0.0,
        "per_pair": rates.tolist(),
    }
