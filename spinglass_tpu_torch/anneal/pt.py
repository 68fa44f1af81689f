"""Parallel tempering: lockstep replica-exchange Monte Carlo.

The counterpart of ``spinglass_tpu.anneal.pt``:

* replicas are a batched axis swept in lockstep by one engine sweep;
* exchanges swap temperatures, not states: each replica carries a ladder
  slot, and an accepted exchange permutes slots, so only [R] vectors move;
* even/odd nearest-neighbour pairing (or a random perfect matching,
  ``exchange_method="all_pairs"``) with acceptance
  p = min(1, exp((beta_i - beta_j) (E_i - E_j))).

A super-step is ``exchange_interval`` sweeps, one exchange pass and an exact
energy resync. The JAX driver runs the whole run as one jitted scan; here a
run is a Python loop of super-steps whose tensors never leave the device:
the randomness comes from the host ``torch.Generator`` in the state (one
seed per sweep and per exchange pass), the per-super-step statistics stay
device tensors, and the host reads the device once, at the end. The best
replica is chosen on the device and only its row is copied back. The kernel
engines update ``PTState.spins`` in place; ``best_spins`` is always a
separate tensor.

Not ported yet (they raise): ``cluster_moves > 0`` (needs
``core/cluster.py``), checkpoint/resume (the JAX ``_run_segmented``) and
``tune_ladder``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from spinglass_tpu_torch.anneal.engines import (SweepEngine, best_row,
                                                kernel_launches, make_engine)
from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.core import energy as energy_ops
from spinglass_tpu_torch.core.problem import random_spins
from spinglass_tpu_torch.kernels.sweeps import device_uniforms


@dataclass(frozen=True)
class PTConfig:
    """Static PT parameters (the JAX ``PTConfig`` with ``use_pallas``
    renamed ``use_kernel``; J in float32 only)."""

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
        if self.j_dtype != "float32":
            raise NotImplementedError(
                "the port's sweep kernels read J in float32 only")


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
    sweep: int
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


def make_pt_step(problem, cfg: PTConfig,
                 ladder_override: Optional[np.ndarray] = None,
                 engine: Optional[SweepEngine] = None
                 ) -> Tuple[Callable, torch.Tensor, SweepEngine]:
    """The PT super-step: ``exchange_interval`` sweeps, one exchange pass
    and an exact energy resync. Returns (super_step, betas_ladder, engine);
    ``super_step(state, betas=None)`` returns (state, stats) with the stats
    as device tensors. ``engine`` overrides make_engine's choice."""
    if cfg.cluster_moves > 0:
        raise NotImplementedError(
            "PTConfig.cluster_moves > 0 needs core/cluster.py (Swendsen-Wang), "
            "which is not ported yet")
    if engine is None:
        engine = make_engine(problem, sweep_method=cfg.sweep_method,
                             update_rule=cfg.update_rule,
                             block_size=cfg.block_size,
                             use_kernel=cfg.use_kernel,
                             r_hint=cfg.n_replicas * cfg.n_chains)
    temps = (np.asarray(ladder_override, np.float32)
             if ladder_override is not None else temperature_ladder(cfg))
    betas_ladder = torch.as_tensor(1.0 / temps, device=problem.device)

    def super_step(state: PTState, betas: Optional[torch.Tensor] = None):
        betas = betas_ladder if betas is None else betas
        for _ in range(cfg.exchange_interval):
            state = _one_sweep(problem, engine, state, betas)
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

    return super_step, betas_ladder, engine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(problem, cfg: Optional[PTConfig] = None,
        generator: Optional[torch.Generator] = None,
        ladder_override: Optional[np.ndarray] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 10,
        resume: bool = False) -> AnnealResult:
    """Full PT run on a dense ``IsingProblem`` or an ``EllProblem``.
    ``ladder_override``: an explicit temperature ladder instead of the
    config's spacing. Checkpoint/resume is not ported yet and raises."""
    if checkpoint_dir is not None or resume:
        raise NotImplementedError("PT checkpoint/resume (segmented runs) is "
                                  "not ported yet")
    del checkpoint_every
    cfg = cfg or PTConfig()
    n_super = max(1, cfg.n_sweeps // cfg.exchange_interval)
    super_step, betas_ladder, engine = make_pt_step(problem, cfg,
                                                    ladder_override)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    _sync(problem.device)
    t0 = time.perf_counter()
    state = init_state(problem, cfg, generator, engine)
    hist = []
    for _ in range(n_super):
        state, stats = super_step(state)
        hist.append(stats)
    best_r = torch.argmin(state.best_energy)
    dev_out = {
        "best_spins": best_row(engine, state.best_spins, best_r),
        "best_energy": torch.min(state.best_energy),
        "replica_best": state.best_energy,
        "exch_attempts": state.exch_attempts,
        "exch_accepts": state.exch_accepts,
    }
    dev_hist = {k: torch.stack([h[k] for h in hist]) for k in hist[0]}
    out = {k: v.cpu().numpy() for k, v in dev_out.items()}   # read at the end
    out["hist"] = {k: v.cpu().numpy() for k, v in dev_hist.items()}
    _sync(problem.device)
    total = time.perf_counter() - t0
    return _assemble_result(problem, cfg, out, betas_ladder, n_super, total,
                            engine)


def _assemble_result(problem, cfg: PTConfig, out: dict, betas_ladder,
                     n_super: int, total: float,
                     engine: Optional[SweepEngine] = None) -> AnnealResult:
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
            "kernel_launches": kernel_launches(engine),
        },
    )


def tune_ladder(problem, cfg: PTConfig, n_pilot_sweeps: int = 200,
                n_iters: int = 2, generator=None):
    """Feedback-optimised temperature ladder: not ported yet."""
    raise NotImplementedError("tune_ladder is not ported yet (it needs "
                              "core/dynamics_analysis.py)")


def exchange_rate_summary(result: AnnealResult) -> dict:
    """Exchange statistics of a PT result."""
    rates = np.asarray(result.metadata.get("exchange_rates", []))
    return {
        "mean_exchange_rate": float(rates.mean()) if rates.size else 0.0,
        "min_exchange_rate": float(rates.min()) if rates.size else 0.0,
        "per_pair": rates.tolist(),
    }
