"""Quantum-inspired annealing: path-integral Monte Carlo and simulated
quantum annealing.

The counterpart of ``spinglass_tpu.research.quantum``. The quantum Ising
model with transverse field Gamma maps, via Suzuki-Trotter, to a classical
action over P imaginary-time slices:

    E_eff(s) = (1/P) sum_p E_classical(s_p)
               - J_perp * sum_p sum_i s_{p,i} s_{p+1,i}        (periodic in p)
    J_perp   = -(1/(2 beta)) * ln tanh(beta * Gamma / P)  > 0

The Trotter system is an ordinary dense problem of P*N spins (block diagonal
J/P and inter-slice ferromagnetic couplings J_perp), annealed by the port's
``sa.anneal``: K1 on the card. The JAX function builds a float64 [P*N, P*N]
array on the host for every stage; here ``trotterize`` builds it once on the
problem's device, and SQA rewrites only its inter-slice couplings in place
for each stage (``TrotterProblem.set_field``). The Trotter problem is kept
per (problem object, P) (``TROTTER_CACHE``), so the stages of a call and the
calls after it anneal one problem object, and ``sa.anneal`` keeps one
captured chunk for all of them (``graphs.SA_CACHE``): a call captures at most
once, a repeat call not at all. Its J is rewritten in place after K1's sweep
was built, so the problem declares three bf16 planes (``j_planes``): J_perp
is exact in bfloat16 at some Gamma and not at others.

A sparse problem (``kernels.sparse.EllProblem``) gives a sparse Trotter
problem (``TrotterEll``), built straight to COO with no dense intermediate:
the space bonds at J/P in every slice and the time bonds at J_perp, swept by
the transposed sparse engine (K2 where R % 128 == 0, K4 elsewhere). Its
``set_field`` writes J_perp into its own ELL values and, on the device's
stream with no read, into every copy of the time bonds that the engines of
its cached anneals keep (``SortedSparseTEngine.write_couplings``).

``SQAConfig.carry_state`` (default False, the JAX semantics: every stage
from fresh random spins) carries every replica's state from one stage to the
next on the device: only stage 0 draws start spins, and the end decodes every
replica's final state there (its P classical energies, its action).
``gamma_schedule`` "geometric" (the JAX ``np.geomspace``) or "linear"
(Gamma_k = Gamma_0 (1 - k / S), k = 0 .. S - 1). The spans ``sqa.run`` (the
call), ``sqa.start``, ``sqa.stage`` and ``sqa.decode`` mark its host work
(``utils.profiling``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import ClassVar, Optional, Sequence

import numpy as np
import torch

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.anneal.sa import SAConfig, _anneal_given, anneal
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu_torch.core import energy as energy_ops
from spinglass_tpu_torch.core import rng
from spinglass_tpu_torch.core.problem import (IsingProblem, random_spins,
                                              round_up)
from spinglass_tpu_torch.kernels import build
from spinglass_tpu_torch.kernels.sparse import (CouplingSet, EllProblem,
                                                build_ell)
from spinglass_tpu_torch.utils.profiling import global_profiler


def j_perp(beta: float, gamma: float, n_trotter: int) -> float:
    """Inter-slice coupling strength; diverges as Gamma -> 0 (slices lock)."""
    x = math.tanh(max(beta * gamma / n_trotter, 1e-12))
    return -0.5 / beta * math.log(min(max(x, 1e-300), 1.0 - 1e-16))


@dataclass(frozen=True)
class TrotterProblem(IsingProblem):
    """The P*N-spin classical problem of a transverse field: slice s holds
    spins s*N .. s*N + N - 1, as the JAX package lays them out, padded once
    at the end. ``set_field`` rewrites the inter-slice couplings in place."""

    n_trotter: int = 1
    slice_spins: int = 0
    # K1's planes of J: the inter-slice couplings change after the sweep is
    # built, so they are not counted from the first J
    j_planes: ClassVar[int] = 3

    def inter_slice_index(self) -> torch.Tensor:
        """Flat indices into J of the inter-slice couplings (``time_bonds``):
        (s, i) with (s + 1 mod P, i) both ways, one edge for P = 2, none for
        P = 1."""
        rows, cols = time_bonds(self.slice_spins, self.n_trotter)
        return torch.as_tensor(rows * self.n_padded + cols,
                               device=self.device)

    def set_field(self, beta: float, gamma: float) -> None:
        """The inter-slice couplings for transverse field ``gamma``: J_perp
        in float64, cast once to float32, written in place (on the device's
        current stream, before the next sweep reads J)."""
        value = float(np.float32(j_perp(beta, gamma, self.n_trotter)))
        self.j.view(-1).index_fill_(0, self.inter_slice_index(), value)


@dataclass(frozen=True, eq=False)
class TrotterEll(EllProblem):
    """The sparse Trotter problem of an ``EllProblem``: slice s holds spins
    s*N .. s*N + N - 1, as ``TrotterProblem`` lays them out. ``time_bonds``
    are its directed time bonds (s, i) <-> (s + 1 mod P, i), ``time_slots``
    their flat positions in ``val``, and ``field`` a 0-d float32 tensor on
    the device holding J_perp now."""

    n_trotter: int = 1
    slice_spins: int = 0
    time_bonds: Optional[CouplingSet] = None
    time_slots: Optional[torch.Tensor] = None
    field: Optional[torch.Tensor] = None

    def set_field(self, beta: float, gamma: float) -> None:
        """J_perp for transverse field ``gamma``, in float64, cast once to
        float32, written on the device's stream with no read: into
        ``field``, this problem's ELL values and every copy of the time
        bonds that the engines of its cached anneals keep."""
        self.field.fill_(float(np.float32(j_perp(beta, gamma,
                                                 self.n_trotter))))
        self.val.view(-1).index_put_((self.time_slots,), self.field)
        for engine in graphs.sa_engines_of(self):
            engine.write_couplings(self.time_bonds, self.field)


def time_bonds(n: int, p: int):
    """(rows, cols) of the directed time bonds of P slices of N spins:
    (s, i) with (s + 1 mod P, i) both ways, one edge for P = 2, none for
    P = 1."""
    i = np.arange(n, dtype=np.int64)
    rows, cols = [], []
    for s in range(0 if p == 1 else 1 if p == 2 else p):
        a, b = s * n + i, ((s + 1) % p) * n + i
        rows += [a, b]
        cols += [b, a]
    if not rows:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(rows), np.concatenate(cols)


def _trotterize_ell(problem: EllProblem, n_trotter: int, beta: float,
                    gamma: float) -> TrotterEll:
    """``trotterize`` of an ``EllProblem``, straight to COO and ELL: every
    slice holds the problem's non-zero couplings at J/P (float64, cast
    once), the field h/P likewise, and the time bonds J_perp."""
    n, p = problem.n_spins, n_trotter
    idx = problem.idx[:n].cpu().numpy().astype(np.int64)
    val = problem.val[:n].cpu().numpy()
    r_l, k_l = np.nonzero(val)
    c_l = idx[r_l, k_l]
    v_l = (val[r_l, k_l].astype(np.float64) / p).astype(np.float32)
    t_rows, t_cols = time_bonds(n, p)
    offs = (np.arange(p, dtype=np.int64) * n)[:, None]
    rows = np.concatenate([(offs + r_l).ravel(), t_rows])
    cols = np.concatenate([(offs + c_l).ravel(), t_cols])
    vals = np.concatenate([np.tile(v_l, p), np.ones(len(t_rows), np.float32)])
    n_pad = round_up(p * n)
    k = max(int(np.bincount(rows, minlength=1).max()), 1)
    t_idx, t_val, _ = build_ell(rows, cols, vals, n_pad, k)
    # the time bonds' slots: the one whose column is the bond's other end
    hit = t_idx[t_rows] == t_cols[:, None]
    slots = t_rows * k + hit.argmax(axis=1)
    h = np.zeros(n_pad, np.float32)
    h[:p * n] = np.tile(
        (problem.h[:n].cpu().numpy().astype(np.float64) / p).astype(
            np.float32), p)
    mask = np.zeros(n_pad, np.float32)
    mask[:p * n] = 1.0
    dev = problem.device
    tp = TrotterEll(idx=torch.as_tensor(t_idx, device=dev),
                    val=torch.as_tensor(t_val, device=dev),
                    h=torch.as_tensor(h, device=dev),
                    active_mask=torch.as_tensor(mask, device=dev),
                    n_spins=p * n, n_trotter=p, slice_spins=n,
                    time_bonds=CouplingSet(t_rows, t_cols),
                    time_slots=torch.as_tensor(slots, device=dev),
                    field=torch.zeros((), dtype=torch.float32, device=dev))
    tp.set_field(beta, gamma)
    return tp


def trotterize(problem, n_trotter: int, beta: float, gamma: float):
    """Build the P*N-spin classical problem for transverse field gamma on
    ``problem``'s device: a ``TrotterEll`` for an ``EllProblem``
    (``_trotterize_ell``), else a dense ``TrotterProblem``. J/P and h/P are
    computed in float64 and cast once, as the JAX function's float64 array
    is cast by ``from_dense``, so J, h and the mask equal the JAX package's
    element for element."""
    if isinstance(problem, EllProblem):
        return _trotterize_ell(problem, n_trotter, beta, gamma)
    n, p = problem.n_spins, n_trotter
    n_pad = round_up(p * n)
    dev = problem.device
    j_cls = (problem.j[:n, :n].double() / p).float()
    h_cls = (problem.h[:n].double() / p).float()
    j = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=dev)
    for s in range(p):
        j[s * n:(s + 1) * n, s * n:(s + 1) * n] = j_cls
    h = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    h[:p * n] = h_cls.repeat(p)
    mask = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    mask[:p * n] = 1.0
    tp = TrotterProblem(j=j, h=h, active_mask=mask, n_spins=p * n,
                        n_trotter=p, slice_spins=n)
    tp.set_field(beta, gamma)
    return tp


# (problem object, P) -> TrotterProblem; ``graphs.clear_caches`` clears it
TROTTER_CACHE = graphs.StepCache("trotter_problems")


def trotter_problem(problem: IsingProblem, n_trotter: int, beta: float,
                    gamma: float) -> TrotterProblem:
    """``problem``'s Trotter problem at (beta, gamma): the cached one with
    its inter-slice couplings rewritten, or a new one. The anneals of
    consecutive calls share it, and with it their captured chunk."""
    key = ("trotter", n_trotter)
    tp = TROTTER_CACHE.get(problem, key)
    if tp is None:
        tp = trotterize(problem, n_trotter, beta, gamma)
        TROTTER_CACHE.put(problem, key, tp)
    else:
        tp.set_field(beta, gamma)
    return tp


def classical_energies(problem, spins: torch.Tensor) -> torch.Tensor:
    """[M, Np] float32 spins on ``problem``'s device -> [M] energies, E =
    -1/2 s.J s - h.s in float32: ``energy_ops.energy`` for a dense problem;
    for an ``EllProblem`` slot by slot (no [M, Np, K] gather)."""
    if not isinstance(problem, EllProblem):
        return energy_ops.energy(problem, spins)
    f = torch.zeros_like(spins)
    for k in range(problem.max_degree):
        f += problem.val[:, k] * spins[:, problem.idx[:, k].long()]
    return -0.5 * torch.sum(spins * f, dim=-1) - torch.sum(spins * problem.h,
                                                           dim=-1)


def slice_energies(problem, trotter_spins, n_trotter: int):
    """The P slices of one Trotter configuration ([P*N] numpy) and their
    classical energies on ``problem`` ([P] float32 numpy, one read)."""
    n = problem.n_spins
    slices = np.asarray(trotter_spins)[: n_trotter * n].reshape(n_trotter, n)
    full = np.ones((n_trotter, problem.n_padded), np.float32)
    full[:, :n] = slices
    e = classical_energies(problem, torch.as_tensor(full,
                                                    device=problem.device))
    return slices, e.cpu().numpy()


def decode(problem, tp, spins: torch.Tensor):
    """Every replica's Trotter state ``spins`` ([R, Np_t] float32 on the
    device) decoded there: (e [R, P] the classical energies of its slices on
    ``problem``, action [R] its energy on the Trotter problem ``tp`` at the
    field ``tp`` holds, slices [R, P, N])."""
    n, p = problem.n_spins, tp.n_trotter
    r = spins.shape[0]
    slices = spins[:, : p * n].reshape(r, p, n)
    full = torch.ones((r * p, problem.n_padded), dtype=torch.float32,
                      device=spins.device)
    full[:, :n] = slices.reshape(r * p, n)
    e = classical_energies(problem, full).reshape(r, p)
    return e, classical_energies(tp, spins), slices


def stage_config(cfg, n_sweeps: int, seed: int,
                 sweep_method: str = "auto") -> SAConfig:
    """One anneal at the constant temperature 1 / beta through
    ``use_kernel="auto"``: K1 on the card for a dense problem; a sparse
    one passes ``sweep_method="sparse_t"`` (the transposed sparse engine,
    whose couplings ``TrotterEll.set_field`` rewrites)."""
    return SAConfig(
        n_sweeps=n_sweeps, n_replicas=cfg.n_replicas,
        schedule=ScheduleConfig(ScheduleType.CONSTANT,
                                initial_temp=1.0 / cfg.beta,
                                final_temp=1.0 / cfg.beta),
        sweep_method=sweep_method,
        use_kernel="auto", enable_early_stop=False, seed=seed)


def _sweep_method(problem) -> str:
    return "sparse_t" if isinstance(problem, EllProblem) else "auto"


def anneal_drawn(problem, config: SAConfig,
                 generator: Optional[torch.Generator],
                 draws: Optional[Sequence],
                 init_spins: Optional[torch.Tensor] = None,
                 final_spins: Optional[torch.Tensor] = None) -> AnnealResult:
    """``sa.anneal`` of ``problem``; where ``draws`` = (start spins [R, Np],
    uniforms [S, R, Np]) are given, the same anneal on them instead of the
    generator's (``sa._anneal_given``: eager, nothing captured).
    ``init_spins``, where given, replaces the start spins of either;
    ``final_spins`` receives the last spins (``sa.anneal``'s)."""
    if draws is None:
        return anneal(problem, config, generator=generator,
                      init_spins=init_spins, final_spins=final_spins)
    init, uniforms = draws
    if init_spins is None:
        init_spins = torch.tensor(np.asarray(init, np.float32))
    return _anneal_given(problem, config, uniforms, generator, init_spins,
                         final_spins)


GAMMA_SCHEDULES = ("geometric", "linear")


@dataclass(frozen=True)
class SQAConfig:
    """The JAX ``SQAConfig``, with the same defaults, and two fields of the
    port: ``carry_state`` (each stage continues from the last stage's
    final state on the device; False: every stage from fresh random spins,
    as the JAX function) and ``gamma_schedule`` ("geometric", the JAX
    function's, or "linear")."""

    n_trotter: int = 8
    beta: float = 2.0
    gamma_start: float = 2.5
    gamma_end: float = 0.01
    n_stages: int = 10
    sweeps_per_stage: int = 100
    n_replicas: int = 16
    seed: int = 42
    carry_state: bool = False
    gamma_schedule: str = "geometric"

    def __post_init__(self):
        if self.gamma_schedule not in GAMMA_SCHEDULES:
            raise ValueError(f"gamma_schedule must be one of "
                             f"{GAMMA_SCHEDULES}, got {self.gamma_schedule!r}")


def gammas_of(cfg: SQAConfig) -> np.ndarray:
    """The stages' transverse fields: ``np.geomspace`` from gamma_start to
    gamma_end (at least 1e-3), or linear, Gamma_k = Gamma_0 (1 - k / S) for
    k = 0 .. S - 1, which never reaches 0 (J_perp stays finite)."""
    if cfg.gamma_schedule == "linear":
        return cfg.gamma_start * (1.0 - np.arange(cfg.n_stages) / cfg.n_stages)
    return np.geomspace(cfg.gamma_start, max(cfg.gamma_end, 1e-3),
                        cfg.n_stages)


@graphs.serialized
def simulated_quantum_annealing(problem,
                                cfg: Optional[SQAConfig] = None,
                                generator: Optional[torch.Generator] = None,
                                draws: Optional[Sequence] = None
                                ) -> AnnealResult:
    """Anneal the transverse field Gamma from gamma_start over the stages
    (``gammas_of``), running ``sweeps_per_stage`` sweeps on the Trotter
    system at each, on a dense ``IsingProblem`` or an ``EllProblem``.

    Without ``carry_state`` each stage starts from fresh random spins and
    the best classical slice of each stage's best replica is decoded, as
    the JAX function does (``_sqa_fresh``); with it the state is carried
    (``_sqa_carried``). Every stage draws from ``generator`` (default:
    seeded by ``cfg.seed``). ``draws``, one (start spins [R, Np_t],
    uniforms [S, R, Np_t]) per stage, replaces them (``anneal_drawn``; with
    ``carry_state`` only stage 0's start spins are read): the tests feed
    the JAX function's own, or a plain reference's. ``metadata`` holds the
    gammas, this call's captures (``graphs.CapturedStep.made``) and their
    seconds, the counters ``stages``, ``field_writes`` and ``sweeps``, and
    the kernel launches of the call (from the launch ledger,
    ``kernels.build.LAUNCHES``)."""
    cfg = cfg or SQAConfig()
    with global_profiler.phase("sqa.run"):
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        run = _sqa_carried if cfg.carry_state else _sqa_fresh
        return run(problem, cfg, generator, draws)


def _stage(tp, cfg, stage: int, gamma: float, generator, draws, carry=None):
    """One stage's host work (the span ``sqa.stage``): J_perp for ``gamma``
    written (from stage 1 on), then the stage's anneal, from and into
    ``carry`` where it is given."""
    with global_profiler.phase("sqa.stage"):
        if stage > 0:
            tp.set_field(cfg.beta, gamma)
        return anneal_drawn(
            tp, stage_config(cfg, cfg.sweeps_per_stage, cfg.seed + stage,
                             _sweep_method(tp)),
            generator, None if draws is None else draws[stage],
            init_spins=carry, final_spins=carry)


def _sqa_fresh(problem, cfg: SQAConfig, generator, draws) -> AnnealResult:
    n = problem.n_spins
    gammas = gammas_of(cfg)
    made0 = graphs.CapturedStep.made
    l0 = build.launch_snapshot()
    capture_s = 0.0
    best_energy = np.inf
    best_spins = None
    e_hist = []
    t0 = time.perf_counter()
    tp = trotter_problem(problem, cfg.n_trotter, cfg.beta, float(gammas[0]))
    for stage, gamma in enumerate(gammas):
        res = _stage(tp, cfg, stage, float(gamma), generator, draws)
        capture_s += res.metadata["capture_seconds"]
        slices, e_slices = slice_energies(problem, res.best_spins,
                                          cfg.n_trotter)
        k = int(np.argmin(e_slices))
        if e_slices[k] < best_energy:
            best_energy = float(e_slices[k])
            best_spins = slices[k]
        e_hist.append(best_energy)
    total = time.perf_counter() - t0
    sweeps = cfg.n_stages * cfg.sweeps_per_stage
    return AnnealResult(
        best_spins=np.asarray(best_spins),
        best_energy=best_energy,
        replica_best_energy=np.asarray([best_energy]),
        energy_history=np.asarray(e_hist),
        mean_energy_history=np.asarray(e_hist),
        temperature_history=1.0 / cfg.beta * np.ones(len(e_hist)),
        acceptance_history=np.zeros(len(e_hist)),
        n_sweeps=sweeps,
        n_replicas=cfg.n_replicas,
        total_time=total,
        sweeps_per_second=sweeps / total,
        spin_flips_per_second=(sweeps * cfg.n_replicas * cfg.n_trotter * n
                               / total),
        algorithm="sqa",
        device=problem.device.type,
        seed=cfg.seed,
        metadata={"gammas": gammas.tolist(), "n_trotter": cfg.n_trotter,
                  "captures": graphs.CapturedStep.made - made0,
                  "capture_seconds": capture_s, "stages": len(gammas),
                  "field_writes": len(gammas), "sweeps": sweeps,
                  "kernel_launches": build.launches_since(l0)},
    )


def _sqa_carried(problem, cfg: SQAConfig, generator,
                 draws) -> AnnealResult:
    """SQA with the state carried: the Trotter problem fetched or built at
    Gamma_0 and the start drawn on the device (``sqa.start``); every stage
    writes its J_perp and continues from the last stage's final spins, one
    [R, Np_t] float32 tensor on the device that each stage's anneal reads
    at its start and overwrites at its end (``sqa.stage``); then every
    replica's final state is decoded on the device (``sqa.decode``): per
    replica its least slice energy and that slice's spins
    (``replica_best_energy``; ``metadata["replica_spins"]``, int8), the
    job's best, ``metadata["final_action"]`` (each replica's energy on the
    Trotter problem at the last Gamma), ``["slice_energy_mean"]`` and
    ``["final_state"]`` (the carried [R, Np_t] tensor itself). The
    histories are per stage: the best and the mean Trotter energy at the
    stage's end and its acceptance."""
    n, p, r = problem.n_spins, cfg.n_trotter, cfg.n_replicas
    gammas = gammas_of(cfg)
    made0 = graphs.CapturedStep.made
    l0 = build.launch_snapshot()
    capture_s, sweeps = 0.0, 0
    hists = ([], [], [])
    t0 = time.perf_counter()
    with global_profiler.phase("sqa.start"):
        tp = trotter_problem(problem, p, cfg.beta, float(gammas[0]))
        if draws is None:
            carry = random_spins(rng.device_generator(generator, tp.device),
                                 (r, tp.n_padded), tp.active_mask)
        else:
            carry = torch.tensor(np.asarray(draws[0][0], np.float32),
                                 device=tp.device)
    for stage, gamma in enumerate(gammas):
        res = _stage(tp, cfg, stage, float(gamma), generator, draws, carry)
        capture_s += res.metadata["capture_seconds"]
        sweeps += res.n_sweeps
        for h, v in zip(hists, (res.energy_history, res.mean_energy_history,
                                res.acceptance_history)):
            h.append(float(v[-1]))
    with global_profiler.phase("sqa.decode"):
        e, action, slices = decode(problem, tp, carry)
        least = torch.argmin(e, dim=1)
        rows = slices[torch.arange(r, device=carry.device), least]
        e_np = e.cpu().numpy()
        action_np = action.cpu().numpy()
        spins_np = rows.to(torch.int8).cpu().numpy()
    total = time.perf_counter() - t0
    per = e_np[np.arange(r), least.cpu().numpy()]
    b = int(np.argmin(per))
    return AnnealResult(
        best_spins=spins_np[b].astype(np.float32),
        best_energy=float(per[b]),
        replica_best_energy=per,
        energy_history=np.asarray(hists[0]),
        mean_energy_history=np.asarray(hists[1]),
        temperature_history=1.0 / cfg.beta * np.ones(len(gammas)),
        acceptance_history=np.asarray(hists[2]),
        n_sweeps=sweeps,
        n_replicas=r,
        total_time=total,
        sweeps_per_second=sweeps / total,
        spin_flips_per_second=sweeps * r * p * n / total,
        algorithm="sqa",
        device=problem.device.type,
        seed=cfg.seed,
        metadata={"gammas": gammas.tolist(), "n_trotter": p,
                  "captures": graphs.CapturedStep.made - made0,
                  "capture_seconds": capture_s, "stages": len(gammas),
                  "field_writes": len(gammas), "sweeps": sweeps,
                  "kernel_launches": build.launches_since(l0),
                  "carry_state": True,
                  "final_action": action_np.astype(np.float64).tolist(),
                  "slice_energy_mean": float(e_np.astype(np.float64).mean()),
                  "slice_energies": e_np, "replica_spins": spins_np,
                  "final_state": carry},
    )


@dataclass(frozen=True)
class PIMCConfig:
    """The JAX ``PIMCConfig``, with the same defaults."""

    n_trotter: int = 8
    beta: float = 2.0
    gamma: float = 1.0
    n_sweeps: int = 500
    n_replicas: int = 16
    seed: int = 42


@graphs.serialized
def path_integral_monte_carlo(problem,
                              cfg: Optional[PIMCConfig] = None,
                              generator: Optional[torch.Generator] = None,
                              draws: Optional[tuple] = None) -> AnnealResult:
    """Sample the quantum action at fixed (beta, gamma); return the best
    classical slice of the best replica. One ``sa.anneal`` of the Trotter
    problem (K1 on the card; for an ``EllProblem`` its ``TrotterEll`` on
    the transposed sparse engine), drawing from ``generator`` (default: seeded
    by ``cfg.seed``) or from ``draws`` = (start spins, uniforms), as
    ``simulated_quantum_annealing`` takes them. ``metadata`` adds the
    slice energies and this call's captures."""
    cfg = cfg or PIMCConfig()
    made0 = graphs.CapturedStep.made
    tp = trotter_problem(problem, cfg.n_trotter, cfg.beta, cfg.gamma)
    res = anneal_drawn(tp, stage_config(cfg, cfg.n_sweeps, cfg.seed,
                                        _sweep_method(tp)),
                       generator, draws)
    slices, e_slices = slice_energies(problem, res.best_spins, cfg.n_trotter)
    k = int(np.argmin(e_slices))
    return dataclasses.replace(
        res, best_spins=slices[k], best_energy=float(e_slices[k]),
        algorithm="pimc",
        metadata={**res.metadata, "n_trotter": cfg.n_trotter,
                  "gamma": cfg.gamma, "slice_energies": e_slices.tolist(),
                  "captures": graphs.CapturedStep.made - made0})
