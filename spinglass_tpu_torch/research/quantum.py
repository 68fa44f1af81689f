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
from spinglass_tpu_torch.core.problem import IsingProblem, round_up


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
        """Flat indices into J of the inter-slice couplings: (s, i) with
        (s + 1 mod P, i) both ways, one edge for P = 2, none for P = 1."""
        n, p = self.slice_spins, self.n_trotter
        if p == 1:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        i = torch.arange(n, device=self.device)
        rows, cols = [], []
        for s in range(1 if p == 2 else p):
            a, b = s * n + i, ((s + 1) % p) * n + i
            rows += [a, b]
            cols += [b, a]
        return torch.cat(rows) * self.n_padded + torch.cat(cols)

    def set_field(self, beta: float, gamma: float) -> None:
        """The inter-slice couplings for transverse field ``gamma``: J_perp
        in float64, cast once to float32, written in place (on the device's
        current stream, before the next sweep reads J)."""
        value = float(np.float32(j_perp(beta, gamma, self.n_trotter)))
        self.j.view(-1).index_fill_(0, self.inter_slice_index(), value)


def trotterize(problem: IsingProblem, n_trotter: int, beta: float,
               gamma: float) -> TrotterProblem:
    """Build the P*N-spin classical problem for transverse field gamma on
    ``problem``'s device. J/P and h/P are computed in float64 and cast once,
    as the JAX function's float64 array is cast by ``from_dense``, so J, h
    and the mask equal the JAX package's element for element."""
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


def slice_energies(problem: IsingProblem, trotter_spins, n_trotter: int):
    """The P slices of one Trotter configuration ([P*N] numpy) and their
    classical energies on ``problem`` ([P] float32 numpy, one read)."""
    n = problem.n_spins
    slices = np.asarray(trotter_spins)[: n_trotter * n].reshape(n_trotter, n)
    full = np.ones((n_trotter, problem.n_padded), np.float32)
    full[:, :n] = slices
    e = energy_ops.energy(problem, torch.as_tensor(full, device=problem.device))
    return slices, e.cpu().numpy()


def stage_config(cfg, n_sweeps: int, seed: int) -> SAConfig:
    """One anneal at the constant temperature 1 / beta through
    ``use_kernel="auto"``: K1 on the card."""
    return SAConfig(
        n_sweeps=n_sweeps, n_replicas=cfg.n_replicas,
        schedule=ScheduleConfig(ScheduleType.CONSTANT,
                                initial_temp=1.0 / cfg.beta,
                                final_temp=1.0 / cfg.beta),
        use_kernel="auto", enable_early_stop=False, seed=seed)


def anneal_drawn(problem: IsingProblem, config: SAConfig,
                 generator: Optional[torch.Generator],
                 draws: Optional[Sequence]) -> AnnealResult:
    """``sa.anneal`` of ``problem``; where ``draws`` = (start spins [R, Np],
    uniforms [S, R, Np]) are given, the same anneal on them instead of the
    generator's (``sa._anneal_given``: eager, nothing captured)."""
    if draws is None:
        return anneal(problem, config, generator=generator)
    init, uniforms = draws
    return _anneal_given(problem, config, uniforms, generator,
                         torch.tensor(np.asarray(init, np.float32)))


@dataclass(frozen=True)
class SQAConfig:
    """The JAX ``SQAConfig``, with the same defaults."""

    n_trotter: int = 8
    beta: float = 2.0
    gamma_start: float = 2.5
    gamma_end: float = 0.01
    n_stages: int = 10
    sweeps_per_stage: int = 100
    n_replicas: int = 16
    seed: int = 42


@graphs.serialized
def simulated_quantum_annealing(problem: IsingProblem,
                                cfg: Optional[SQAConfig] = None,
                                generator: Optional[torch.Generator] = None,
                                draws: Optional[Sequence] = None
                                ) -> AnnealResult:
    """Anneal the transverse field Gamma from gamma_start to gamma_end
    (``np.geomspace`` over the stages), running ``sweeps_per_stage`` sweeps
    on the Trotter system at each stage from fresh random spins, and decode
    the best classical slice of each stage's best replica.

    Every stage draws from ``generator`` (default: seeded by ``cfg.seed``).
    ``draws``, one (start spins [R, Np_t], uniforms [S, R, Np_t]) per stage,
    replaces them (``anneal_drawn``): the tests feed the JAX function's
    own. ``metadata`` holds the gammas, this call's captures
    (``graphs.CapturedStep.made``) and their seconds; its K1 launches are
    counted in ``metropolis_cuda.LAUNCHES``."""
    cfg = cfg or SQAConfig()
    n = problem.n_spins
    gammas = np.geomspace(cfg.gamma_start, max(cfg.gamma_end, 1e-3),
                          cfg.n_stages)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    made0 = graphs.CapturedStep.made
    capture_s = 0.0
    best_energy = np.inf
    best_spins = None
    e_hist = []
    t0 = time.perf_counter()
    for stage, gamma in enumerate(gammas):
        tp = trotter_problem(problem, cfg.n_trotter, cfg.beta, float(gamma))
        res = anneal_drawn(tp, stage_config(cfg, cfg.sweeps_per_stage,
                                             cfg.seed + stage), generator,
                           None if draws is None else draws[stage])
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
                  "capture_seconds": capture_s},
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
def path_integral_monte_carlo(problem: IsingProblem,
                              cfg: Optional[PIMCConfig] = None,
                              generator: Optional[torch.Generator] = None,
                              draws: Optional[tuple] = None) -> AnnealResult:
    """Sample the quantum action at fixed (beta, gamma); return the best
    classical slice of the best replica. One ``sa.anneal`` of the Trotter
    problem (K1 on the card), drawing from ``generator`` (default: seeded
    by ``cfg.seed``) or from ``draws`` = (start spins, uniforms), as
    ``simulated_quantum_annealing`` takes them. ``metadata`` adds the
    slice energies and this call's captures."""
    cfg = cfg or PIMCConfig()
    made0 = graphs.CapturedStep.made
    tp = trotter_problem(problem, cfg.n_trotter, cfg.beta, cfg.gamma)
    res = anneal_drawn(tp, stage_config(cfg, cfg.n_sweeps, cfg.seed),
                       generator, draws)
    slices, e_slices = slice_energies(problem, res.best_spins, cfg.n_trotter)
    k = int(np.argmin(e_slices))
    return dataclasses.replace(
        res, best_spins=slices[k], best_energy=float(e_slices[k]),
        algorithm="pimc",
        metadata={**res.metadata, "n_trotter": cfg.n_trotter,
                  "gamma": cfg.gamma, "slice_energies": e_slices.tolist(),
                  "captures": graphs.CapturedStep.made - made0})
