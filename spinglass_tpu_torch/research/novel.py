"""Four research annealers: AQIA, MSHO, LESD and the repetition-code (QEC)
annealer, and the harness that compares them.

The counterpart of ``spinglass_tpu.research.novel``:

* AQIA, adaptive quantum-inspired annealing: per-spin amplitude angles
  rotated toward the local field, measured into spins, with tunnelling
  re-randomisations under a decaying transverse field. The JAX function
  runs its iterations as one ``lax.scan``; here one iteration is a captured
  step (``graphs.CapturedStep``) replayed ``n_iterations`` times, each
  replay writing the best energy so far into the step's history, which is
  read once at the end. The field is a float32 device scalar, as the JAX
  carry holds it.
* MSHO, multi-scale optimisation: greedy |J| matching coarsens the problem
  level by level (``_coarsen``, numpy on the host); the coarsest level is
  annealed, then each finer level from the lifted solution, through
  ``sa.anneal`` (K1 on the card). Each level is a new problem, so a call
  captures once per level.
* LESD, learning-enhanced spin dynamics: a small MLP (``SpinScorer``)
  scores spins from local features and biases which spin each replica
  proposes; it is trained online by Adam to predict -dE. The iteration,
  its backward pass and Adam step included, is a captured step
  (``graphs.CapturedLearner``, capturable Adam on the card) replayed
  ``n_iterations`` times; the losses are read once at the end (the JAX
  function reads one per iteration).
* QEC: each logical spin becomes ``repetition`` physical spins locked by a
  ferromagnetic code coupling; one ``sa.anneal`` of the encoded problem,
  then a majority vote.

Every draw comes from one host ``torch.Generator`` (default: seeded by the
config's seed) through ``core.rng``; ``draws=`` replaces them with given
arrays, the entry through which the tests feed the JAX functions' own draws.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.anneal.result import AnnealResult
from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig
from spinglass_tpu_torch.core import energy as energy_ops
from spinglass_tpu_torch.core import rng
from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
from spinglass_tpu_torch.research import quantum
from spinglass_tpu_torch.rl.ppo import init_params


def _generator(generator: Optional[torch.Generator],
               seed: int) -> torch.Generator:
    return (generator if generator is not None
            else torch.Generator().manual_seed(seed))


def _as_device(x, device, dtype=torch.float32) -> torch.Tensor:
    """A copy of given draws (numpy or a tensor) on ``device``."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# AQIA
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AQIAConfig:
    """The JAX ``AQIAConfig``, with the same defaults."""

    n_iterations: int = 500
    n_replicas: int = 32
    field_start: float = 2.0          # transverse field strength
    field_decay: float = 0.995
    rotation_rate: float = 0.1
    tunnel_prob: float = 0.05
    seed: int = 42


@dataclass
class AQIAState:
    """AQIA's carry: angles [R, Np], the float32 field, the best energies
    [R] and spins [R, Np], and the run's host generator."""

    theta: torch.Tensor
    field: torch.Tensor
    best_e: torch.Tensor
    best_s: torch.Tensor
    generator: torch.Generator


def _measure(problem: IsingProblem, theta: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """Spins +1 with probability cos^2(theta / 2), on the given uniforms;
    padding +1."""
    p_up = torch.cos(theta / 2.0) ** 2
    s = torch.where(u < p_up, 1.0, -1.0)
    return torch.where(problem.active_mask[None, :] > 0, s, 1.0)


def aqia_step(problem: IsingProblem, cfg: AQIAConfig, st: AQIAState,
              draws: Optional[tuple] = None) -> Tuple[AQIAState, torch.Tensor]:
    """One AQIA iteration (the JAX scan's body): measure, track the best,
    rotate each angle toward the sign of its local field, re-randomise the
    tunnelling angles, decay the field. ``draws`` = (measure uniforms,
    tunnel uniforms), each [R, Np], replaces one device generator's two
    draws. Returns (state, the best energy so far over the replicas)."""
    dev = st.theta.device
    if draws is None:
        gen = rng.device_generator(st.generator, dev)
        u_m = rng.rand(gen, st.theta.shape, dev)
        u_t = rng.rand(gen, st.theta.shape, dev)
    else:
        u_m, u_t = (_as_device(d, dev) for d in draws)
    s = _measure(problem, st.theta, u_m)
    e = energy_ops.energy(problem, s)
    improved = e < st.best_e
    best_e = torch.where(improved, e, st.best_e)
    best_s = torch.where(improved[:, None], s, st.best_s)
    # dE(flip i) = 2 s_i f_i: staying is good when s_i f_i > 0, so the
    # preferred value is s_i = sign(f_i), and theta = 0 means s = +1
    f = energy_ops.local_fields(problem, s)
    target = torch.where(f >= 0, 0.0, math.pi)
    theta = st.theta + cfg.rotation_rate * (target - st.theta)
    tunnel = u_t < cfg.tunnel_prob * st.field / cfg.field_start
    theta = torch.where(tunnel, math.pi / 2.0, theta)
    field = st.field * cfg.field_decay
    return (dataclasses.replace(st, theta=theta, field=field, best_e=best_e,
                                best_s=best_s), torch.min(best_e))


def aqia_init(problem: IsingProblem, cfg: AQIAConfig,
              generator: torch.Generator,
              u0: Optional[np.ndarray] = None) -> AQIAState:
    """Angles pi / 2 (P(s=+1) = 1/2), the field at ``field_start``, and the
    best tracking started from one measurement (on ``u0`` where given)."""
    dev = problem.device
    shape = (cfg.n_replicas, problem.n_padded)
    theta = torch.full(shape, math.pi / 2, dtype=torch.float32, device=dev)
    u0 = (rng.device_uniforms(generator, shape, dev) if u0 is None
          else _as_device(u0, dev))
    s = _measure(problem, theta, u0)
    return AQIAState(theta=theta,
                     field=torch.tensor(cfg.field_start, dtype=torch.float32,
                                        device=dev),
                     best_e=energy_ops.energy(problem, s), best_s=s,
                     generator=generator)


@graphs.serialized
def adaptive_quantum_inspired_annealing(
        problem: IsingProblem, cfg: Optional[AQIAConfig] = None,
        generator: Optional[torch.Generator] = None,
        draws: Optional[tuple] = None) -> AnnealResult:
    """``n_iterations`` AQIA iterations on ``n_replicas`` replicas. Without
    ``draws`` the iteration is a captured step replayed with no read in
    between; ``draws`` = (start uniforms [R, Np], measure uniforms [T, R,
    Np], tunnel uniforms [T, R, Np]) runs the iterations eagerly on them.
    ``metadata["capture_seconds"]`` is the capture's share of
    ``total_time``."""
    cfg = cfg or AQIAConfig()
    generator = _generator(generator, cfg.seed)
    r, n_it = cfg.n_replicas, cfg.n_iterations
    t0 = time.perf_counter()
    state = aqia_init(problem, cfg, generator,
                      None if draws is None else draws[0])
    capture_s = 0.0
    if draws is None:
        step = graphs.CapturedStep(lambda st: aqia_step(problem, cfg, st),
                                   state, generator, record=n_it)
        capture_s = step.capture_seconds
        for _ in range(n_it):
            step.replay(generator)
        state = step.state
        hist = graphs.HostRead()([step.history])[0].numpy()
    else:
        hist = []
        for t in range(n_it):
            state, out = aqia_step(problem, cfg, state,
                                   (draws[1][t], draws[2][t]))
            hist.append(out)
        hist = torch.stack(hist).cpu().numpy()
    b = torch.argmin(state.best_e)
    best_spins = state.best_s[b].cpu().numpy()[: problem.n_spins]
    best_e = state.best_e.to("cpu", copy=True).numpy()
    total = time.perf_counter() - t0
    return AnnealResult(
        best_spins=best_spins,
        best_energy=float(best_e.min()),
        replica_best_energy=best_e,
        energy_history=hist,
        mean_energy_history=hist,
        temperature_history=np.zeros(n_it),
        acceptance_history=np.zeros(n_it),
        n_sweeps=n_it, n_replicas=r, total_time=total,
        sweeps_per_second=n_it / total,
        spin_flips_per_second=n_it * r * problem.n_spins / total,
        algorithm="aqia", device=problem.device.type, seed=cfg.seed,
        metadata={"capture_seconds": capture_s},
    )


# ---------------------------------------------------------------------------
# MSHO
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MSHOConfig:
    """The JAX ``MSHOConfig``, with the same defaults."""

    min_size: int = 16
    coarse_sweeps: int = 300
    refine_sweeps: int = 200
    n_replicas: int = 16
    seed: int = 42


def _coarsen(j: np.ndarray, h: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray, np.ndarray]:
    """Greedy heavy-edge matching: pair (i, k) with max |J_ik|; the pair
    becomes one coarse variable (s_k = sign(J_ik) * s_i). Returns (J_coarse,
    h_coarse, cidx[n] the coarse index of each spin, signs[n]).

    The JAX function's result bit for bit: the matching visits the entries
    in the order of the same ``np.argsort(-|J|, axis=None)`` (not stable:
    with +-J every |J| ties, so any other order pairs differently), and the
    coarse couplings are accumulated with ``np.add.at`` in the order of the
    JAX loop, one running sum per coarse pair."""
    n = j.shape[0]
    order = np.argsort(-np.abs(j), axis=None)
    a_all, b_all = np.divmod(order, n)
    keep = (a_all < b_all) & (j[a_all, b_all] != 0)
    matched = np.zeros(n, dtype=bool)
    pairs = []
    unmatched = n
    for a, b in zip(a_all[keep].tolist(), b_all[keep].tolist()):
        if unmatched < 2:
            break
        if not matched[a] and not matched[b]:
            matched[a] = matched[b] = True
            unmatched -= 2
            pairs.append((a, b))
    cidx = np.zeros(n, dtype=np.int64)
    signs = np.zeros(n)
    for gi, (a, b) in enumerate(pairs):
        cidx[a] = cidx[b] = gi
        signs[a], signs[b] = 1.0, np.sign(j[a, b])  # s_b = sgn * coarse
    single = np.flatnonzero(~matched)
    cidx[single] = len(pairs) + np.arange(len(single))
    signs[single] = 1.0
    m = len(pairs) + len(single)
    hc = np.zeros(m)
    np.add.at(hc, cidx, signs * h)
    iu, ku = np.triu_indices(n, k=1)
    ci, ck = cidx[iu], cidx[ku]
    cross = ci != ck
    lo, hi = np.minimum(ci, ck)[cross], np.maximum(ci, ck)[cross]
    vals = (signs[iu] * signs[ku] * j[iu, ku])[cross]
    acc = np.zeros(m * m)
    np.add.at(acc, lo * m + hi, vals)
    jc = acc.reshape(m, m)
    jc = jc + jc.T
    return jc, hc, cidx, signs


def multi_scale_optimization(problem: IsingProblem,
                             cfg: Optional[MSHOConfig] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> AnnealResult:
    """Coarsen until ``min_size`` spins (or no progress), anneal the
    coarsest level from random spins (T 2.0 -> 0.01), then each finer level
    from the lifted solution (T 0.5 -> 0.01). Every level draws from
    ``generator`` (default: seeded by ``cfg.seed``). ``metadata`` is the
    finest level's anneal's with the levels and the captures of all levels
    (one per level on a first call) and without its ``kernel_launches``:
    ``metropolis_cuda.LAUNCHES`` counts those of all levels."""
    cfg = cfg or MSHOConfig()
    n = problem.n_spins
    j = problem.j[:n, :n].double().cpu().numpy()
    h = problem.h[:n].double().cpu().numpy()
    generator = _generator(generator, cfg.seed)
    made0 = graphs.CapturedStep.made

    levels = [(j, h, None, None)]
    while levels[-1][0].shape[0] > cfg.min_size:
        jc, hc, cidx, signs = _coarsen(levels[-1][0], levels[-1][1])
        if jc.shape[0] >= levels[-1][0].shape[0]:
            break
        levels.append((jc, hc, cidx, signs))

    t0 = time.perf_counter()
    spins = None
    total_sweeps = 0
    for li in range(len(levels) - 1, -1, -1):
        jl, hl = levels[li][:2]
        pl = IsingProblem.from_dense(jl, hl, device=problem.device)
        sweeps = (cfg.coarse_sweeps if li == len(levels) - 1
                  else cfg.refine_sweeps)
        init = None
        if spins is not None:
            # lift the coarser solution: s_i = signs[i] * coarse[cidx[i]]
            lifted = levels[li + 1][3] * spins[levels[li + 1][2]]
            init = np.ones((cfg.n_replicas, pl.n_padded), np.float32)
            init[:, : len(lifted)] = lifted
            init = torch.as_tensor(init)
        res = anneal(pl, SAConfig(
            n_sweeps=sweeps, n_replicas=cfg.n_replicas, use_kernel="auto",
            schedule=ScheduleConfig(
                initial_temp=2.0 if init is None else 0.5, final_temp=0.01),
            enable_early_stop=False, seed=cfg.seed + li),
            generator=generator, init_spins=init)
        spins = res.best_spins
        total_sweeps += sweeps
    total = time.perf_counter() - t0
    meta = dict(res.metadata, n_levels=len(levels),
                captures=graphs.CapturedStep.made - made0)
    del meta["kernel_launches"]
    return dataclasses.replace(res, algorithm="msho", total_time=total,
                               n_sweeps=total_sweeps, metadata=meta)


# ---------------------------------------------------------------------------
# LESD
# ---------------------------------------------------------------------------

class SpinScorer(nn.Module):
    """Tiny per-spin MLP on local features [s, f, s*f]: ``Linear(3,
    hidden) -> ReLU -> Linear(hidden, 1)``; ``dense[k]`` is the flax
    module's ``Dense_k``."""

    def __init__(self, hidden: int = 16):
        super().__init__()
        self.hidden = hidden
        self.dense = nn.ModuleList([nn.Linear(3, hidden), nn.Linear(hidden, 1)])

    def forward(self, feats):  # [..., 3]
        return self.dense[1](torch.relu(self.dense[0](feats)))[..., 0]


@dataclass(frozen=True)
class LESDConfig:
    """The JAX ``LESDConfig``, with the same defaults."""

    n_iterations: int = 300
    n_replicas: int = 16
    temperature: float = 0.5
    lr: float = 1e-2
    explore: float = 0.1
    seed: int = 42


def _features(spins: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return torch.stack([spins, f, spins * f], dim=-1)  # [R, N, 3]


def lesd_step(problem: IsingProblem, cfg: LESDConfig, model: SpinScorer,
              params: Dict[str, torch.Tensor], opt: torch.optim.Optimizer,
              spins, e, best_e, best_s, generator=None, draws=None):
    """One LESD iteration (the JAX jitted step): score every spin, pick one
    per replica by Gumbel-max over the scores (a uniform pick with
    probability ``explore``), Metropolis-accept its flip, track the best,
    then one Adam step of the scorer toward -dE of the proposed flips.
    ``draws`` = (selection uniforms [R, Np], accept uniforms [R], random
    picks [R], explore uniforms [R]) replaces one device generator's four
    draws. ``params`` are updated in place by ``opt``. Returns (spins, e,
    best_e, best_s, loss) with the loss a 0-d device tensor."""
    r = cfg.n_replicas
    dev = spins.device
    if draws is None:
        gen = rng.device_generator(generator, dev)
        u_sel = rng.rand(gen, spins.shape, dev)
        u_acc = rng.rand(gen, (r,), dev)
        rand_pick = rng.randint(gen, problem.n_spins, (r,), dev)
        u_exp = rng.rand(gen, (r,), dev)
    else:
        u_sel, u_acc, u_exp = (_as_device(draws[k], dev) for k in (0, 1, 3))
        rand_pick = _as_device(draws[2], dev, torch.int64)
    f = energy_ops.local_fields(problem, spins)
    feats = _features(spins, f)
    with torch.no_grad():
        scores = functional_call(model, params, (feats,))
    scores = torch.where(problem.active_mask[None, :] > 0, scores, -1e9)
    gumbel = -torch.log(-torch.log(u_sel + 1e-12) + 1e-12)
    pick = torch.argmax(scores + gumbel, dim=-1)
    pick = torch.where(u_exp < cfg.explore, rand_pick, pick)
    rows = torch.arange(r, device=dev)
    de = 2.0 * spins[rows, pick] * f[rows, pick]
    accept = u_acc < torch.exp(-(1.0 / cfg.temperature)
                               * torch.clamp(de, min=0.0))
    spins = spins.clone()
    spins[rows, pick] = spins[rows, pick] * torch.where(accept, -1.0, 1.0)
    e = e + torch.where(accept, de, 0.0)
    improved = e < best_e
    best_e = torch.where(improved, e, best_e)
    best_s = torch.where(improved[:, None], spins, best_s)
    # train the scorer to predict -dE of the proposed flips
    opt.zero_grad(set_to_none=True)
    pred = functional_call(model, params, (feats[rows, pick],))
    loss = torch.mean((pred - (-de)) ** 2)
    loss.backward()
    opt.step()
    return spins, e, best_e, best_s, loss.detach()


@dataclass
class LESDState:
    """LESD's carry: the scorer's parameters and their Adam, the spins
    [R, Np], their energies, the best energies and spins, and the run's
    host generator."""

    params: Dict[str, torch.Tensor]
    opt: torch.optim.Optimizer
    spins: torch.Tensor
    e: torch.Tensor
    best_e: torch.Tensor
    best_s: torch.Tensor
    generator: torch.Generator


@graphs.serialized
def learning_enhanced_dynamics(problem: IsingProblem,
                               cfg: Optional[LESDConfig] = None,
                               generator: Optional[torch.Generator] = None,
                               params: Optional[dict] = None,
                               draws: Optional[tuple] = None
                               ) -> AnnealResult:
    """NN-guided single-spin Metropolis: the scorer biases which spin each
    replica proposes; it is trained online to predict -dE (a high score is
    an energetically good flip). The scorer starts from ``params`` (a dict
    by parameter name, e.g. a flax tree carried across by
    ``core.convert.spin_scorer_from_flax``) or from LeCun-normal weights
    drawn from ``generator`` (default: seeded by ``cfg.seed``); then the
    start spins and each iteration's draws come from it. Without ``draws``
    the iteration (``lesd_step``, Adam step included) is a captured step
    (``graphs.CapturedLearner``, as the JAX step is jitted) replayed
    ``n_iterations`` times, its losses written to the step's history and
    read once. ``draws`` = (start spins [R, Np], and per iteration the four
    draws of ``lesd_step``, each with a leading [T] axis) runs the
    iterations eagerly on them. ``metadata["params"]`` holds the scorer's
    final parameters."""
    cfg = cfg or LESDConfig()
    generator = _generator(generator, cfg.seed)
    dev = problem.device
    model = SpinScorer().to(dev)
    if params is None:
        params = init_params(model, generator, dev)
    else:
        params = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                  .detach().clone().requires_grad_(True)
                  for k, v in params.items()}
    # capturable on the card: Adam's step count stays on the device
    opt = torch.optim.Adam(list(params.values()), lr=cfg.lr, eps=1e-8,
                           capturable=dev.type == "cuda")
    shape = (cfg.n_replicas, problem.n_padded)
    if draws is None:
        spins = random_spins(rng.device_generator(generator, dev), shape,
                             problem.active_mask)
    else:
        spins = _as_device(draws[0], dev)
    e = energy_ops.energy(problem, spins)
    st = LESDState(params=params, opt=opt, spins=spins, e=e, best_e=e,
                   best_s=spins, generator=generator)
    n_it = cfg.n_iterations

    def step(st, draws_t=None):
        spins, e, best_e, best_s, loss = lesd_step(
            problem, cfg, model, st.params, st.opt, st.spins, st.e, st.best_e,
            st.best_s, st.generator, draws_t)
        return (dataclasses.replace(st, spins=spins, e=e, best_e=best_e,
                                    best_s=best_s), {"loss": loss})

    t0 = time.perf_counter()
    capture_s = 0.0
    if draws is None and n_it:
        learner = graphs.CapturedLearner(step, st, ("loss",), k=n_it)
        capture_s = learner.step.capture_seconds
        for _ in range(n_it):
            learner.replay()
        losses = np.asarray([m["loss"] for m in learner.read(n_it)],
                            np.float32)
        st = learner.state
    else:
        out = []
        for it in range(n_it):
            st, m = step(st, tuple(d[it] for d in draws[1:]))
            out.append(m["loss"])
        losses = (torch.stack(out).cpu().numpy() if out
                  else np.zeros(0, np.float32))
    b = torch.argmin(st.best_e)
    best_spins = st.best_s[b].detach().cpu().numpy()[: problem.n_spins]
    best_e = st.best_e.detach().cpu().numpy()
    total = time.perf_counter() - t0
    return AnnealResult(
        best_spins=best_spins,
        best_energy=float(best_e.min()),
        replica_best_energy=best_e,
        energy_history=losses,
        mean_energy_history=losses,
        temperature_history=cfg.temperature * np.ones(len(losses)),
        acceptance_history=np.zeros(len(losses)),
        n_sweeps=n_it, n_replicas=cfg.n_replicas, total_time=total,
        sweeps_per_second=n_it / total,
        spin_flips_per_second=n_it * cfg.n_replicas / total,
        algorithm="lesd", device=dev.type, seed=cfg.seed,
        metadata={"final_loss": float(losses[-1]) if len(losses) else None,
                  "params": {k: v.detach() for k, v in st.params.items()},
                  "capture_seconds": capture_s},
    )


# ---------------------------------------------------------------------------
# QEC annealer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QECConfig:
    """The JAX ``QECConfig``, with the same defaults."""

    repetition: int = 3        # physical spins per logical spin (odd)
    code_coupling: float = 2.0  # intra-triple ferromagnetic lock
    n_sweeps: int = 400
    n_replicas: int = 16
    seed: int = 42


def qec_encode(problem: IsingProblem, repetition: int,
               code_coupling: float) -> Tuple[np.ndarray, np.ndarray]:
    """The encoded (J, h) in float64 on the host, as the JAX function
    builds them: logical couplings spread over the copies (J / rep^2 per
    copy pair), the copies of one logical spin locked by ``code_coupling``,
    h / rep per copy."""
    rep, n = repetition, problem.n_spins
    j = problem.j[:n, :n].double().cpu().numpy()
    h = problem.h[:n].double().cpu().numpy()
    big = np.kron(j / (rep * rep), np.ones((rep, rep)))
    blocks = big.reshape(n, rep, n, rep)   # a view: writes land in big
    diag = np.arange(n)
    blocks[diag, :, diag, :] = code_coupling * (np.ones((rep, rep))
                                                - np.eye(rep))
    return big, np.repeat(h / rep, rep)


def majority_decode(phys: np.ndarray, n: int, repetition: int):
    """(logical spins [n] by majority vote, code violations: the logical
    spins whose copies disagree) of physical spins [n * rep]."""
    phys = np.asarray(phys)[: n * repetition].reshape(n, repetition)
    logical = np.where(phys.sum(axis=1) >= 0, 1.0, -1.0)
    return logical, int(np.sum(np.abs(phys.sum(axis=1)) != repetition))


def quantum_error_corrected_annealing(problem: IsingProblem,
                                      cfg: Optional[QECConfig] = None,
                                      generator: Optional[torch.Generator] = None,
                                      draws: Optional[tuple] = None
                                      ) -> AnnealResult:
    """Repetition-code annealing: one ``sa.anneal`` of the encoded problem
    (T 3.0 -> 0.01; K1 on the card), then the majority vote; the reported
    energy is the logical spins' energy on ``problem``. ``draws`` = (start
    spins, uniforms) replaces the anneal's draws (``quantum.anneal_drawn``)."""
    cfg = cfg or QECConfig()
    rep, n = cfg.repetition, problem.n_spins
    big, h_big = qec_encode(problem, rep, cfg.code_coupling)
    encoded = IsingProblem.from_dense(big, h_big, device=problem.device)
    res = quantum.anneal_drawn(encoded, SAConfig(
        n_sweeps=cfg.n_sweeps, n_replicas=cfg.n_replicas,
        schedule=ScheduleConfig(initial_temp=3.0, final_temp=0.01,
                                total_sweeps=cfg.n_sweeps),
        use_kernel="auto", enable_early_stop=False, seed=cfg.seed),
        generator, draws)
    logical, violations = majority_decode(res.best_spins, n, rep)
    s = np.ones(problem.n_padded, np.float32)
    s[:n] = logical
    energy = energy_ops.energy(problem, _as_device(s, problem.device))
    return dataclasses.replace(
        res, best_spins=logical, best_energy=float(energy),
        algorithm="qec_annealer",
        metadata={**res.metadata, "repetition": rep,
                  "code_violations": violations})


ALGORITHM_REGISTRY = {
    "aqia": adaptive_quantum_inspired_annealing,
    "msho": multi_scale_optimization,
    "lesd": learning_enhanced_dynamics,
    "qec": quantum_error_corrected_annealing,
}


def compare_algorithms(problem: IsingProblem, algorithms=None,
                       seed: int = 42) -> dict:
    """Run each registered algorithm at its defaults; best energy and wall
    time per name (the JAX harness; ``seed`` is unused there too)."""
    out = {}
    for name in (algorithms or list(ALGORITHM_REGISTRY)):
        res = ALGORITHM_REGISTRY[name](problem)
        out[name] = {"best_energy": res.best_energy,
                     "total_time": res.total_time}
    return out
