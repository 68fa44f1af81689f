"""Adaptive meta-RL over problem classes.

The counterpart of ``spinglass_tpu.research.meta_rl``: ProblemCharacterizer,
the strategy codec, EpisodicMemory, MetaLearningNetwork,
NeuralArchitectureSearch and AdaptiveMetaRLAgent, an agent that looks at a
problem instance, proposes an annealing strategy (temperature endpoints,
cooling rate, replica budget) from a learned model plus an episodic memory
of past solves, executes it, and improves from the outcome.

The strategy network is a ``torch.nn.Module`` (flax's layers: LayerNorm
epsilon 1e-6) called through ``torch.func.functional_call`` on a parameter
dict, as the flax module is applied to its parameter tree. Its regression
fit, one ``lax.scan`` of full-batch Adam steps in the JAX package, is one
loop of Adam steps on the device with one read at its end. The solves it
controls are the port's ``sa.anneal`` (K1 on the card); the architecture
search is a host-side evolutionary loop around fits. The codec, the memory
and the search are numpy, copied from the JAX module.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu_torch.core.problem import IsingProblem, resolve_device
from spinglass_tpu_torch.research.meta import characterize
from spinglass_tpu_torch.rl.ppo import init_params

EMBED_DIM = 8       # characterize() feature vector
STRATEGY_DIM = 3    # [log10 T0, logit(alpha scaled), log2 replica-mult]


class ProblemCharacterizer:
    """Class facade over :func:`characterize` (reference ProblemCharacterizer,
    adaptive_meta_rl.py:139-283), plus batch characterization and feature
    names for reporting."""

    feature_names = (
        "log10_n", "density", "mean_abs_j", "std_j", "frustration",
        "mean_abs_h", "degree_cv", "frac_negative_j",
    )

    def characterize(self, problem: IsingProblem) -> np.ndarray:
        return characterize(problem)

    def characterize_batch(self,
                           problems: Sequence[IsingProblem]) -> np.ndarray:
        return np.stack([characterize(p) for p in problems])

    def describe(self, problem: IsingProblem) -> dict:
        return dict(zip(self.feature_names, characterize(problem).tolist()))


# ---------------------------------------------------------------------------
# Strategy <-> vector codec
# ---------------------------------------------------------------------------

def encode_strategy(initial_temp: float, alpha: float,
                    replica_mult: float = 1.0) -> np.ndarray:
    """Map strategy params to an unconstrained R^3 vector for regression."""
    a = min(max((alpha - 0.9) / 0.0999, 1e-4), 1 - 1e-4)  # alpha in (0.9, 1)
    return np.asarray([
        math.log10(max(initial_temp, 1e-3)),
        math.log(a / (1 - a)),
        math.log2(max(replica_mult, 0.25)),
    ], dtype=np.float32)


def decode_strategy(vec: np.ndarray) -> dict:
    v = np.asarray(vec, dtype=np.float64)
    alpha = 0.9 + 0.0999 / (1.0 + math.exp(-float(v[1])))
    return {
        "initial_temp": float(10.0 ** np.clip(v[0], -1.0, 2.0)),
        "alpha": float(alpha),
        "replica_mult": float(2.0 ** np.clip(v[2], -2.0, 2.0)),
    }


# ---------------------------------------------------------------------------
# Episodic memory
# ---------------------------------------------------------------------------

@dataclass
class Episode:
    embedding: np.ndarray    # [EMBED_DIM]
    strategy: np.ndarray     # [STRATEGY_DIM]
    score: float             # outcome (higher is better)


@dataclass
class EpisodicMemory:
    """Bounded store of (problem embedding, strategy, outcome) episodes with
    kernel-weighted nearest-neighbor recall (reference EpisodicMemory,
    adaptive_meta_rl.py:384-427). Eviction drops the worst-scoring episode
    once ``capacity`` is reached, so memory quality is monotone."""

    capacity: int = 256
    episodes: List[Episode] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.episodes)

    def store(self, embedding: np.ndarray, strategy: np.ndarray,
              score: float) -> None:
        self.episodes.append(Episode(np.asarray(embedding, np.float32),
                                     np.asarray(strategy, np.float32),
                                     float(score)))
        if len(self.episodes) > self.capacity:
            worst = int(np.argmin([e.score for e in self.episodes]))
            self.episodes.pop(worst)

    def recall(self, embedding: np.ndarray, k: int = 5,
               bandwidth: float = 1.0) -> Optional[np.ndarray]:
        """Score-and-distance-weighted blend of the k nearest strategies;
        None when the memory is empty."""
        if not self.episodes:
            return None
        emb = np.stack([e.embedding for e in self.episodes])
        d = np.linalg.norm(emb - np.asarray(embedding, np.float32), axis=1)
        near = np.argsort(d)[:k]
        w = np.exp(-d[near] / max(bandwidth, 1e-6))
        w = w * np.maximum([self.episodes[i].score for i in near], 1e-6)
        if w.sum() <= 0:
            w = np.ones_like(w)
        strat = np.stack([self.episodes[i].strategy for i in near])
        return (w[:, None] * strat).sum(0) / w.sum()

    def nearest_distance(self, embedding: np.ndarray) -> float:
        if not self.episodes:
            return float("inf")
        emb = np.stack([e.embedding for e in self.episodes])
        return float(np.linalg.norm(
            emb - np.asarray(embedding, np.float32), axis=1).min())

    def dataset(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        x = np.stack([e.embedding for e in self.episodes])
        y = np.stack([e.strategy for e in self.episodes])
        s = np.asarray([e.score for e in self.episodes], np.float32)
        return x, y, s


# ---------------------------------------------------------------------------
# Meta-learning network
# ---------------------------------------------------------------------------

class MetaLearningNetwork(nn.Module):
    """MLP: problem embedding -> strategy vector. Per hidden width ``Linear
    -> LayerNorm -> tanh``, then a ``Linear`` to ``out_dim``; ``dense[k]``
    and ``norm[k]`` are the flax module's ``Dense_k`` and ``LayerNorm_k``,
    with flax's LayerNorm epsilon 1e-6 (torch's default is 1e-5)."""

    def __init__(self, hidden_sizes: Tuple[int, ...] = (64, 64),
                 out_dim: int = STRATEGY_DIM, in_dim: int = EMBED_DIM):
        super().__init__()
        self.hidden_sizes = tuple(hidden_sizes)
        self.out_dim = out_dim
        widths = [in_dim, *self.hidden_sizes]
        self.dense = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
            + [nn.Linear(widths[-1], out_dim)])
        self.norm = nn.ModuleList([nn.LayerNorm(w, eps=1e-6)
                                   for w in self.hidden_sizes])

    def forward(self, x):
        for layer, norm in zip(self.dense, self.norm):
            x = torch.tanh(norm(layer(x)))
        return self.dense[-1](x)


def fit_meta_network(model: MetaLearningNetwork, x: np.ndarray,
                     y: np.ndarray, weights: np.ndarray,
                     n_steps: int = 200, lr: float = 3e-3,
                     seed: int = 0, params=None,
                     device=None) -> Tuple[dict, float]:
    """Score-weighted regression of strategies onto embeddings: ``n_steps``
    full-batch Adam steps (eps 1e-8, as optax's) on ``model`` called with
    ``params``, a dict by parameter name (None: LeCun-normal kernels from a
    generator seeded by ``seed``, on ``device``, default the card). The
    losses stay on the device; the last is read once. Returns (params, the
    final step's weighted MSE, taken before its update as the JAX scan
    records it)."""
    if params is None:
        dev = resolve_device(device)
        params = init_params(model.to(dev), torch.Generator().manual_seed(seed),
                             dev)
    else:
        dev = next(iter(params.values())).device
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
    model = model.to(dev)
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
    w = torch.clamp(w, min=0.0) + 1e-3
    w = w / torch.mean(w)
    opt = torch.optim.Adam(list(params.values()), lr=lr, eps=1e-8,
                           capturable=dev.type == "cuda")
    loss = torch.zeros((), device=dev)
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        pred = functional_call(model, params, (x,))
        loss = torch.mean(w[:, None] * (pred - y) ** 2)
        loss.backward()
        opt.step()
    return ({k: v.detach() for k, v in params.items()},
            float(loss.detach()))


# ---------------------------------------------------------------------------
# Neural architecture search
# ---------------------------------------------------------------------------

@dataclass
class NASResult:
    architecture: Tuple[int, ...]
    score: float
    history: List[dict]


class NeuralArchitectureSearch:
    """Evolutionary width/depth search for the meta network (reference
    NeuralArchitectureSearch, adaptive_meta_rl.py:428-564).

    Mutations grow/shrink/widen/narrow the hidden-layer tuple; candidates are
    scored by ``eval_fn(arch) -> score`` (higher is better). The default
    eval, built by :meth:`default_eval`, is the negative held-out regression
    loss of a :class:`MetaLearningNetwork` with that architecture on an
    episodic dataset; each evaluation is one fit on the device."""

    WIDTHS = (16, 32, 64, 128, 256)

    def __init__(self, population: int = 6, generations: int = 3,
                 seed: int = 0):
        self.population = population
        self.generations = generations
        self.rng = np.random.default_rng(seed)

    def _mutate(self, arch: Tuple[int, ...]) -> Tuple[int, ...]:
        arch = list(arch)
        op = self.rng.choice(["widen", "narrow", "deepen", "shrink"])
        i = self.rng.integers(len(arch))
        wi = self.WIDTHS.index(min(self.WIDTHS,
                                   key=lambda w: abs(w - arch[i])))
        if op == "widen" and wi + 1 < len(self.WIDTHS):
            arch[i] = self.WIDTHS[wi + 1]
        elif op == "narrow" and wi > 0:
            arch[i] = self.WIDTHS[wi - 1]
        elif op == "deepen" and len(arch) < 4:
            arch.insert(i, arch[i])
        elif op == "shrink" and len(arch) > 1:
            arch.pop(i)
        return tuple(arch)

    def search(self, eval_fn: Callable[[Tuple[int, ...]], float],
               initial: Tuple[int, ...] = (64, 64)) -> NASResult:
        pop = [tuple(initial)]
        while len(pop) < self.population:
            cand = self._mutate(pop[-1])
            if cand not in pop:
                pop.append(cand)
        history = []
        scored = {}
        for gen in range(self.generations):
            for arch in pop:
                if arch not in scored:
                    scored[arch] = float(eval_fn(arch))
            ranked = sorted(pop, key=lambda a: scored[a], reverse=True)
            history.append({"generation": gen,
                            "best": ranked[0], "score": scored[ranked[0]]})
            # next generation: elites + their mutations
            elites = ranked[: max(2, self.population // 3)]
            pop = list(elites)
            while len(pop) < self.population:
                cand = self._mutate(elites[self.rng.integers(len(elites))])
                if cand not in pop:
                    pop.append(cand)
        best = max(scored, key=scored.get)
        return NASResult(best, scored[best], history)

    @staticmethod
    def default_eval(x: np.ndarray, y: np.ndarray, weights: np.ndarray,
                     n_steps: int = 100, seed: int = 0, device=None):
        """eval_fn factory: negative final fit loss on (x, y, weights), each
        fit on ``device`` (default: the card)."""

        def eval_fn(arch: Tuple[int, ...]) -> float:
            model = MetaLearningNetwork(hidden_sizes=tuple(arch))
            _, loss = fit_meta_network(model, x, y, weights,
                                       n_steps=n_steps, seed=seed,
                                       device=device)
            return -loss

        return eval_fn


# ---------------------------------------------------------------------------
# The agent
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MetaRLConfig:
    n_sweeps: int = 400
    n_replicas: int = 16
    memory_capacity: int = 256
    refit_interval: int = 8        # retrain the network every k solves
    fit_steps: int = 150
    recall_distance: float = 1.5   # use memory when a neighbor is this close
    explore_std: float = 0.15      # Gaussian exploration in strategy space
    nas_after: int = 0             # run NAS once memory has this many episodes (0 = off)
    seed: int = 0


class AdaptiveMetaRLAgent:
    """Meta-level controller (reference AdaptiveMetaRLAgent,
    adaptive_meta_rl.py:565-1027): characterize -> propose strategy
    (episodic recall near known problems, network prediction otherwise,
    plus Gaussian exploration) -> run the annealer -> score the
    outcome -> store the episode -> periodically refit the network (and
    optionally re-search its architecture). The network and its fits live
    on ``device`` (default: the card); each solve anneals on its problem's
    device."""

    def __init__(self, cfg: Optional[MetaRLConfig] = None, device=None):
        self.cfg = cfg or MetaRLConfig()
        self.device = resolve_device(device)
        self.characterizer = ProblemCharacterizer()
        self.memory = EpisodicMemory(capacity=self.cfg.memory_capacity)
        self.model = MetaLearningNetwork().to(self.device)
        self.params = None
        self.rng = np.random.default_rng(self.cfg.seed)
        self.n_solves = 0
        self.fit_log: List[float] = []

    # -- strategy proposal ---------------------------------------------------

    def propose(self, problem: IsingProblem) -> Tuple[np.ndarray, dict, str]:
        emb = self.characterizer.characterize(problem)
        source = "default"
        vec = encode_strategy(5.0, 0.99)
        if (self.memory.nearest_distance(emb) < self.cfg.recall_distance):
            rec = self.memory.recall(emb)
            if rec is not None:
                vec, source = rec, "memory"
        elif self.params is not None:
            with torch.no_grad():
                vec = functional_call(self.model, self.params, (torch.as_tensor(
                    emb, dtype=torch.float32, device=self.device)[None],))
            vec = vec[0].cpu().numpy()
            source = "network"
        vec = vec + self.rng.normal(0.0, self.cfg.explore_std, STRATEGY_DIM)
        return emb, decode_strategy(vec) | {"_vec": vec}, source

    # -- solve + learn -------------------------------------------------------

    def solve(self, problem: IsingProblem):
        emb, strat, source = self.propose(problem)
        n_rep = max(4, int(round(self.cfg.n_replicas * strat["replica_mult"])))
        res = anneal(problem, SAConfig(
            n_sweeps=self.cfg.n_sweeps, n_replicas=n_rep,
            schedule=ScheduleConfig(
                ScheduleType.GEOMETRIC, initial_temp=strat["initial_temp"],
                final_temp=0.01, alpha=strat["alpha"],
                total_sweeps=self.cfg.n_sweeps),
            use_kernel="auto", enable_early_stop=False,
            seed=self.cfg.seed + self.n_solves))
        first = (float(res.mean_energy_history[0])
                 if len(res.mean_energy_history) else 0.0)
        score = (first - res.best_energy) / max(abs(first), 1e-9)
        self.memory.store(emb, strat["_vec"], score)
        self.n_solves += 1
        if (self.n_solves % self.cfg.refit_interval == 0
                and len(self.memory) >= 4):
            self.refit()
        return res, {"strategy": {k: v for k, v in strat.items()
                                  if not k.startswith("_")},
                     "source": source, "score": score}

    def refit(self) -> float:
        x, y, s = self.memory.dataset()
        if (self.cfg.nas_after and len(self.memory) >= self.cfg.nas_after
                and not self.fit_log):
            nas = NeuralArchitectureSearch(seed=self.cfg.seed)
            best = nas.search(NeuralArchitectureSearch.default_eval(
                x, y, s, n_steps=self.cfg.fit_steps // 2, device=self.device))
            self.model = MetaLearningNetwork(
                hidden_sizes=best.architecture).to(self.device)
            self.params = None
        self.params, loss = fit_meta_network(
            self.model, x, y, s, n_steps=self.cfg.fit_steps,
            seed=self.cfg.seed, params=self.params, device=self.device)
        self.fit_log.append(loss)
        return loss

    def report(self) -> dict:
        return {
            "n_solves": self.n_solves,
            "memory_size": len(self.memory),
            "fits": len(self.fit_log),
            "last_fit_loss": self.fit_log[-1] if self.fit_log else None,
            "architecture": tuple(self.model.hidden_sizes),
        }
