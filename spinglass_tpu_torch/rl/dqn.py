"""Hybrid DQN controller over the vectorised annealer environment.

The counterpart of ``spinglass_tpu.rl.dqn``: a DQN (an MLP with LayerNorm,
a target network with soft updates, epsilon-greedy) plus a hybrid decision
rule: with probability ``annealing_weight`` a cooling heuristic overrides the
Q-net, and that weight adapts from per-choice reward EMAs. The replay buffer
is a ring of device tensors whose write pointer and fill are 0-d device
tensors; proportional prioritised replay (PER) samples by Gumbel-max over
masked log-priorities, the form of ``jax.random.categorical``.

``make_dqn``'s ``act_and_learn`` is one env step for all B envs and one TD
step, on the problem's device, in the JAX step's order: the hybrid decision,
``env.step``, the push of (obs, action, reward, pre-reset next obs, done),
``auto_reset``, the EMAs and the clipped weight, a sample of the buffer after
this step's push, the loss ``mean(is_w * td^2)`` against the target network,
the new priorities, Adam, the soft target update. It reads nothing back to
the host: the step counter, the weight and the EMAs are 0-d device tensors
that each step replaces, and every draw goes through ``core.rng`` (the
epsilon, random-action and hybrid draws, the sweeps' seeds, the reset, the
sample), so the step replays as a CUDA graph (``CapturedSteps``: k steps
between two reads of the metrics, where the JAX package scans
``steps_per_dispatch`` steps in one dispatch). ``act_and_learn(state,
draws)`` takes the draws instead (tests hand it the JAX key chain's
numbers).

The network's parameters are a dict of tensors named as the module names
them ("dense.0.weight", "norm.0.weight", ...), called through
``torch.func.functional_call``; ``core.convert.flax_path`` maps each name to
its place in the JAX package's flax tree, so ``save_params`` writes and
``load_params`` reads the JAX package's ``.npz`` format and
``core.convert.qnetwork_from_flax`` carries a flax tree across.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.core.convert import flax_path, flax_transposed
from spinglass_tpu_torch.core.problem import resolve_device
from spinglass_tpu_torch.core.rng import device_generator, rand, randint
from spinglass_tpu_torch.rl import env as env_mod
from spinglass_tpu_torch.rl.env import EnvConfig, EnvState
from spinglass_tpu_torch.rl.ppo import init_params, make_optimizer

METRIC_KEYS = ("loss", "mean_reward", "epsilon", "annealing_weight",
               "mean_best_energy")
_FIELDS = ("obs", "action", "reward", "next_obs", "done")
_TINY = torch.finfo(torch.float32).tiny


@dataclass(frozen=True)
class DQNConfig:
    hidden_sizes: Tuple[int, ...] = (128, 128)
    lr: float = 1e-3
    gamma: float = 0.99
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 2000
    tau: float = 0.005                  # soft target update
    buffer_size: int = 4096
    batch_size: int = 128
    annealing_weight: float = 0.3       # probability of the cooling heuristic
    weight_adapt_rate: float = 0.05
    prioritized_replay: bool = False    # proportional PER
    per_alpha: float = 0.6              # prioritisation exponent
    per_beta: float = 0.4               # importance-sampling exponent
    per_eps: float = 1e-3               # priority floor
    steps_per_dispatch: int = 1         # act+learn steps replayed between
    # two metrics reads in ``train.RLTrainingPipeline`` (each writes its
    # metrics into a [k, m] buffer on the device)
    seed: int = 0


class QNetwork(nn.Module):
    """An MLP of ``Linear -> LayerNorm -> ReLU`` per hidden width, then a
    ``Linear`` to the action count. ``dense[k]`` and ``norm[k]`` are the
    flax module's ``Dense_k`` and ``LayerNorm_k``; the LayerNorms take
    flax's epsilon, 1e-6 (torch's default is 1e-5)."""

    def __init__(self, obs_dim: int, n_actions: int = env_mod.N_ACTIONS,
                 hidden_sizes: Tuple[int, ...] = (128, 128)):
        super().__init__()
        widths = [obs_dim, *hidden_sizes]
        self.dense = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
            + [nn.Linear(widths[-1], n_actions)])
        self.norm = nn.ModuleList([nn.LayerNorm(w, eps=1e-6)
                                   for w in hidden_sizes])

    def forward(self, obs):
        x = obs
        for layer, norm in zip(self.dense, self.norm):
            x = torch.relu(norm(layer(x)))
        return self.dense[-1](x)


@dataclass
class ReplayBuffer:
    """A fixed-size ring of device tensors. ``push_batch`` writes in place
    and returns the buffer; ``ptr`` and ``size`` are 0-d int64 tensors on
    the buffer's device, so a push and a sample never read them back."""

    obs: torch.Tensor        # [S, obs_dim] float32
    action: torch.Tensor     # [S] int32
    reward: torch.Tensor     # [S] float32
    next_obs: torch.Tensor   # [S, obs_dim] float32
    done: torch.Tensor       # [S] bool
    ptr: torch.Tensor        # 0-d int64: the next slot written
    size: torch.Tensor       # 0-d int64: the slots written so far, <= S

    @classmethod
    def _arrays(cls, capacity: int, obs_dim: int, device) -> dict:
        device = resolve_device(device)
        return dict(
            obs=torch.zeros((capacity, obs_dim), device=device),
            action=torch.zeros(capacity, dtype=torch.int32, device=device),
            reward=torch.zeros(capacity, device=device),
            next_obs=torch.zeros((capacity, obs_dim), device=device),
            done=torch.zeros(capacity, dtype=torch.bool, device=device),
            ptr=torch.zeros((), dtype=torch.int64, device=device),
            size=torch.zeros((), dtype=torch.int64, device=device))

    @classmethod
    def create(cls, capacity: int, obs_dim: int, device=None):
        """An empty buffer of ``capacity`` slots, on the card unless
        ``device`` names another."""
        return cls(**cls._arrays(capacity, obs_dim, device))

    def _slots(self, b: int) -> torch.Tensor:
        """The ring slots of the next ``b`` writes, on the device."""
        cap = self.obs.shape[0]
        if b > cap:
            raise ValueError(f"a push of {b} transitions into a ring of {cap} "
                             f"slots would write a slot twice")
        return (self.ptr + torch.arange(b, device=self.ptr.device)) % cap

    @torch.no_grad()
    def push_batch(self, obs, action, reward, next_obs, done):
        b, cap = obs.shape[0], self.obs.shape[0]
        idx = self._slots(b)
        for name, value in zip(_FIELDS, (obs, action, reward, next_obs,
                                         done)):
            dst = getattr(self, name)
            dst.index_copy_(0, idx, value.to(dst.dtype))
        self.ptr.copy_((self.ptr + b) % cap)
        self.size.copy_(torch.clamp(self.size + b, max=cap))
        return self

    def gather(self, idx: torch.Tensor) -> dict:
        """The transitions at slots ``idx``."""
        return {k: getattr(self, k)[idx] for k in _FIELDS}

    def sample(self, gen, batch_size: int,
               idx: Optional[torch.Tensor] = None) -> dict:
        """``batch_size`` transitions drawn uniformly from the written slots
        (all of slot 0 while the buffer is empty) by a device generator, or
        at the given slots ``idx``."""
        if idx is None:
            idx = randint(gen, torch.clamp(self.size, min=1), (batch_size,),
                          self.size.device)
        return self.gather(idx)


@dataclass
class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritised replay: priority ~ |TD error|^alpha,
    importance weights (N p_i)^-beta normalised by their maximum."""

    priority: torch.Tensor   # [S] float32, 0 on slots never written

    @classmethod
    def create(cls, capacity: int, obs_dim: int, device=None):
        arrays = cls._arrays(capacity, obs_dim, device)
        return cls(**arrays, priority=torch.zeros(
            capacity, device=arrays["obs"].device))

    @torch.no_grad()
    def push_batch(self, obs, action, reward, next_obs, done):
        """New transitions enter at the current maximum priority (at least
        1), so each is sampled at least once in expectation."""
        idx = self._slots(obs.shape[0])
        p_new = torch.clamp(self.priority.max(), min=1.0)
        self.priority.index_copy_(0, idx, p_new.expand(obs.shape[0]))
        return super().push_batch(obs, action, reward, next_obs, done)

    def sample(self, gen, batch_size: int, alpha: float, beta: float,
               gumbel: Optional[torch.Tensor] = None):
        """(batch, slots, importance weights). The slots are the argmax of
        the masked log-priorities plus Gumbel noise [batch_size, S] (drawn
        from the device generator ``gen``, or given), as
        ``jax.random.categorical`` draws them."""
        cap = self.priority.shape[0]
        dev = self.priority.device
        valid = torch.arange(cap, device=dev) < self.size
        logits = torch.where(
            valid, alpha * torch.log(torch.clamp(self.priority, min=1e-12)),
            float("-inf"))
        if gumbel is None:
            u = torch.clamp(rand(gen, (batch_size, cap), dev), min=_TINY)
            gumbel = -torch.log(-torch.log(u))
        idx = torch.argmax(logits[None, :] + gumbel, dim=-1)
        probs = torch.softmax(logits, dim=0)
        n = torch.clamp(self.size, min=1).to(torch.float32)
        w = (n * torch.clamp(probs[idx], min=1e-12)) ** (-beta)
        w = w / torch.clamp(torch.max(w), min=1e-12)
        return self.gather(idx), idx, w

    @torch.no_grad()
    def update_priorities(self, idx, td_abs, eps: float):
        """priority[idx] = td_abs + eps. Where a slot repeats in ``idx`` the
        last write wins: a fixed rule, where XLA's scatter and
        ``index_put_`` on the card leave the winner unspecified."""
        cap = self.priority.shape[0]
        pos = torch.arange(idx.shape[0], device=idx.device)
        last = torch.full((cap,), -1, dtype=torch.int64, device=idx.device)
        last.scatter_reduce_(0, idx, pos, "amax")
        new = (td_abs + eps)[last.clamp(min=0)]
        self.priority.copy_(torch.where(last >= 0, new, self.priority))
        return self


@dataclass
class DQNState:
    params: Dict[str, torch.Tensor]          # the Q-net's, trained
    target_params: Dict[str, torch.Tensor]   # a copy, soft-updated
    opt: torch.optim.Optimizer
    buffer: ReplayBuffer
    env_state: EnvState
    obs: torch.Tensor
    generator: torch.Generator   # host generator: every draw starts here
    step: torch.Tensor           # 0-d int64: act+learn steps taken
    annealing_weight: torch.Tensor   # 0-d float32
    rl_perf_ema: torch.Tensor    # per-choice reward EMAs (0-d float32)
    heur_perf_ema: torch.Tensor


def heuristic_action(obs: torch.Tensor) -> torch.Tensor:
    """The cooling heuristic: reheat (multiplier 1.5) on a plateau, freeze
    (0.7) at high acceptance, else cool (0.9). int32 ladder indices."""
    acc = obs[..., 4]
    plateau_frac = obs[..., 8]
    cool = torch.full_like(acc, 3, dtype=torch.int32)
    reheat = torch.full_like(cool, 8)
    freeze = torch.full_like(cool, 1)
    return torch.where(plateau_frac > 0.5, reheat,
                       torch.where(acc > 0.6, freeze, cool))


def make_dqn(problem, env_cfg: EnvConfig, cfg: Optional[DQNConfig] = None,
             engine="auto"):
    """Returns (init_fn, act_and_learn, model). ``act_and_learn(state,
    draws=None)`` is ``act`` then ``learn`` (its attributes, with
    ``engine``) and returns (state, metrics), the metrics as 0-d device
    tensors. ``draws`` replaces the step's random numbers: "eps_u",
    "rand_a", "hyb_u" [B], "uniforms" [sweeps_per_step, B, Np] (the plain
    or blocked sweep), "reset_spins" [B, Np], and "sample_idx" [batch] or,
    with PER, "gumbel" [batch, S].

    ``engine``: "auto" builds ``env.default_engine``'s; or pass a sweep
    engine; None is the blocked sweep in plain PyTorch, for a problem on the
    CPU only. The env count may not exceed the buffer: one push would write
    a slot twice."""
    cfg = cfg or DQNConfig()
    if env_cfg.n_envs > cfg.buffer_size:
        raise ValueError(f"n_envs {env_cfg.n_envs} exceeds buffer_size "
                         f"{cfg.buffer_size}: one push would write a slot "
                         f"twice")
    if engine == "auto":
        engine = env_mod.default_engine(problem, env_cfg)
    dev = problem.device
    b = env_cfg.n_envs
    model = QNetwork(env_mod.obs_dim(problem, env_cfg),
                     n_actions=env_mod.N_ACTIONS,
                     hidden_sizes=cfg.hidden_sizes).to(dev)
    buffer_cls = (PrioritizedReplayBuffer if cfg.prioritized_replay
                  else ReplayBuffer)

    def init_fn(generator: Optional[torch.Generator] = None) -> DQNState:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        env_state, obs = env_mod.reset(problem, env_cfg, generator, engine)
        params = init_params(model, generator, dev)
        with torch.no_grad():   # a copy: the soft update must not alias
            target = {n: p.detach().clone() for n, p in params.items()}

        def scalar(value, dtype=torch.float32):
            return torch.full((), value, dtype=dtype, device=dev)

        return DQNState(
            params=params, target_params=target,
            opt=make_optimizer(cfg, params),
            buffer=buffer_cls.create(cfg.buffer_size, obs.shape[1], dev),
            env_state=env_state, obs=obs, generator=generator,
            step=scalar(0, torch.int64),
            annealing_weight=scalar(cfg.annealing_weight),
            rl_perf_ema=scalar(0.0), heur_perf_ema=scalar(0.0))

    def epsilon(step):
        frac = torch.clamp(step / cfg.epsilon_decay_steps, 0.0, 1.0)
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    @torch.no_grad()
    def act(state: DQNState, draws: Optional[dict] = None):
        """The hybrid decision, one env step, the push, ``auto_reset`` and
        the weight's adaptation. Returns (state, reward)."""
        draws = draws or {}
        gen = state.generator
        if "eps_u" in draws:
            eps_u, rand_a, hyb_u = (draws[k] for k in ("eps_u", "rand_a",
                                                       "hyb_u"))
        else:
            g = device_generator(gen, dev)
            eps_u = rand(g, (b,), dev)
            rand_a = randint(g, env_mod.N_ACTIONS, (b,), dev)
            hyb_u = rand(g, (b,), dev)
        q = functional_call(model, state.params, (state.obs,))
        greedy = torch.argmax(q, dim=-1)
        rl_action = torch.where(eps_u < epsilon(state.step), rand_a.long(),
                                greedy)
        use_heur = hyb_u < state.annealing_weight
        action = torch.where(use_heur, heuristic_action(state.obs).long(),
                             rl_action).to(torch.int32)

        env_state, next_obs, reward, done = env_mod.step(
            problem, env_cfg, state.env_state, action, gen, engine,
            uniforms=draws.get("uniforms"))
        buffer = state.buffer.push_batch(state.obs, action, reward, next_obs,
                                         done)
        env_state, obs = env_mod.auto_reset(problem, env_cfg, env_state, gen,
                                            engine, draws.get("reset_spins"))

        # the weight follows the per-choice reward EMAs, per step
        use_rl = ~use_heur
        rl_r = torch.sum(torch.where(use_rl, reward, 0.0)) / torch.clamp(
            torch.sum(use_rl), min=1)
        h_r = torch.sum(torch.where(use_heur, reward, 0.0)) / torch.clamp(
            torch.sum(use_heur), min=1)
        rl_ema = 0.99 * state.rl_perf_ema + 0.01 * rl_r
        h_ema = 0.99 * state.heur_perf_ema + 0.01 * h_r
        w = state.annealing_weight + cfg.weight_adapt_rate * torch.sign(
            h_ema - rl_ema) * 0.01
        w = torch.clamp(w, 0.05, 0.95)
        state = dataclasses.replace(
            state, buffer=buffer, env_state=env_state, obs=obs,
            annealing_weight=w, rl_perf_ema=rl_ema, heur_perf_ema=h_ema)
        return state, reward

    def learn(state: DQNState, reward, draws: Optional[dict] = None):
        """One importance-weighted TD step on a sample of the buffer, the new
        priorities (PER), Adam and the soft target update. Returns (state,
        metrics)."""
        draws = draws or {}
        buffer = state.buffer
        if cfg.prioritized_replay:
            g = (None if "gumbel" in draws
                 else device_generator(state.generator, dev))
            batch, idx, is_w = buffer.sample(
                g, cfg.batch_size, cfg.per_alpha, cfg.per_beta,
                gumbel=draws.get("gumbel"))
        else:
            g = (None if "sample_idx" in draws
                 else device_generator(state.generator, dev))
            batch = buffer.sample(g, cfg.batch_size,
                                  idx=draws.get("sample_idx"))
            is_w = torch.ones(cfg.batch_size, device=dev)
        opt = state.opt
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            q_next = functional_call(model, state.target_params,
                                     (batch["next_obs"],))
            target = batch["reward"] + cfg.gamma * torch.max(
                q_next, dim=-1).values * (1.0 - batch["done"].to(torch.float32))
        qs = functional_call(model, state.params, (batch["obs"],))
        q_sel = torch.gather(qs, 1, batch["action"].long()[:, None])[:, 0]
        td = q_sel - target
        loss = torch.mean(is_w * td ** 2)
        loss.backward()
        if cfg.prioritized_replay:
            buffer.update_priorities(idx, td.detach().abs(), cfg.per_eps)
        opt.step()
        with torch.no_grad():
            names = list(state.target_params)
            tgt = [state.target_params[n] for n in names]
            torch._foreach_mul_(tgt, 1 - cfg.tau)
            torch._foreach_add_(tgt, torch._foreach_mul(
                [state.params[n].detach() for n in names], cfg.tau))
            metrics = dict(loss=loss.detach(), mean_reward=torch.mean(reward),
                           epsilon=epsilon(state.step),
                           annealing_weight=state.annealing_weight,
                           mean_best_energy=torch.mean(
                               state.env_state.best_energy))
        return dataclasses.replace(state, step=state.step + 1), metrics

    def act_and_learn(state: DQNState, draws: Optional[dict] = None):
        state, reward = act(state, draws)
        return learn(state, reward, draws)

    act_and_learn.act, act_and_learn.learn = act, learn
    act_and_learn.engine = engine
    return init_fn, act_and_learn, model


class CapturedSteps(graphs.CapturedLearner):
    """``act_and_learn`` (``make_dqn``'s eager step) captured once on
    ``state`` and replayed (``graphs.CapturedLearner``): each step writes
    its metrics (``METRIC_KEYS``) into the step's [k, m] history, so k steps
    replay between two reads (``read``). The warm-up runs on the run's own
    parameters and optimizer and on a throwaway copy of the rest (the target
    parameters, the buffer, the env state, the counters, the generator),
    and puts the parameters and Adam's state back as they were. ``state``
    is the captured ``DQNState``: its ``step`` counts on the device."""

    def __init__(self, act_and_learn, state: DQNState, k: int = 1):
        super().__init__(act_and_learn, state, METRIC_KEYS, k)


def _keystr(name: str) -> str:
    """The key the JAX package's ``save_params`` gives the port parameter
    ``name`` (``jax.tree_util.keystr`` of its flax path)."""
    return "".join(f"['{k}']" for k in flax_path(name))


def save_params(params: Dict[str, torch.Tensor], path: str) -> None:
    """A flat ``.npz`` of the parameters in the JAX package's format: the
    flax path's ``keystr`` as the key, ``Dense`` kernels [in, out]."""
    arrays = {}
    for name, p in params.items():
        a = p.detach().cpu().numpy()
        arrays[_keystr(name)] = a.T if flax_transposed(name) else a
    np.savez(path, **arrays)


def load_params(template: Dict[str, torch.Tensor], path: str
                ) -> Dict[str, torch.Tensor]:
    """The parameters of ``template``'s names, shapes and devices read
    from a ``save_params`` file of either package."""
    out = {}
    with np.load(path) as z:
        for name, t in template.items():
            a = z[_keystr(name)]
            if flax_transposed(name):
                a = a.T
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{_keystr(name)} {a.shape} in {path} does "
                                 f"not fit {name} {tuple(t.shape)}")
            out[name] = torch.tensor(np.ascontiguousarray(a), dtype=t.dtype,
                                     device=t.device
                                     ).requires_grad_(t.requires_grad)
    return out
