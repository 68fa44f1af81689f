"""PPO controller over the vectorised annealer environment.

The counterpart of ``spinglass_tpu.rl.ppo``: an actor-learner on the
problem's device. A rollout is a Python loop of env steps under
``torch.no_grad()`` that never waits for the device; GAE, the
clipped-surrogate loss and the Adam steps follow on the same device.
``make_ppo``'s ``update_fn`` is the eager update; ``train`` replays it
captured as one CUDA graph per update (``CapturedUpdates``), and the host
reads the device once per ``updates_per_dispatch`` updates, for the
metrics.

Action modes:
  discrete   - categorical over the temperature-multiplier ladder
  continuous - diagonal Gaussian over [temp_mult, sweep_frac]
  hybrid     - categorical temp_index + Gaussian sweep_frac (a dict action)

The env's sweeps run through ``anneal.engines.make_engine``'s engine (the
fused dense kernel on the card, the sorted sparse engines for an
``EllProblem``) unless an explicit ``engine`` is passed.

The network's parameters are a dict of tensors named as the module names
them ("dense.0.weight", ..., "log_std"); ``model`` is called on them through
``torch.func.functional_call``, as the JAX package applies its module to a
parameter tree. ``core.convert.actor_critic_from_flax`` carries a flax tree
across.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from spinglass_tpu_torch.anneal import graphs
from spinglass_tpu_torch.core.rng import (device_generator, rand, randn,
                                          randperm)
from spinglass_tpu_torch.kernels import build
from spinglass_tpu_torch.rl import env as env_mod
from spinglass_tpu_torch.rl.env import EnvConfig, EnvState

_LOG2PI = math.log(2.0 * math.pi)
# a standard normal cut at +-2 has this deviation; LeCun's initialiser
# divides by it so that the cut weights keep variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class PPOConfig:
    hidden_sizes: Tuple[int, ...] = (128, 128)
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    rollout_len: int = 16
    n_epochs: int = 4
    n_minibatches: int = 4
    max_grad_norm: float = 0.5
    n_updates: int = 50
    updates_per_dispatch: int = 1   # updates replayed between two metrics
    # reads in ``train`` (the JAX package scans this many in one dispatch):
    # each writes its metrics into a [k, m] buffer on the device
    seed: int = 0


class ActorCritic(nn.Module):
    """MLP trunk, value head, and the policy head(s) of the action mode.

    ``dense[k]`` is the flax module's ``Dense_k``: the hidden layers, then
    the value head, then the policy heads (hybrid: logits, then the sweep
    fraction's mean). continuous and hybrid carry a state-independent
    ``log_std`` parameter (-0.7 at start); the means are squashed to the
    env's valid ranges by a scaled tanh, so the env's clipping hides no
    probability mass. The constructor leaves the weights as ``nn.Linear``
    made them: ``init_params`` draws the LeCun-normal start the JAX package
    uses."""

    def __init__(self, obs_dim: int, action_mode: str = "discrete",
                 n_actions: int = env_mod.N_ACTIONS,
                 hidden_sizes: Tuple[int, ...] = (128, 128)):
        super().__init__()
        heads = {"discrete": (n_actions,), "continuous": (2,),
                 "hybrid": (n_actions, 1)}
        if action_mode not in heads:
            raise ValueError(action_mode)
        self.action_mode = action_mode
        self.n_hidden = len(hidden_sizes)
        widths = [obs_dim, *hidden_sizes]
        trunk = widths[-1]
        layers = [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])]
        layers.append(nn.Linear(trunk, 1))
        layers += [nn.Linear(trunk, w) for w in heads[action_mode]]
        self.dense = nn.ModuleList(layers)
        if action_mode != "discrete":
            self.log_std = nn.Parameter(
                torch.full((heads[action_mode][-1],), -0.7))

    def forward(self, obs):
        x = obs
        for layer in self.dense[:self.n_hidden]:
            x = torch.tanh(layer(x))
        value = self.dense[self.n_hidden](x)[..., 0]
        head = self.dense[self.n_hidden + 1](x)
        if self.action_mode == "discrete":
            return {"logits": head}, value
        if self.action_mode == "continuous":
            # temp_mult in [0.5, 2.0], sweep_frac in [0.1, 1.0]
            mean = torch.stack([1.25 + 0.75 * torch.tanh(head[..., 0]),
                                0.55 + 0.45 * torch.tanh(head[..., 1])],
                               dim=-1)
            return {"mean": mean,
                    "log_std": self.log_std.expand(mean.shape)}, value
        raw = self.dense[self.n_hidden + 2](x)
        mean = 0.55 + 0.45 * torch.tanh(raw[..., 0])
        return {"logits": head, "mean": mean,
                "log_std": self.log_std.expand(mean.shape)}, value


def init_params(model: ActorCritic, generator: torch.Generator,
                device=None) -> Dict[str, torch.Tensor]:
    """A fresh parameter dict for ``model`` as flax initialises ``Dense``
    and ``LayerNorm``: kernels LeCun-normal (a normal of variance 1 / fan_in
    cut at two deviations), biases zero, ``log_std`` -0.7, LayerNorm scales
    1 (as ``nn.LayerNorm`` makes them). Drawn from the host ``generator``;
    the tensors lie on ``device`` (None: the model's) and require
    gradients."""
    params = {}
    for name, p in model.named_parameters():
        if name.endswith("weight") and p.ndim == 2:
            std = math.sqrt(1.0 / p.shape[1]) / _TRUNC_STD
            # inverse-CDF draw of a normal cut at +-2 deviations
            lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
                      for x in (-2.0, 2.0))
            u = torch.rand(p.shape, generator=generator) * (hi - lo) + lo
            value = torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)
            value = value.clamp(-2.0 * std, 2.0 * std)
        elif name.endswith("bias"):
            value = torch.zeros(p.shape)
        else:
            value = p.detach().clone()
        params[name] = value.to(device if device is not None else p.device
                                ).requires_grad_(True)
    return params


def _gauss_logp(mean, log_std, x):
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * ((x - mean) ** 2 / var + 2.0 * log_std + _LOG2PI),
                     dim=-1)


def _gauss_entropy(log_std):
    return torch.sum(log_std + 0.5 * (_LOG2PI + 1.0), dim=-1)


def _categorical(logits, gen):
    """A categorical draw by the Gumbel-max trick, on the logits' device."""
    u = rand(gen, logits.shape, logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def _categorical_logp(logits, index):
    return torch.gather(torch.log_softmax(logits, dim=-1), -1,
                        index.long()[..., None])[..., 0]


def _categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def make_policy(action_mode: str):
    """(sample, log_prob, entropy) for the mode; the actions are what
    ``env._decode_action`` expects. ``sample(dist, generator)`` draws on the
    distribution's device from a generator there seeded by one draw of the
    host ``generator``."""
    if action_mode == "discrete":
        def sample(dist, generator):
            logits = dist["logits"]
            return _categorical(logits, device_generator(generator,
                                                         logits.device))

        def log_prob(dist, action):
            return _categorical_logp(dist["logits"], action)

        def entropy(dist):
            return _categorical_entropy(dist["logits"])

        return sample, log_prob, entropy

    if action_mode == "continuous":
        def sample(dist, generator):
            mean = dist["mean"]
            eps = randn(device_generator(generator, mean.device), mean.shape,
                        mean.device)
            return mean + torch.exp(dist["log_std"]) * eps

        def log_prob(dist, action):
            return _gauss_logp(dist["mean"], dist["log_std"], action)

        def entropy(dist):
            return _gauss_entropy(dist["log_std"])

        return sample, log_prob, entropy

    if action_mode == "hybrid":
        def sample(dist, generator):
            mean = dist["mean"]
            gen = device_generator(generator, mean.device)
            idx = _categorical(dist["logits"], gen)
            eps = randn(gen, mean.shape, mean.device)
            return {"temp_index": idx,
                    "sweep_frac": mean + torch.exp(dist["log_std"]) * eps}

        def log_prob(dist, action):
            logp_c = _gauss_logp(dist["mean"][..., None],
                                 dist["log_std"][..., None],
                                 action["sweep_frac"][..., None])
            return _categorical_logp(dist["logits"],
                                     action["temp_index"]) + logp_c

        def entropy(dist):
            return (_categorical_entropy(dist["logits"])
                    + _gauss_entropy(dist["log_std"][..., None]))

        return sample, log_prob, entropy

    raise ValueError(action_mode)


def gae(cfg: PPOConfig, reward, value, done, last_value):
    """Generalised advantage estimation over a [T, B] rollout; returns
    (advantages, returns), both [T, B]."""
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    advs = [None] * reward.shape[0]
    for t in range(reward.shape[0] - 1, -1, -1):
        nonterm = 1.0 - done[t].to(torch.float32)
        delta = reward[t] + cfg.gamma * v_next * nonterm - value[t]
        adv_next = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
        v_next = value[t]
        advs[t] = adv_next
    advs = torch.stack(advs)
    return advs, advs + value


def ppo_loss(cfg: PPOConfig, model: ActorCritic, params, batch, log_prob,
             entropy_fn):
    """The clipped-surrogate loss of one minibatch and its three parts.
    Advantages are normalised over the minibatch with the population
    deviation (divides by the count)."""
    dist, value = functional_call(model, params, (batch["obs"],))
    logp = log_prob(dist, batch["action"])
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    policy_loss = -torch.mean(torch.minimum(unclipped, clipped))
    value_loss = torch.mean((value - batch["ret"]) ** 2)
    entropy = torch.mean(entropy_fn(dist))
    loss = (policy_loss + cfg.value_coef * value_loss
            - cfg.entropy_coef * entropy)
    return loss, dict(policy_loss=policy_loss, value_loss=value_loss,
                      entropy=entropy)


def make_optimizer(cfg: PPOConfig, params) -> torch.optim.Adam:
    """Adam as the JAX package's optax chain sets it (eps 1e-8); the clip to
    ``max_grad_norm`` comes before each step (``minibatch_step``). On the
    card it is built ``capturable``: its step count stays on the device, so
    the captured update and the eager one run the same step."""
    params = list(params.values())
    return torch.optim.Adam(params, lr=cfg.lr, eps=1e-8,
                            capturable=params[0].is_cuda)


def minibatch_step(cfg: PPOConfig, model, params, opt, batch, log_prob,
                   entropy_fn):
    """One clipped-gradient Adam step on ``batch``; returns the loss parts.
    ``clip_grad_norm_`` scales by max_norm / (norm + 1e-6) capped at 1 where
    optax scales by max_norm / max(norm, max_norm): equal to ~1e-6
    relative."""
    opt.zero_grad(set_to_none=True)
    loss, aux = ppo_loss(cfg, model, params, batch, log_prob, entropy_fn)
    loss.backward()
    nn.utils.clip_grad_norm_(list(params.values()), cfg.max_grad_norm)
    opt.step()
    return {k: v.detach() for k, v in aux.items()}


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt: torch.optim.Optimizer
    env_state: EnvState
    obs: torch.Tensor
    generator: torch.Generator   # host generator: every draw starts here
    update: int


def _tree(fn, x):
    """``fn`` on a tensor, or on each tensor of a dict action."""
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _stack(items):
    if isinstance(items[0], dict):
        return {k: torch.stack([x[k] for x in items]) for k in items[0]}
    return torch.stack(items)


def make_ppo(problem, env_cfg: EnvConfig, cfg: Optional[PPOConfig] = None,
             engine="auto"):
    """Returns (init_fn, update_fn, model). ``update_fn(state)`` is one PPO
    iteration, ``update_fn.rollout`` then ``update_fn.learn``: the rollout
    with auto-reset, GAE, and ``n_epochs`` passes of ``n_minibatches``
    clipped updates. It returns (state, metrics), the metrics as 0-d device
    tensors.

    ``engine``: "auto" builds ``env.default_engine``'s; or pass a sweep
    engine; None is the blocked sweep in plain PyTorch, for a problem on the
    CPU only (the env raises on it for a problem on the card)."""
    cfg = cfg or PPOConfig()
    if engine == "auto":
        engine = env_mod.default_engine(problem, env_cfg)
    dev = problem.device
    model = ActorCritic(env_mod.obs_dim(problem, env_cfg),
                        action_mode=env_cfg.action_mode,
                        n_actions=env_mod.N_ACTIONS,
                        hidden_sizes=cfg.hidden_sizes).to(dev)
    sample_a, log_prob, entropy_fn = make_policy(env_cfg.action_mode)

    def init_fn(generator: Optional[torch.Generator] = None) -> TrainState:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        env_state, obs = env_mod.reset(problem, env_cfg, generator, engine)
        params = init_params(model, generator, dev)
        return TrainState(params=params, opt=make_optimizer(cfg, params),
                          env_state=env_state, obs=obs, generator=generator,
                          update=0)

    @torch.no_grad()
    def rollout(state: TrainState):
        env_state, obs, gen = state.env_state, state.obs, state.generator
        steps = []
        for _ in range(cfg.rollout_len):
            dist, value = functional_call(model, state.params, (obs,))
            action = sample_a(dist, gen)
            logp = log_prob(dist, action)
            env_state, _, reward, done = env_mod.step(
                problem, env_cfg, env_state, action, gen, engine)
            env_state, next_obs = env_mod.auto_reset(
                problem, env_cfg, env_state, gen, engine)
            steps.append(dict(obs=obs, action=action, logp=logp, value=value,
                              reward=reward, done=done))
            obs = next_obs
        traj = {k: _stack([s[k] for s in steps]) for k in steps[0]}
        _, last_value = functional_call(model, state.params, (obs,))
        state = TrainState(params=state.params, opt=state.opt,
                           env_state=env_state, obs=obs, generator=gen,
                           update=state.update)
        return state, traj, last_value

    def learn(state: TrainState, traj, last_value):
        advs, rets = gae(cfg, traj["reward"], traj["value"], traj["done"],
                         last_value)
        t, b = advs.shape

        def flat(x):
            return x.reshape((t * b,) + x.shape[2:])

        data = dict(obs=flat(traj["obs"]), action=_tree(flat, traj["action"]),
                    logp=flat(traj["logp"]), adv=flat(advs), ret=flat(rets))
        gen = device_generator(state.generator, dev)
        aux = []
        for _ in range(cfg.n_epochs):
            perm = randperm(t * b, gen, dev)
            for idx in perm.reshape(cfg.n_minibatches, -1):
                batch = {k: _tree(lambda x: x[idx], v)
                         for k, v in data.items()}
                aux.append(minibatch_step(cfg, model, state.params, state.opt,
                                          batch, log_prob, entropy_fn))
        metrics = dict(
            mean_reward=torch.mean(traj["reward"]),
            mean_best_energy=torch.mean(state.env_state.best_energy),
            **{k: torch.mean(torch.stack([a[k] for a in aux]))
               for k in ("policy_loss", "value_loss", "entropy")})
        state.update += 1
        return state, metrics

    def update_fn(state: TrainState):
        return learn(*rollout(state))

    update_fn.rollout, update_fn.learn = rollout, learn
    update_fn.engine = engine
    return init_fn, update_fn, model


METRIC_KEYS = ("mean_reward", "mean_best_energy", "policy_loss", "value_loss",
               "entropy")


class CapturedUpdates(graphs.CapturedLearner):
    """``update_fn`` (``make_ppo``'s eager update) captured once on
    ``state`` and replayed (``graphs.CapturedLearner``): each update writes
    its metrics (``METRIC_KEYS``) into the step's [k, m] history, so k
    updates replay between two reads (``read``). The warm-up runs on the
    run's own parameters and optimizer, with a throwaway env state and
    generator, and puts them back as they were. ``state`` is the captured
    ``TrainState`` (its ``update`` counts replays)."""

    def __init__(self, update_fn, state: TrainState, k: int = 1):
        super().__init__(update_fn, state, METRIC_KEYS, k)

    def replay(self) -> None:
        """One PPO update."""
        super().replay()
        self.state.update += 1


@graphs.serialized
def train(problem, env_cfg: Optional[EnvConfig] = None,
          cfg: Optional[PPOConfig] = None, verbose: bool = False,
          engine="auto", resume_state: Optional[TrainState] = None) -> dict:
    """Full training loop; returns the parameters and the per-update metric
    history. ``resume_state`` continues from an earlier ``TrainState``.

    The update is captured (``CapturedUpdates``) and replayed;
    ``cfg.updates_per_dispatch`` = k replays k updates between two reads of
    the metrics, as the JAX package scans k updates in one dispatch: the
    remainder of n_updates over k runs first as single updates, each update
    of a k-block gets the block's wall time over k, and the steady-state
    rate leaves out the remainder and the first block (k = 1: the first two
    updates). The capture counts in the first update's time, where the JAX
    package compiles. The reads wait for the device, so the times are honest
    wall times. ``kernel_launches`` are this call's."""
    env_cfg = env_cfg or EnvConfig()
    cfg = cfg or PPOConfig()
    launches0 = build.launch_snapshot()
    init_fn, update_fn, model = make_ppo(problem, env_cfg, cfg, engine)
    state = resume_state if resume_state is not None else init_fn()
    start = int(state.update)
    history = []
    update_times = []
    n_run = max(cfg.n_updates - start, 0)
    kd = max(1, cfg.updates_per_dispatch)
    t0 = time.perf_counter()
    captured = CapturedUpdates(update_fn, state, kd)
    state = captured.state
    rem = n_run % kd if kd > 1 else 0
    u = 0
    while u < n_run:
        n = kd if kd > 1 and u >= rem else 1
        t_u = time.perf_counter() if u else t0   # the capture in update 0
        for _ in range(n):
            captured.replay()
        step_metrics = captured.read(n)   # waits for the device
        dt = time.perf_counter() - t_u
        history.extend(step_metrics)
        update_times.extend([dt / n] * n)
        u += n
        if verbose and (u % 10 < n or u >= n_run):
            print(f"update {start + u - 1}: {history[-1]}")
    total = time.perf_counter() - t0
    n_warm = min(rem + kd if kd > 1 else 2, max(n_run - 1, 0))
    steady = sum(update_times[n_warm:])
    env_steps = n_run * cfg.rollout_len * env_cfg.n_envs
    steady_steps = max(n_run - n_warm, 1) * cfg.rollout_len * env_cfg.n_envs
    try:  # prometheus gauges (host values only: no read of the device)
        from spinglass_tpu_torch.utils.metrics_exporter import (
            publish_rl_metrics)

        publish_rl_metrics(
            steady_steps / steady if steady > 0 else 0.0,
            history[-1]["mean_best_energy"] if history else float("nan"))
    except Exception:  # metrics must never break a run
        pass
    return {
        "params": state.params,
        "state": state,
        "history": history,
        # steady-state rate (the first two updates' warm-up left out)
        "env_steps_per_second": steady_steps / steady if steady > 0 else 0.0,
        "env_steps_per_second_incl_compile": env_steps / total
        if total > 0 else 0.0,
        "total_time": total,
        "update_times": update_times,
        "n_warmup": n_warm,   # the updates the steady-state rate leaves out
        "final_mean_best_energy": history[-1]["mean_best_energy"]
        if history else float("nan"),
        "engine": getattr(update_fn.engine, "name", None),
        "kernel_launches": build.launches_since(
            launches0, getattr(update_fn.engine, "kernel_names", ())),
    }
