"""A plain PPO learning phase in float64: the reference that follows the
program's first updates.

The rollout's sweeps draw their randomness inside the program's kernels, so
no plain implementation can replay them: the reference takes each rollout
as the environment produced it (observations, actions, rewards, done flags,
the last observation) and the minibatch permutations the program drew, and
works out the rest itself: the old log-probabilities and values from its own
parameters, generalised advantage estimation, the clipped-surrogate loss of
each minibatch with its advantages normalised, the gradients (autograd),
the clip of their global norm and the Adam step.

The network is the discrete-action actor-critic of the configuration:
tanh hidden layers, a value head and a logits head, its parameters a dict
named as the program names them ("dense.0.weight", ...).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Hyper:
    lr: float
    gamma: float
    gae_lambda: float
    clip_eps: float
    entropy_coef: float
    value_coef: float
    n_epochs: int
    n_minibatches: int
    max_grad_norm: float
    n_hidden: int
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


def forward(params: dict, obs: torch.Tensor, n_hidden: int):
    """(logits, value) of the actor-critic."""
    x = obs
    for k in range(n_hidden):
        x = torch.tanh(x @ params[f"dense.{k}.weight"].T
                       + params[f"dense.{k}.bias"])
    value = (x @ params[f"dense.{n_hidden}.weight"].T
             + params[f"dense.{n_hidden}.bias"])[..., 0]
    logits = (x @ params[f"dense.{n_hidden + 1}.weight"].T
              + params[f"dense.{n_hidden + 1}.bias"])
    return logits, value


def gae(h: Hyper, reward, value, done, last_value):
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    advs = [None] * reward.shape[0]
    for t in range(reward.shape[0] - 1, -1, -1):
        nonterm = 1.0 - done[t].to(reward.dtype)
        delta = reward[t] + h.gamma * v_next * nonterm - value[t]
        adv_next = delta + h.gamma * h.gae_lambda * nonterm * adv_next
        v_next = value[t]
        advs[t] = adv_next
    advs = torch.stack(advs)
    return advs, advs + value


def loss(h: Hyper, params: dict, obs, action, logp_old, adv, ret):
    """(total loss, policy loss, value loss, entropy) of one minibatch."""
    logits, value = forward(params, obs, h.n_hidden)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, action[..., None])[..., 0]
    ratio = torch.exp(logp - logp_old)
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    policy = -torch.mean(torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - h.clip_eps, 1 + h.clip_eps) * adv))
    value_loss = torch.mean((value - ret) ** 2)
    entropy = torch.mean(-torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    total = policy + h.value_coef * value_loss - h.entropy_coef * entropy
    return total, policy, value_loss, entropy


def learn(h: Hyper, params: dict, adam: dict, rollout: dict) -> dict:
    """One learning phase on ``rollout`` from ``params`` and the Adam state
    ``adam`` ({"step": int, "m": {name: tensor}, "v": {...}}); the tensors
    are float64 on one device. Returns the new parameters and Adam state,
    the mean of the minibatch losses (``METRICS``) and the first moment's
    per-leaf norms."""
    params = {k: v.detach().clone() for k, v in params.items()}
    m = {k: v.clone() for k, v in adam["m"].items()}
    v = {k: x.clone() for k, x in adam["v"].items()}
    step = int(adam["step"])
    obs, action = rollout["obs"], rollout["action"]
    with torch.no_grad():
        logits, value = forward(params, obs, h.n_hidden)
        logp_old = torch.gather(torch.log_softmax(logits, -1), -1,
                                action[..., None])[..., 0]
        _, last_value = forward(params, rollout["last_obs"], h.n_hidden)
        advs, rets = gae(h, rollout["reward"], value, rollout["done"],
                         last_value)
    t, b = advs.shape
    flat = {"obs": obs.reshape(t * b, -1), "action": action.reshape(-1),
            "logp": logp_old.reshape(-1), "adv": advs.reshape(-1),
            "ret": rets.reshape(-1)}
    parts = []
    perms = rollout["perms"]
    for epoch in range(h.n_epochs):
        for idx in perms[epoch].reshape(h.n_minibatches, -1):
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            total, pol, val, ent = loss(
                h, leaves, flat["obs"][idx], flat["action"][idx],
                flat["logp"][idx], flat["adv"][idx], flat["ret"][idx])
            grads = dict(zip(leaves, torch.autograd.grad(
                total, list(leaves.values()))))
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(h.max_grad_norm / (norm + 1e-6), max=1.0)
            step += 1
            bc1 = 1 - h.beta1 ** step
            bc2 = 1 - h.beta2 ** step
            with torch.no_grad():
                for k in params:
                    g = grads[k] * scale
                    m[k] = h.beta1 * m[k] + (1 - h.beta1) * g
                    v[k] = h.beta2 * v[k] + (1 - h.beta2) * g * g
                    params[k] = params[k] - h.lr / bc1 * m[k] / (
                        torch.sqrt(v[k]) / bc2 ** 0.5 + h.eps)
            parts.append(torch.stack([total, pol, val, ent]).detach())
    mean = torch.stack(parts).mean(0)
    return {"params": params, "adam": {"step": step, "m": m, "v": v},
            "loss": float(mean[0]), "policy_loss": float(mean[1]),
            "value_loss": float(mean[2]), "entropy": float(mean[3])}
