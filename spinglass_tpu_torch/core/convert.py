"""Carry problems and annealing state across from the JAX package.

The caller turns the JAX arrays into numpy (``np.asarray``) and passes them
here, so this module needs no JAX. Tests use it to make both packages anneal
the identical instance (dense or ELL) from the identical SA or PT state.
Like the problem constructors, everything here builds on the card unless the
caller names a device (``core.problem.resolve_device``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spinglass_tpu_torch.core.problem import IsingProblem, resolve_device


def problem_from_numpy(j, h, active_mask, n_spins: int,
                       device=None) -> IsingProblem:
    """Port problem from a JAX ``IsingProblem``'s padded arrays, unchanged
    (no second symmetrisation or padding)."""
    device = resolve_device(device)
    j = np.asarray(j, np.float32)
    if j.ndim != 2 or j.shape[0] != j.shape[1]:
        raise ValueError(f"J must be square, got {j.shape}")
    return IsingProblem(
        j=torch.tensor(j, device=device),
        h=torch.tensor(np.asarray(h, np.float32), device=device),
        active_mask=torch.tensor(np.asarray(active_mask, np.float32),
                                 device=device),
        n_spins=int(n_spins),
    )


def ell_from_numpy(idx, val, h, active_mask, n_spins: int, device=None):
    """Port ``EllProblem`` from a JAX ``EllProblem``'s arrays, unchanged."""
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    device = resolve_device(device)

    def t(x, dtype):
        return torch.tensor(np.asarray(x, dtype), device=device)

    return EllProblem(idx=t(idx, np.int32), val=t(val, np.float32),
                      h=t(h, np.float32), active_mask=t(active_mask, np.float32),
                      n_spins=int(n_spins))


def _in_layout(x, src_layout: str, layout: str, device,
               dtype=np.float32) -> torch.Tensor:
    for lay in (src_layout, layout):
        if lay not in ("rn", "nr"):
            raise ValueError(f"unknown spin layout {lay!r}")
    t = torch.tensor(np.asarray(x, dtype), device=device)
    if src_layout != layout:
        t = t.t()
    return t.contiguous()


def sa_state_from_numpy(spins, energy, best_energy, best_spins, temp,
                        acc_ema, sweep: int, acc_rate=None, *,
                        src_layout: str = "rn", layout: str = "rn",
                        device=None,
                        generator: Optional[torch.Generator] = None):
    """Port ``SAState`` from a JAX ``SAState``'s arrays.

    ``spins``/``best_spins`` arrive in ``src_layout`` (the JAX engine's:
    "rn" = [R, Np], "nr" = [Np, R]) and are stored in ``layout`` (the port
    engine's). The JAX PRNG key has no torch counterpart: the state gets
    ``generator``, or a new CPU generator seeded with 0.
    """
    from spinglass_tpu_torch.anneal.sa import SAState
    from spinglass_tpu_torch.anneal.schedules import ScheduleState

    device = resolve_device(device)

    def vec(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    energy = vec(energy)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return SAState(
        spins=_in_layout(spins, src_layout, layout, device),
        energy=energy,
        best_energy=vec(best_energy),
        best_spins=_in_layout(best_spins, src_layout, layout, device),
        sched=ScheduleState(temp=vec(temp).reshape(()),
                            acc_ema=vec(acc_ema).reshape(())),
        generator=generator,
        sweep=int(sweep),
        acc_rate=(torch.zeros_like(energy) if acc_rate is None
                  else vec(acc_rate)),
    )


def pt_state_from_numpy(spins, slot, energy, best_energy, best_spins,
                        sweep: int, exch_attempts, exch_accepts,
                        acc_rate=None, *, src_layout: str = "rn",
                        layout: str = "rn", spin_dtype=np.float32,
                        device=None,
                        generator: Optional[torch.Generator] = None):
    """Port ``PTState`` from a JAX ``PTState``'s arrays.

    Layouts as in ``sa_state_from_numpy``; a sorted [NS, R] state of the
    transposed sparse engine is "nr" on both sides. ``spin_dtype`` is the
    port engine's (int8 for the sparse engine's threshold path). The state
    gets ``generator``, or a new CPU generator seeded with 0."""
    from spinglass_tpu_torch.anneal.pt import PTState

    device = resolve_device(device)

    def vec(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=device)

    energy = vec(energy)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return PTState(
        spins=_in_layout(spins, src_layout, layout, device, spin_dtype),
        slot=vec(slot, np.int32),
        energy=energy,
        best_energy=vec(best_energy),
        best_spins=_in_layout(best_spins, src_layout, layout, device,
                              spin_dtype),
        generator=generator,
        sweep=int(sweep),
        exch_attempts=vec(exch_attempts, np.int32),
        exch_accepts=vec(exch_accepts, np.int32),
        acc_rate=(torch.zeros_like(energy) if acc_rate is None
                  else vec(acc_rate)),
    )


# the port's module lists -> flax's auto-named submodules, and the names of
# their parameters there
_FLAX_MODULES = {"dense": ("Dense", {"weight": "kernel", "bias": "bias"}),
                 "norm": ("LayerNorm", {"weight": "scale", "bias": "bias"})}


def flax_path(name: str) -> tuple:
    """Where the port's parameter ``name`` lies in a flax parameter tree:
    "dense.1.weight" -> ("params", "Dense_1", "kernel"), "norm.0.weight" ->
    ("params", "LayerNorm_0", "scale"), "log_std" -> ("params",
    "log_std"). flax numbers a module's ``Dense`` and ``LayerNorm`` layers in
    creation order, which is the order of the port's ``dense`` and ``norm``
    lists. A flax kernel is [in, out], a torch ``Linear`` weight [out, in]:
    ``flax_transposed`` says which leaves differ so."""
    parts = name.split(".")
    if len(parts) == 1:
        return ("params", name)
    module, k, leaf = parts
    prefix, leaves = _FLAX_MODULES[module]
    return ("params", f"{prefix}_{k}", leaves[leaf])


def flax_transposed(name: str) -> bool:
    """Whether the port's parameter ``name`` is the transpose of its flax
    leaf (a ``Dense`` kernel)."""
    return flax_path(name)[-1] == "kernel"


def _load_flax(model, tree: dict):
    """``model`` with every parameter taken from the flax ``tree`` (the
    outer "params" level left out) by ``flax_path``."""
    state = {}
    for name, p in model.state_dict().items():
        leaf = tree
        for key in flax_path(name)[1:]:
            leaf = leaf[key]
        value = np.asarray(leaf, np.float32)
        if flax_transposed(name):
            value = value.T
        if value.shape != tuple(p.shape):
            raise ValueError(f"{'/'.join(flax_path(name)[1:])} "
                             f"{np.asarray(leaf).shape} does not fit "
                             f"{name} {tuple(p.shape)}")
        state[name] = torch.tensor(value.copy())
    model.load_state_dict(state)
    return model


def actor_critic_from_flax(params, action_mode: str = "discrete",
                           hidden_sizes=(128, 128), device=None):
    """The port's ``rl.ppo.ActorCritic`` holding the weights of a JAX
    ``ActorCritic`` parameter tree given as numpy arrays:
    ``{"params": {"Dense_0": {"kernel", "bias"}, ..., "log_std"}}`` (the
    outer "params" level may be left out); ``dense[k]`` is ``Dense_k``."""
    from spinglass_tpu_torch.rl.ppo import ActorCritic

    device = resolve_device(device)
    tree = params.get("params", params)
    n_dense = sum(1 for k in tree if k.startswith("Dense_"))
    obs_dim = int(np.asarray(tree["Dense_0"]["kernel"]).shape[0])
    heads = n_dense - len(hidden_sizes) - 1
    n_actions = int(np.asarray(
        tree[f"Dense_{len(hidden_sizes) + 1}"]["kernel"]).shape[1])
    model = ActorCritic(obs_dim, action_mode=action_mode, n_actions=n_actions,
                        hidden_sizes=tuple(hidden_sizes))
    if len(model.dense) != n_dense or heads < 1:
        raise ValueError(f"the tree has {n_dense} Dense layers, action_mode "
                         f"{action_mode!r} with hidden_sizes {hidden_sizes} "
                         f"needs {len(model.dense)}")
    return _load_flax(model, tree).to(device)


def qnetwork_from_flax(params, device=None):
    """The port's ``rl.dqn.QNetwork`` holding the weights of a JAX
    ``QNetwork`` parameter tree given as numpy arrays: ``{"params":
    {"Dense_0", "LayerNorm_0", ..., "Dense_H"}}`` (the outer "params" level
    may be left out). The widths are read from the tree: the observation
    width from ``Dense_0``'s kernel, one hidden layer per ``LayerNorm``, the
    action count from the last kernel."""
    from spinglass_tpu_torch.rl.dqn import QNetwork

    device = resolve_device(device)
    tree = params.get("params", params)
    n_hidden = sum(1 for k in tree if k.startswith("LayerNorm_"))
    kernels = [np.asarray(tree[f"Dense_{k}"]["kernel"])
               for k in range(n_hidden + 1)]
    model = QNetwork(int(kernels[0].shape[0]),
                     n_actions=int(kernels[-1].shape[1]),
                     hidden_sizes=tuple(int(w.shape[1])
                                        for w in kernels[:-1]))
    return _load_flax(model, tree).to(device)


def spin_scorer_from_flax(params, device=None):
    """The port's ``research.novel.SpinScorer`` holding the weights of a
    JAX ``SpinScorer`` parameter tree given as numpy arrays: ``{"params":
    {"Dense_0", "Dense_1"}}`` (the outer "params" level may be left out);
    the hidden width is read from ``Dense_0``'s kernel."""
    from spinglass_tpu_torch.research.novel import SpinScorer

    device = resolve_device(device)
    tree = params.get("params", params)
    hidden = int(np.asarray(tree["Dense_0"]["kernel"]).shape[1])
    return _load_flax(SpinScorer(hidden), tree).to(device)


def meta_network_from_flax(params, device=None):
    """The port's ``research.meta_rl.MetaLearningNetwork`` holding the
    weights of a JAX ``MetaLearningNetwork`` parameter tree given as numpy
    arrays: ``{"params": {"Dense_0", "LayerNorm_0", ..., "Dense_H"}}`` (the
    outer "params" level may be left out). The widths are read from the
    tree: the input width from ``Dense_0``'s kernel, one hidden layer per
    ``LayerNorm``, the output width from the last kernel."""
    from spinglass_tpu_torch.research.meta_rl import MetaLearningNetwork

    device = resolve_device(device)
    tree = params.get("params", params)
    n_hidden = sum(1 for k in tree if k.startswith("LayerNorm_"))
    kernels = [np.asarray(tree[f"Dense_{k}"]["kernel"])
               for k in range(n_hidden + 1)]
    model = MetaLearningNetwork(
        hidden_sizes=tuple(int(w.shape[1]) for w in kernels[:-1]),
        out_dim=int(kernels[-1].shape[1]), in_dim=int(kernels[0].shape[0]))
    return _load_flax(model, tree).to(device)


def env_state_from_numpy(spins, energy, best_energy, initial_energy,
                         prev_energy, temp, acc_rate, step, plateau, episode,
                         done, reward_state: dict, device=None):
    """Port ``rl.env.EnvState`` from a JAX ``EnvState``'s arrays; ``spins``
    are [B, Np]. ``reward_state`` holds the JAX ``RewardState``'s five
    arrays by field name."""
    from spinglass_tpu_torch.rl.env import EnvState
    from spinglass_tpu_torch.rl.rewards import RewardState

    device = resolve_device(device)

    def t(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=device)

    return EnvState(
        spins=t(spins), energy=t(energy), best_energy=t(best_energy),
        initial_energy=t(initial_energy), prev_energy=t(prev_energy),
        temp=t(temp), acc_rate=t(acc_rate), step=t(step, np.int32),
        plateau=t(plateau, np.int32), episode=t(episode, np.int32),
        reward_state=RewardState(**{k: t(reward_state[k]) for k in (
            "de_scale", "reward_ema", "prev_temp", "novelty_counts",
            "novelty_scale")}),
        done=t(done, bool))
