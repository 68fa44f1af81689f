"""PPO training: the captured update of ``spinglass_tpu_torch.rl.ppo``
(``CapturedUpdates``, what ``ppo.train`` replays) replayed back to back, each
update followed by the read of its metrics, as ``train`` reads them.

Parameters: the env (``n_envs``, ``sweeps_per_step``, ``max_steps``,
``init_temp_range``, ``min_temp``, ``max_temp``, ``plateau_patience`` and
the ``reward`` weights, handed to the program and to the reference alike)
and PPO (``rollout_len``, ``hidden_sizes``); every other field keeps its
default (discrete actions, 4 epochs of 4 minibatches). The
control "program_tf32" sets ``tf32``: the program's matrix products in TF32;
"reference_bf16" puts the env's energies worked out on bfloat16 couplings in
the program's place.

Set-up builds one training object from the seed, drives it through its first
``env_updates`` updates with the window's own call, and hands the same
object to the window. For those first updates the benchmark keeps what the
references need to follow them: each rollout as the environment produced it,
each env step's spins, energies and acceptance rates after the sweeps and
its state after the auto-reset (``reference.env`` follows the environment
over all of them, past ``max_steps``), and the minibatch permutations of
the learning phase (``reference.ppo`` follows the first ``learn_updates``),
copied inside the captured update into buffers of the benchmark's (a few
dozen copies among the update's thousands of kernels), and the parameters,
the optimizer's state and the environment's state read between the updates.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import torch

from portbench import program
from portbench.reference import energy, judge as J
from portbench.reference import env as ref_env
from portbench.reference import ppo as ref_ppo

ROLLOUT_KEYS = ("obs", "action", "reward", "done", "logp", "value")
ENV_KEYS = ("step_spins", "step_energy", "acc", "reset_spins",
            "reset_energy", "reset_temp")


class _Tap:
    """Buffers of the benchmark's that the captured update copies the
    rollout and the permutations into, at every replay."""

    def __init__(self):
        self.bufs = None

    def put(self, tensors: dict) -> None:
        with torch.no_grad():
            if self.bufs is None:
                self.bufs = {k: torch.empty_like(v) for k, v in tensors.items()}
            for k, v in tensors.items():
                self.bufs[k].copy_(v)

    def read(self) -> dict:
        return {k: v.detach().to("cpu", copy=True) for k, v in self.bufs.items()}


class _EnvTap:
    """The program's env module with ``step`` and ``auto_reset`` wrapped so
    that each env step's outcome is kept for the tap: the spins (as int8),
    energies and acceptance rates after the sweeps, and the spins, energies
    and temperatures after the auto-reset."""

    def __init__(self, env_mod):
        self.mod, self.steps = env_mod, []

    def __getattr__(self, name):
        return getattr(self.mod, name)

    def step(self, *args, **kwargs):
        out = self.mod.step(*args, **kwargs)
        st = out[0]
        self.steps.append({"step_spins": st.spins.to(torch.int8),
                           "step_energy": st.energy, "acc": st.acc_rate})
        return out

    def auto_reset(self, *args, **kwargs):
        st, obs = self.mod.auto_reset(*args, **kwargs)
        self.steps[-1].update(reset_spins=st.spins.to(torch.int8),
                              reset_energy=st.energy, reset_temp=st.temp)
        return st, obs

    def take(self) -> dict:
        out = {k: torch.stack([x[k] for x in self.steps]) for k in ENV_KEYS}
        self.steps.clear()
        return out


def _tapped(ppo, update_fn, tap: _Tap, env_tap: _EnvTap):
    """``update_fn`` with its rollout, env steps and permutations copied to
    ``tap``."""
    perms = []
    draw = ppo.randperm

    def randperm(n, gen, device):
        p = draw(n, gen, device)
        perms.append(p)
        return p

    def step(state):
        state, traj, last_value = update_fn.rollout(state)
        state, metrics = update_fn.learn(state, traj, last_value)
        tap.put({**{k: traj[k] for k in ROLLOUT_KEYS}, **env_tap.take(),
                 "perms": torch.stack(perms)})
        perms.clear()
        return state, metrics

    step.engine = update_fn.engine
    step.randperm = randperm
    return step


def _snapshot(st) -> dict:
    """The parameters, Adam's state and the env's state of the static
    training state, on the host."""
    params = {k: v.detach().to("cpu", copy=True) for k, v in st.params.items()}
    adam = {"m": {}, "v": {}, "step": 0}
    for k, p in st.params.items():
        s = st.opt.state.get(p, {})   # empty until the optimizer's first step
        zero = torch.zeros(p.shape)
        adam["m"][k] = s["exp_avg"].detach().to("cpu", copy=True) if s else zero
        adam["v"][k] = s["exp_avg_sq"].detach().to("cpu", copy=True) if s \
            else zero
        adam["step"] = int(s["step"]) if s else 0
    env = st.env_state
    return {"params": params, "adam": adam,
            "obs": st.obs.detach().to("cpu", copy=True),
            "env_spins": env.spins.to(torch.int8).to("cpu", copy=True),
            "env_energy": env.energy.to("cpu", copy=True),
            "env_temp": env.temp.to("cpu", copy=True)}


def prepare(ctx):
    from spinglass_tpu_torch.rl import ppo
    from spinglass_tpu_torch.rl.env import EnvConfig
    from spinglass_tpu_torch.rl.rewards import RewardConfig

    p = ctx.params
    if p.get("tf32"):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    env_cfg = EnvConfig(n_envs=p["n_envs"], sweeps_per_step=p["sweeps_per_step"],
                        max_steps=p["max_steps"],
                        init_temp_range=tuple(p["init_temp_range"]),
                        min_temp=p["min_temp"], max_temp=p["max_temp"],
                        plateau_patience=p["plateau_patience"],
                        reward=RewardConfig(**p["reward"]))
    cfg = ppo.PPOConfig(rollout_len=p["rollout_len"],
                        hidden_sizes=tuple(p["hidden_sizes"]))
    problem = program.problem(ctx.instance, ctx.device)
    init_fn, update_fn, _ = ppo.make_ppo(problem, env_cfg, cfg)
    state = init_fn(torch.Generator().manual_seed(ctx.job_seed(0, "train")))
    tap, env_tap = _Tap(), _EnvTap(ppo.env_mod)
    step = _tapped(ppo, update_fn, tap, env_tap)
    start = _snapshot(state)
    # the learning phase draws its permutations, and the rollout steps its
    # env, through the taps until ``judge`` puts the program's function and
    # module back (on the card only the capture calls them; on the CPU every
    # replay runs the step eagerly)
    original = ppo.randperm, ppo.env_mod
    ppo.randperm, ppo.env_mod = step.randperm, env_tap
    captured = ppo.CapturedUpdates(step, state)
    r = SimpleNamespace(ctx=ctx, cfg=cfg, env_cfg=env_cfg, problem=problem,
                        captured=captured, tap=tap, first=[start],
                        original=original)
    for _ in range(max(p["learn_updates"], p["env_updates"])):
        captured.replay()
        metrics = captured.read(1)[0]
        snap = _snapshot(captured.state)
        snap.update(rollout=tap.read(), metrics=metrics)
        r.first.append(snap)
    return r


def job(r, i: int) -> dict:
    t0 = time.perf_counter()
    r.captured.replay()
    metrics = r.captured.read(1)[0]     # waits for the device
    return {"seconds": time.perf_counter() - t0, "metrics": metrics,
            "env_steps": r.cfg.rollout_len * r.env_cfg.n_envs,
            "batch_env_steps": r.cfg.rollout_len,
            "sweeps_per_env_step": r.env_cfg.sweeps_per_step}


def end_to_end(records: list, window_s: float) -> dict:
    return {"env_steps_per_s": sum(x["env_steps"] for x in records)
            / window_s}


def counts(records: list) -> dict:
    steps = sum(x["batch_env_steps"] for x in records)
    return {"jobs": len(records), "env_steps": steps,
            "sweeps": steps * records[0]["sweeps_per_env_step"]}


def _hyper(cfg) -> ref_ppo.Hyper:
    return ref_ppo.Hyper(
        lr=cfg.lr, gamma=cfg.gamma, gae_lambda=cfg.gae_lambda,
        clip_eps=cfg.clip_eps, entropy_coef=cfg.entropy_coef,
        value_coef=cfg.value_coef, n_epochs=cfg.n_epochs,
        n_minibatches=cfg.n_minibatches, max_grad_norm=cfg.max_grad_norm,
        n_hidden=len(cfg.hidden_sizes))


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap of norms: |norm(prog) - norm(ref)| over the
    larger of norm(ref) and the median leaf's, over the leaves ``keep``."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    med = float(torch.tensor(sorted(rn.values())).median())
    return max(abs(float(torch.linalg.vector_norm(prog[k].double())) - rn[k])
               / max(rn[k], med, 1e-300) for k in keep)


def _forward_gap(h, params: dict, roll: dict, dev) -> float:
    """The rollout's log-probabilities and values as the program's policy
    computed them, against the reference's forward pass on the same
    parameters (the program's, before the update) and observations: the
    largest difference over the largest reference value, of each."""
    logits, value = ref_ppo.forward(params, roll["obs"].to(dev, torch.float64),
                                    h.n_hidden)
    logp = torch.gather(torch.log_softmax(logits, -1), -1,
                        roll["action"].to(dev).long()[..., None])[..., 0]
    gaps = [(roll[k].to(dev, torch.float64) - ref).abs().max()
            / ref.abs().max().clamp(min=1e-30)
            for k, ref in (("logp", logp), ("value", value))]
    return float(max(gaps))


def _env_energy_gap(ctx, first) -> float:
    """Every energy the env reported against the float64 energy of its
    spins: at the start, after each step's sweeps and after each reset."""
    dev = ctx.device
    ref = energy.Couplings(ctx.instance, dev)
    sigma = ref.random_sigma()
    low = (energy.Couplings(ctx.instance, dev, torch.float32, True)
           if ctx.control == "reference_bf16" else None)
    pairs = [(first[0]["env_spins"], first[0]["env_energy"])]
    for snap in first[1:]:
        roll = snap["rollout"]
        for s_key, e_key in (("step_spins", "step_energy"),
                             ("reset_spins", "reset_energy")):
            pairs += list(zip(roll[s_key], roll[e_key]))
    gap = 0.0
    for spins, claimed in pairs:
        spins = spins.to(dev)
        if low is not None:
            claimed = low.energies(spins).cpu()
        gap = max(gap, float(J.rel_gap(claimed, ref.energies(spins),
                                       sigma).max()))
    return gap


def _follow_env(ctx, first) -> dict:
    """``reference.env`` over every followed env step, from the start
    state: the largest gap of a reward and of an observation, the done
    flags that differ, and the envs that the auto-reset mixed wrongly (a
    continuing env whose spins, energy or temperature changed in the
    reset, or a fresh start temperature outside its range)."""
    dev, p = ctx.device, ctx.params
    n = ctx.instance["n"]
    s0 = first[0]
    fol = ref_env.Follower(p, n, s0["env_spins"].to(dev),
                           s0["env_energy"].to(dev), s0["env_temp"].to(dev))
    lo, hi = p["init_temp_range"]
    reward_gap = obs_gap = 0.0
    done_wrong = reset_wrong = at_max = 0
    for snap in first[1:]:
        roll = {k: v.to(dev) for k, v in snap["rollout"].items()}
        for t in range(roll["action"].shape[0]):
            obs_gap = max(obs_gap, float((roll["obs"][t] - fol.observe())
                                         .abs().max()))
            reward, done, temp = fol.step(roll["action"][t],
                                          roll["step_spins"][t],
                                          roll["step_energy"][t],
                                          roll["acc"][t])
            reward_gap = max(reward_gap, float((roll["reward"][t] - reward)
                                               .abs().max()))
            done_wrong += int((roll["done"][t] != done).sum())
            at_max += int((fol.s["step"] >= p["max_steps"]).sum())
            kept = ((roll["reset_spins"][t] != roll["step_spins"][t]).any(-1)
                    | (roll["reset_energy"][t] != roll["step_energy"][t])
                    | (roll["reset_temp"][t] != temp))
            t0 = roll["reset_temp"][t]
            fresh = (t0 < lo * (1 - 1e-6)) | (t0 > hi * (1 + 1e-6))
            reset_wrong += int(torch.where(done, fresh, kept).sum())
            fol.reset(done, roll["reset_spins"][t], roll["reset_energy"][t],
                      t0)
    obs_gap = max(obs_gap, float((first[-1]["obs"].to(dev) - fol.observe())
                                 .abs().max()))
    steps = (len(first) - 1) * first[1]["rollout"]["action"].shape[0]
    print(f"env followed over {steps} steps; episodes ended at max_steps: "
          f"{at_max}", file=sys.stderr)
    return {"reward_gap": reward_gap, "obs_gap": obs_gap,
            "done_wrong": done_wrong, "reset_wrong": reset_wrong}


def judge(r, records: list, ctx):
    """(checks, 0). The environment is followed over the first
    ``env_updates`` updates (``_follow_env``), its energies judged against
    their spins (``_env_energy_gap``). The learning reference follows the
    first ``learn_updates`` updates from the start state: the losses of
    each, Adam's first moment after the first, and the parameters' change
    after the last; each rollout's log-probabilities and values are judged
    against the reference's forward pass on the program's parameters of
    that moment. Leaves whose reference first moment is under a thousandth
    of the median leaf's are left out of the change (nought to rounding)."""
    from spinglass_tpu_torch.rl import ppo

    ppo.randperm, ppo.env_mod = r.original
    cfg, first = r.cfg, r.first
    del r.captured, r.problem
    program.free_captured()
    dev, lim = ctx.device, ctx.workload["limits"]
    env_gap = _env_energy_gap(ctx, first)
    env = _follow_env(ctx, first)
    learned = first[: ctx.params["learn_updates"] + 1]
    h = _hyper(cfg)

    def f64(d):
        return {k: v.to(dev, torch.float64) for k, v in d.items()}

    params = f64(first[0]["params"])
    adam = {"step": 0, "m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()}}
    loss_gap, grad_gap, fwd_gap, m_ref = 0.0, 0.0, 0.0, None
    for k, snap in enumerate(learned[1:], start=1):
        roll = snap["rollout"]
        fwd_gap = max(fwd_gap, _forward_gap(h, f64(first[k - 1]["params"]),
                                            roll, dev))
        out = ref_ppo.learn(h, params, adam, {
            "obs": roll["obs"].to(dev, torch.float64),
            "action": roll["action"].to(dev).long(),
            "reward": roll["reward"].to(dev, torch.float64),
            "done": roll["done"].to(dev), "perms": roll["perms"].to(dev).long(),
            "last_obs": first[k]["obs"].to(dev, torch.float64)})
        m = snap["metrics"]
        total = (m["policy_loss"] + cfg.value_coef * m["value_loss"]
                 - cfg.entropy_coef * m["entropy"])
        loss_gap = max(loss_gap, abs(total - out["loss"]) / abs(out["loss"]))
        if k == 1:
            m_ref = out["adam"]["m"]
            grad_gap = _leaf_gap(snap["adam"]["m"], m_ref, list(m_ref))
        params, adam = out["params"], out["adam"]
    med = float(torch.tensor([float(torch.linalg.vector_norm(v))
                              for v in m_ref.values()]).median())
    keep = [k for k, v in m_ref.items()
            if float(torch.linalg.vector_norm(v)) >= 1e-3 * med]
    print(f"update_gap leaves left out: {sorted(set(m_ref) - set(keep))}",
          file=sys.stderr)
    p0 = first[0]["params"]
    d_prog = {k: learned[-1]["params"][k].double() - p0[k].double()
              for k in keep}
    d_ref = {k: params[k].cpu() - p0[k].double() for k in keep}
    checks = {"forward_gap": J.check(fwd_gap, lim["forward_gap"]),
              "loss_gap": J.check(loss_gap, lim["loss_gap"]),
              "grad_gap": J.check(grad_gap, lim["grad_gap"]),
              "update_gap": J.check(_leaf_gap(d_prog, d_ref, keep),
                                    lim["update_gap"]),
              "env_energy_gap": J.check(env_gap, lim["env_energy_gap"]),
              **{k: J.check(v, lim[k]) for k, v in env.items()}}
    return checks, 0
