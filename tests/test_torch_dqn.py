"""Port parity for the hybrid DQN (``spinglass_tpu_torch.rl.dqn``) against
``spinglass_tpu.rl.dqn``.

Both packages get the same numpy inputs. The env instance is a +-J glass
with h on a quarter grid (fields and energies exact in float32), and the
port's step is handed the draws the JAX step makes under its key chain, so
spins, energies, actions, the ring's slots, ``ptr``, ``size``, the step
counter and the hybrid weight must be equal bit for bit. Observations and
rewards go through log10, tanh and divisions and agree to float32 rounding
(rtol 1e-5, as in ``test_torch_rl.py``); the network's outputs, the loss,
the parameters, the target parameters and Adam's moments agree to 1e-5
relative (each test states its tolerance). Parameters cross through
``core.convert.qnetwork_from_flax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.rl import dqn as jdqn  # noqa: E402
from spinglass_tpu.rl import env as jenv  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.convert import (  # noqa: E402
    env_state_from_numpy, flax_path, flax_transposed, problem_from_numpy,
    qnetwork_from_flax)
from spinglass_tpu_torch.rl import dqn as D  # noqa: E402
from spinglass_tpu_torch.rl import env as E  # noqa: E402
from spinglass_tpu_torch.rl.ppo import make_optimizer  # noqa: E402

N, B = 32, 8
BUFFERS = {"uniform": (jdqn.ReplayBuffer, D.ReplayBuffer),
           "prioritized": (jdqn.PrioritizedReplayBuffer,
                           D.PrioritizedReplayBuffer)}


def _problems(n=N, seed=3):
    """The +-J instance with h on a quarter grid, in both packages."""
    j = topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    jp = JaxProblem.from_dense(j, h)
    tp = problem_from_numpy(np.asarray(jp.j), np.asarray(jp.h),
                            np.asarray(jp.active_mask), jp.n_spins,
                            device="cpu")
    return jp, tp


def _carry_env(js):
    d = {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js) if f.name != "reward_state"}
    rs = {f.name: np.asarray(getattr(js.reward_state, f.name))
          for f in dataclasses.fields(js.reward_state)}
    return env_state_from_numpy(**d, reward_state=rs, device="cpu")


def _tree(x):
    return jax.tree.map(np.asarray, x)


def _net(hidden=(16, 12), obs_dim=E.OBS_DIM, seed=0):
    jmodel = jdqn.QNetwork(n_actions=E.N_ACTIONS, hidden_sizes=hidden)
    obs = np.random.default_rng(seed).normal(size=(6, obs_dim)).astype(
        np.float32)
    jparams = jmodel.init(jax.random.key(seed), jnp.asarray(obs))
    return jmodel, jparams, qnetwork_from_flax(_tree(jparams), device="cpu"), obs


# ---------------------------------------------------------------------------
# the network and the heuristic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden", [(16, 12), (8,)])
def test_qnetwork_forward_matches_flax(hidden):
    """flax parameters carried across: Q-values rtol 1e-5 (atol 1e-6); the
    LayerNorms take flax's epsilon 1e-6 and the widths come from the
    tree."""
    jmodel, jparams, tmodel, obs = _net(hidden)
    assert [m.eps for m in tmodel.norm] == [1e-6] * len(hidden)
    assert [layer.out_features for layer in tmodel.dense] == [*hidden, 10]
    obs = obs * 5.0 + 1.0   # LayerNorm inputs far from zero mean
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(obs)))
    got = tmodel(torch.tensor(obs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_init_params_start_as_flax_does():
    """LeCun-normal kernels, zero biases, LayerNorm scales 1 and biases 0;
    the target network is a copy, not the same tensors."""
    _, tp = _problems()
    cfg = E.EnvConfig(n_envs=B, sweeps_per_step=1, max_steps=4)
    init_fn, _, _ = D.make_dqn(tp, cfg, D.DQNConfig(hidden_sizes=(64,),
                                                    buffer_size=16))
    st = init_fn()
    p = st.params
    assert set(p) == {"dense.0.weight", "dense.0.bias", "dense.1.weight",
                      "dense.1.bias", "norm.0.weight", "norm.0.bias"}
    assert float(p["norm.0.weight"].detach().min()) == float(p["norm.0.weight"].detach().max()
                                                    ) == 1.0
    assert not any(float(p[k].abs().max()) for k in p if k.endswith("bias"))
    np.testing.assert_allclose(float(p["dense.0.weight"].std()),
                               np.sqrt(1 / E.OBS_DIM), rtol=0.15)
    for name in p:
        assert torch.equal(p[name], st.target_params[name])
        assert (p[name].untyped_storage().data_ptr()
                != st.target_params[name].untyped_storage().data_ptr())
        assert p[name].requires_grad and not st.target_params[name].requires_grad


def test_heuristic_action_matches_jax():
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(64, E.OBS_DIM)).astype(np.float32)
    obs[:, 4] = rng.uniform(0, 1, 64)
    obs[:, 8] = rng.uniform(0, 1, 64)
    obs[0, [4, 8]] = [0.6, 0.5]     # on both edges: cool
    want = np.asarray(jdqn.heuristic_action(jnp.asarray(obs)))
    got = D.heuristic_action(torch.tensor(obs))
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert set(want.tolist()) == {1, 3, 8}


# ---------------------------------------------------------------------------
# the replay buffers
# ---------------------------------------------------------------------------

def _push_both(jbuf, tbuf, rng, b, obs_dim):
    obs = rng.normal(size=(b, obs_dim)).astype(np.float32)
    nxt = rng.normal(size=(b, obs_dim)).astype(np.float32)
    act = rng.integers(0, 10, b).astype(np.int32)
    rew = rng.normal(size=b).astype(np.float32)
    done = rng.random(b) < 0.5
    jbuf = jbuf.push_batch(*(jnp.asarray(x) for x in (obs, act, rew, nxt,
                                                       done)))
    tbuf = tbuf.push_batch(*(torch.tensor(x) for x in (obs, act, rew, nxt,
                                                        done)))
    return jbuf, tbuf


def _assert_buffers_equal(jbuf, tbuf):
    for name in ("obs", "action", "reward", "next_obs", "done", "ptr", "size"):
        np.testing.assert_array_equal(np.asarray(getattr(jbuf, name)),
                                      getattr(tbuf, name).numpy(),
                                      err_msg=name)
    if hasattr(jbuf, "priority"):
        np.testing.assert_array_equal(np.asarray(jbuf.priority),
                                      tbuf.priority.numpy())


@pytest.mark.parametrize("kind", list(BUFFERS))
def test_buffer_ring_semantics(kind):
    """The JAX test's ring (capacity 4, pushes of 3): size 3 / ptr 3, then
    size 4 / ptr 2 after the wrap; every slot, ptr and size equal to the JAX
    buffer's after each push (with PER, the max-priority insertion too), and
    a push wider than the ring raises."""
    jcls, tcls = BUFFERS[kind]
    jbuf, tbuf = jcls.create(4, 2), tcls.create(4, 2, device="cpu")
    rng = np.random.default_rng(0)
    jbuf, tbuf = _push_both(jbuf, tbuf, rng, 3, 2)
    assert int(tbuf.size) == 3 and int(tbuf.ptr) == 3
    _assert_buffers_equal(jbuf, tbuf)
    if kind == "prioritized":   # the next push enters at the max, 7.5
        jbuf = jbuf.replace(priority=jbuf.priority.at[1].set(7.5))
        tbuf.priority[1] = 7.5
    jbuf, tbuf = _push_both(jbuf, tbuf, rng, 3, 2)
    assert int(tbuf.size) == 4 and int(tbuf.ptr) == 2   # wrapped
    _assert_buffers_equal(jbuf, tbuf)
    with pytest.raises(ValueError, match="twice"):
        _push_both(jbuf, tbuf, rng, 5, 2)


def test_uniform_sample_takes_the_device_size():
    """Indices in [0, max(size, 1)) drawn on the device: slot 0 only while
    empty, every written slot and no other after two pushes."""
    buf = D.ReplayBuffer.create(16, 3, device="cpu")
    g = torch.Generator().manual_seed(0)
    assert int(buf.sample(g, 64)["action"].numel()) == 64
    rng = np.random.default_rng(2)
    for _ in range(2):
        _, buf = _push_both(jdqn.ReplayBuffer.create(16, 3), buf, rng, 5, 3)
    idx = D.randint(g, torch.clamp(buf.size, min=1), (4000,), "cpu")
    assert set(idx.tolist()) == set(range(10))
    batch = buf.sample(None, 3, idx=torch.tensor([9, 0, 4]))
    assert torch.equal(batch["obs"], buf.obs[[9, 0, 4]])


def _per_buffer(rng, cap=16, filled=11, obs_dim=3):
    jbuf = jdqn.PrioritizedReplayBuffer.create(cap, obs_dim)
    tbuf = D.PrioritizedReplayBuffer.create(cap, obs_dim, device="cpu")
    jbuf, tbuf = _push_both(jbuf, tbuf, rng, filled, obs_dim)
    pr = np.zeros(cap, np.float32)
    pr[:filled] = rng.uniform(0.01, 5.0, filled).astype(np.float32)
    return jbuf.replace(priority=jnp.asarray(pr)), dataclasses.replace(
        tbuf, priority=torch.tensor(pr))


@pytest.mark.parametrize("alpha,beta", [(0.6, 0.4), (1.0, 1.0)])
def test_per_sample_is_jax_categorical_on_its_gumbel_noise(alpha, beta):
    """The port's Gumbel-max sample fed the Gumbel noise
    ``jax.random.categorical`` draws under the key: JAX's indices exactly
    (never an unwritten slot), IS weights rtol 1e-6, and the batch the
    slots hold."""
    jbuf, tbuf = _per_buffer(np.random.default_rng(4))
    key = jax.random.key(7)
    jbatch, jidx, jw = jbuf.sample(key, 16, alpha, beta)
    gumbel = np.asarray(jax.random.gumbel(key, (16, 16), jnp.float32))
    tbatch, tidx, tw = tbuf.sample(None, 16, alpha, beta,
                                   gumbel=torch.tensor(gumbel))
    assert tidx.tolist() == np.asarray(jidx).tolist()
    assert max(tidx.tolist()) < 11
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))
    # drawn on the device: the high-priority slots dominate
    _, idx, w = tbuf.sample(torch.Generator().manual_seed(0), 4000, alpha,
                            beta)
    freq = np.bincount(idx.numpy(), minlength=16)[:11] / 4000
    p = tbuf.priority.numpy()[:11] ** alpha
    np.testing.assert_allclose(freq, p / p.sum(), atol=0.03)
    assert float(w.max()) == 1.0


def test_update_priorities_matches_jax_and_keeps_one_written_value():
    """Distinct slots: equal to the JAX scatter exactly. Repeated slots
    (the winner of a scatter is unspecified): each holds one of the values
    written to it, the last one in the port's fixed rule."""
    jbuf, tbuf = _per_buffer(np.random.default_rng(5))
    idx = np.array([3, 0, 10, 7], np.int64)
    td = np.array([0.5, 2.25, 0.0, 1.5], np.float32)
    jbuf = jbuf.update_priorities(jnp.asarray(idx), jnp.asarray(td), 1e-3)
    tbuf.update_priorities(torch.tensor(idx), torch.tensor(td), 1e-3)
    np.testing.assert_array_equal(tbuf.priority.numpy(),
                                  np.asarray(jbuf.priority))
    before = tbuf.priority.clone()
    idx = torch.tensor([2, 5, 2, 9, 5, 2])
    td = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    tbuf.update_priorities(idx, td, 0.5)
    got = tbuf.priority
    for slot in range(16):
        written = (td[idx == slot] + 0.5).tolist()
        if written:
            assert float(got[slot]) in written
            assert float(got[slot]) == written[-1]
        else:
            assert float(got[slot]) == float(before[slot])


# ---------------------------------------------------------------------------
# act_and_learn against the JAX step
# ---------------------------------------------------------------------------

def _jax_draws(js, jp, jcfg, cfg, size_after):
    """The draws the JAX ``_act_and_learn_raw`` makes under ``js.key``, and
    its sample key."""
    _, k_eps, k_rand, k_hyb, k_env, k_reset, k_samp = jax.random.split(
        js.key, 7)
    b, n_pad = jcfg.n_envs, jp.n_padded
    keys = jax.random.split(k_env, jcfg.sweeps_per_step)
    draws = {
        "eps_u": jax.random.uniform(k_eps, (b,)),
        "rand_a": jax.random.randint(k_rand, (b,), 0, E.N_ACTIONS),
        "hyb_u": jax.random.uniform(k_hyb, (b,)),
        "uniforms": np.stack([np.asarray(jax.random.uniform(
            k, (b, n_pad), jnp.float32)) for k in keys]),
        "reset_spins": jenv.reset(jp, jcfg, k_reset)[0].spins,
    }
    if cfg.prioritized_replay:
        draws["gumbel"] = jax.random.gumbel(
            k_samp, (cfg.batch_size, cfg.buffer_size), jnp.float32)
    else:
        draws["sample_idx"] = jax.random.randint(
            k_samp, (cfg.batch_size,), 0, max(size_after, 1))
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}, k_samp


def _port_state(js, jcfg_dqn, tcfg, obs_dim):
    tree = _tree(js.params)
    model = qnetwork_from_flax(tree, device="cpu")
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in model.named_parameters()}
    cls = (D.PrioritizedReplayBuffer if tcfg.prioritized_replay
           else D.ReplayBuffer)
    return D.DQNState(
        params=params,
        target_params={n: p.detach().clone() for n, p in params.items()},
        opt=make_optimizer(tcfg, params),
        buffer=cls.create(tcfg.buffer_size, obs_dim, device="cpu"),
        env_state=_carry_env(js.env_state),
        obs=torch.tensor(np.asarray(js.obs)),
        generator=torch.Generator().manual_seed(0),
        step=torch.zeros((), dtype=torch.int64),
        annealing_weight=torch.tensor(float(js.annealing_weight)),
        rl_perf_ema=torch.zeros(()), heur_perf_ema=torch.zeros(()))


def _per_written(jmodel, js_before, js_after, k_samp, cfg):
    """A PER step of the JAX package: its sampled slots and the |td| + eps
    it writes there, recomputed from the state before the step and the
    buffer after it (the priorities as the push left them: the pushed slots
    at the old maximum, at least 1)."""
    prev = js_before.buffer.priority
    slots = (js_before.buffer.ptr + jnp.arange(B)) % cfg.buffer_size
    buf = js_after.buffer.replace(priority=prev.at[slots].set(
        jnp.maximum(jnp.max(prev), 1.0)))
    batch, idx, _ = buf.sample(k_samp, cfg.batch_size, cfg.per_alpha,
                               cfg.per_beta)
    q = jmodel.apply(js_before.params, batch["obs"])
    q_sel = jnp.take_along_axis(q, batch["action"][:, None], -1)[:, 0]
    q_next = jmodel.apply(js_before.target_params, batch["next_obs"])
    target = batch["reward"] + cfg.gamma * jnp.max(q_next, -1) * (
        1.0 - batch["done"].astype(jnp.float32))
    return np.asarray(idx), np.asarray(jnp.abs(q_sel - target) + cfg.per_eps)


def _assert_close(name, got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("per", [False, True])
def test_act_and_learn_matches_jax_step(per):
    """Three ``act_and_learn`` steps against the JAX ``_act_and_learn_raw``,
    the port fed the JAX key chain's draws. Episodes end at step 2, so the
    third step acts on reset envs; the ring of 16 wraps at the second push.
    Exact: spins, energies, best energies, counters, done, actions, the
    ring's done flags, ptr, size, the step counter, epsilon, the hybrid
    weight and the two performance EMAs; with PER the sampled slots
    (through the priorities of slots sampled once). rtol 1e-5 (atol 1e-6)
    and within 4 float32 ulps: observations and rewards, in the buffer too
    (the same arithmetic in another order). rtol 1e-5 (atol 1e-6): the
    loss, the Q-net's parameters, the target network's and Adam's moments. A slot sampled
    more than once holds one of the values written to it (the JAX
    scatter's winner is unspecified)."""
    jp, tp = _problems()
    kw = dict(n_envs=B, sweeps_per_step=2, max_steps=2)
    jcfg, tcfg_env = jenv.EnvConfig(**kw), E.EnvConfig(**kw)
    dkw = dict(hidden_sizes=(16, 12), buffer_size=16, batch_size=8,
               prioritized_replay=per, epsilon_decay_steps=4,
               annealing_weight=0.5, seed=3)
    jcfg_d, tcfg = jdqn.DQNConfig(**dkw), D.DQNConfig(**dkw)
    jinit, jstep, jmodel = jdqn.make_dqn(jp, jcfg, jcfg_d, engine=None)
    _, tstep, _ = D.make_dqn(tp, tcfg_env, tcfg, engine=None)
    js = jinit()
    ts = _port_state(js, jcfg_d, tcfg, E.OBS_DIM)
    saw_dup = False
    for t in range(3):
        size_after = min(int(js.buffer.size) + B, tcfg.buffer_size)
        draws, k_samp = _jax_draws(js, jp, jcfg, tcfg, size_after)
        js_before = js
        js, jm = jstep(js)
        ts, tm = tstep(ts, draws)
        env_j, env_t = js.env_state, ts.env_state
        for name in ("spins", "energy", "best_energy", "initial_energy",
                     "prev_energy", "step", "plateau", "episode", "done",
                     "acc_rate"):
            np.testing.assert_array_equal(np.asarray(getattr(env_j, name)),
                                          getattr(env_t, name).numpy(),
                                          err_msg=name)
        _assert_close("obs", ts.obs.numpy(), np.asarray(js.obs))
        np.testing.assert_array_max_ulp(ts.obs.numpy(), np.asarray(js.obs), 4)
        jb, tb = js.buffer, ts.buffer
        for name in ("action", "done", "ptr", "size"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                          getattr(tb, name).numpy(),
                                          err_msg=name)
        for name in ("obs", "next_obs", "reward"):
            _assert_close(name, getattr(tb, name).numpy(),
                          np.asarray(getattr(jb, name)))
            np.testing.assert_array_max_ulp(getattr(tb, name).numpy(),
                                            np.asarray(getattr(jb, name)), 4)
        assert int(ts.step) == int(js.step) == t + 1
        assert float(ts.annealing_weight) == float(js.annealing_weight)
        for name in ("rl_perf_ema", "heur_perf_ema"):
            assert float(getattr(ts, name)) == float(getattr(js, name)), name
        for k in ("epsilon", "annealing_weight", "mean_best_energy"):
            assert float(tm[k]) == float(jm[k]), k
        for k in ("loss", "mean_reward"):
            _assert_close(k, float(tm[k]), float(jm[k]))
        if per:
            idx, written = _per_written(jmodel, js_before, js, k_samp,
                                        jcfg_d)
            got, want = tb.priority.numpy(), np.asarray(jb.priority)
            for slot in range(tcfg.buffer_size):
                hits = written[idx == slot]
                if len(hits) > 1:
                    saw_dup = True
                    assert np.isclose(got[slot], hits, rtol=1e-5).any()
                    assert np.isclose(want[slot], hits, rtol=1e-5).any()
                else:
                    _assert_close(f"priority {slot}", got[slot], want[slot])
        tree = _tree(js.params)["params"]
        ttree = _tree(js.target_params)["params"]
        mu = _tree(js.opt_state[0].mu)["params"]
        nu = _tree(js.opt_state[0].nu)["params"]
        for name, p in ts.params.items():
            path = flax_path(name)[1:]

            def leaf(t):
                x = t
                for k in path:
                    x = x[k]
                return x.T if flax_transposed(name) else x

            _assert_close(name, p.detach().numpy(), leaf(tree))
            _assert_close("target " + name,
                          ts.target_params[name].numpy(), leaf(ttree))
            adam = ts.opt.state[p]
            _assert_close("mu " + name, adam["exp_avg"].numpy(), leaf(mu))
            _assert_close("nu " + name, adam["exp_avg_sq"].numpy(), leaf(nu))
    assert saw_dup == per


# ---------------------------------------------------------------------------
# parameters on disk, the captured step, the guards
# ---------------------------------------------------------------------------

def test_save_load_round_trip_and_jax_files(tmp_path):
    """The port's file loads back equal; a file the JAX ``save_params``
    wrote loads into the port and gives the JAX Q-values (rtol 1e-5); the
    port's file loads into the JAX package too, equal to its source."""
    jmodel, jparams, tmodel, obs = _net((16, 12), seed=4)
    params = dict(tmodel.named_parameters())
    path = str(tmp_path / "port.npz")
    D.save_params(params, path)
    back = D.load_params(params, path)
    assert all(torch.equal(back[k], params[k]) for k in params)
    jpath = str(tmp_path / "jax.npz")
    jdqn.save_params(jparams, jpath)
    template = {k: torch.zeros_like(v) for k, v in params.items()}
    loaded = D.load_params(template, jpath)
    got = torch.func.functional_call(tmodel, loaded, (torch.tensor(obs),))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.apply(jparams,
                                                       jnp.asarray(obs))),
                               rtol=1e-5, atol=1e-6)
    jback = jdqn.load_params(jparams, path)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="does not fit"):
        D.load_params({"dense.0.weight": torch.zeros(3, 3)}, path)


@pytest.mark.parametrize("per", [False, True])
def test_captured_steps_through_the_tape_equal_the_eager_loop(per):
    """``CapturedSteps`` (k=2, 5 steps: two blocks and a single) replayed
    eagerly through the random tape on the CPU: every metric, the
    parameters, the target network, the buffer and the env state equal the
    eager loop's bit for bit, and the warm-up leaves Adam's state fresh."""
    _, tp = _problems()
    env_cfg = E.EnvConfig(n_envs=B, sweeps_per_step=2, max_steps=3,
                          init_temp_range=(0.2, 5.0))
    cfg = D.DQNConfig(hidden_sizes=(16,), buffer_size=32, batch_size=8,
                      prioritized_replay=per)
    init_fn, step_fn, _ = D.make_dqn(tp, env_cfg, cfg)
    cap = D.CapturedSteps(step_fn, init_fn(torch.Generator().manual_seed(9)),
                          2)
    assert all(len(cap.state.opt.state[p]["step"].shape) == 0
               and float(cap.state.opt.state[p]["step"]) == 0.0
               and not cap.state.opt.state[p]["exp_avg"].any()
               for p in cap.state.params.values())
    rows = []
    for n in (2, 2, 1):
        for _ in range(n):
            cap.replay()
        rows += cap.read(n)
    st = init_fn(torch.Generator().manual_seed(9))
    want = []
    for _ in range(5):
        st, m = step_fn(st)
        want.append({k: float(m[k]) for k in D.METRIC_KEYS})
    assert rows == want and int(cap.state.step) == 5
    for name, p in st.params.items():
        assert torch.equal(cap.state.params[name], p), name
        assert torch.equal(cap.state.target_params[name],
                           st.target_params[name]), name
    for name in ("obs", "action", "reward", "next_obs", "done", "ptr", "size"):
        assert torch.equal(getattr(cap.state.buffer, name),
                           getattr(st.buffer, name)), name
    if per:
        assert torch.equal(cap.state.buffer.priority, st.buffer.priority)
    for name in ("spins", "energy", "best_energy", "temp", "step", "done"):
        assert torch.equal(getattr(cap.state.env_state, name),
                           getattr(st.env_state, name)), name
    assert float(cap.state.annealing_weight) == float(st.annealing_weight)


def test_guards_and_the_spins_observation():
    """More envs than slots raise (the JAX package takes it and writes a
    slot twice); obs_mode="spins" sizes the buffer and the Q-net from the
    env's width; the default device is the card."""
    _, tp = _problems()
    with pytest.raises(ValueError, match="buffer_size"):
        D.make_dqn(tp, E.EnvConfig(n_envs=B), D.DQNConfig(buffer_size=B - 1))
    cfg = E.EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8,
                      obs_mode="spins")
    init_fn, step_fn, model = D.make_dqn(
        tp, cfg, D.DQNConfig(buffer_size=32, batch_size=4, hidden_sizes=(16,)))
    st = init_fn()
    assert st.buffer.obs.shape[1] == E.obs_dim(tp, cfg) == model.dense[0].in_features
    st, m = step_fn(st)
    assert bool(torch.isfinite(st.obs).all()) and np.isfinite(float(m["loss"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            D.ReplayBuffer.create(4, 2)
