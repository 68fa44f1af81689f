"""Port parity for the RL slice: reward shaping, the vectorised annealer
environment, PPO and its evaluation against ``spinglass_tpu.rl``.

Both packages get the same numpy inputs. The env instance is a +-J glass
with h on a quarter grid, so fields and energies are exact in float32 and
spins, counts and energies must be equal bit for bit; rewards and
observations go through log10, tanh and divisions, and agree to float32
rounding (the tolerance is written in each test). State and network
parameters cross through ``core.convert``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.anneal.engines import BlockedXLAEngine  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.research import validation as jval  # noqa: E402
from spinglass_tpu.rl import env as jenv  # noqa: E402
from spinglass_tpu.rl import evaluate as jev  # noqa: E402
from spinglass_tpu.rl import ppo as jppo  # noqa: E402
from spinglass_tpu.rl import rewards as jrew  # noqa: E402
from spinglass_tpu_torch.anneal import engines, pt  # noqa: E402
from spinglass_tpu_torch.benchmarks import headline  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.convert import (  # noqa: E402
    actor_critic_from_flax, env_state_from_numpy, problem_from_numpy)
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402
from spinglass_tpu_torch.rl import env as E  # noqa: E402
from spinglass_tpu_torch.rl import evaluate as V  # noqa: E402
from spinglass_tpu_torch.rl import ppo as P  # noqa: E402
from spinglass_tpu_torch.rl import rewards as R  # noqa: E402

N, B = 48, 8
MODES = ("discrete", "continuous", "hybrid")


def _problems(n=N, seed=3):
    """The +-J instance with h on a quarter grid, in both packages."""
    j = topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    jp = JaxProblem.from_dense(j, h)
    tp = problem_from_numpy(np.asarray(jp.j), np.asarray(jp.h),
                            np.asarray(jp.active_mask), jp.n_spins,
                            device="cpu")
    return jp, tp


def _carry(jstate):
    """A JAX EnvState as the port's, on the CPU."""
    d = {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate) if f.name != "reward_state"}
    rs = {f.name: np.asarray(getattr(jstate.reward_state, f.name))
          for f in dataclasses.fields(jstate.reward_state)}
    return env_state_from_numpy(**d, reward_state=rs, device="cpu")


def _actions(mode, rng, b=B):
    """(JAX action, port action) of one mode; the sweep fractions leave
    some envs with a spent budget."""
    idx = rng.integers(0, E.N_ACTIONS, b).astype(np.int32)
    frac = np.linspace(0.05, 1.1, b).astype(np.float32)
    if mode == "discrete":
        return jnp.asarray(idx), torch.tensor(idx)
    if mode == "continuous":
        a = np.stack([rng.uniform(0.3, 2.3, b).astype(np.float32), frac], -1)
        return jnp.asarray(a), torch.tensor(a)
    return ({"temp_index": jnp.asarray(idx), "sweep_frac": jnp.asarray(frac)},
            {"temp_index": torch.tensor(idx), "sweep_frac": torch.tensor(frac)})


def _assert_state_equal(js, ts, exact=("spins", "energy", "best_energy",
                                       "prev_energy", "initial_energy",
                                       "step", "plateau", "episode", "done",
                                       "acc_rate")):
    for name in exact:
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy(), err_msg=name)
    # temperatures: a clipped float32 product; the reward state: float32
    # divisions and EMAs (rtol 1e-6), its count table exact
    np.testing.assert_allclose(np.asarray(js.temp), ts.temp.numpy(), rtol=1e-6)
    for f in dataclasses.fields(js.reward_state):
        a = np.asarray(getattr(js.reward_state, f.name))
        b = getattr(ts.reward_state, f.name).numpy()
        if f.name == "novelty_counts":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=f.name)


# ---------------------------------------------------------------------------
# rewards
# ---------------------------------------------------------------------------

REWARD_CONFIGS = {
    "default": {},
    "curriculum": dict(curriculum=True, curriculum_stages=4,
                       difficulty_ramp=2.0),
    "smoothing": dict(smoothing=0.6),
    "all_weights": dict(energy_weight=0.7, acceptance_weight=0.3,
                        temperature_weight=0.4, exploration_weight=0.5,
                        convergence_weight=0.6, efficiency_weight=0.2),
}


@pytest.mark.parametrize("name", list(REWARD_CONFIGS))
def test_rewards_compute_chained_matches_jax(name):
    """``compute`` over 5 chained steps: novelty bins and counts exact,
    rewards and the carried state rtol 1e-5 (atol 1e-6 near zero)."""
    kw = REWARD_CONFIGS[name]
    jcfg, tcfg = jrew.RewardConfig(**kw), R.RewardConfig(**kw)
    js, ts = jrew.init_state(jcfg, B), R.init_state(tcfg, B, device="cpu")
    rng = np.random.default_rng(11)
    e0 = -rng.uniform(20, 40, B).astype(np.float32)
    prev = e0.copy()
    for step in range(1, 6):
        energy = (prev - rng.integers(-8, 12, B) / 4.0).astype(np.float32)
        if step == 3:
            energy[:3] = prev[:3]   # a revisited signature
        arrays = dict(
            energy=energy, prev_energy=prev,
            best_energy=np.minimum(prev, energy), initial_energy=e0,
            acc_rate=rng.uniform(0, 1, B).astype(np.float32),
            temp=(np.float32(2.0) * rng.choice(E.TEMP_MULTIPLIERS, B)
                  if step != 3 else np.full(B, 2.0, np.float32)),
            step=np.full(B, step, np.int32),
            improved=energy < prev,
            mult=rng.choice(E.TEMP_MULTIPLIERS, B),
            episode=rng.integers(0, 1200, B).astype(np.int32))
        jb = jrew._novelty_bin(*(jnp.asarray(arrays[k]) for k in (
            "energy", "initial_energy", "temp", "mult")))
        tb = R._novelty_bin(*(torch.tensor(arrays[k]) for k in (
            "energy", "initial_energy", "temp", "mult")))
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        counts_before = ts.novelty_counts.clone()
        jr, js = jrew.compute(jcfg, js, max_steps=10, **{
            k: jnp.asarray(v) for k, v in arrays.items()})
        tr, ts_new = R.compute(tcfg, ts, max_steps=10, **{
            k: torch.tensor(v) for k, v in arrays.items()})
        assert torch.equal(ts.novelty_counts, counts_before)  # not mutated
        ts = ts_new
        np.testing.assert_allclose(np.asarray(jr), tr.numpy(), rtol=1e-5,
                                   atol=1e-6)
        for f in dataclasses.fields(js):
            a, b = np.asarray(getattr(js, f.name)), getattr(ts, f.name).numpy()
            if f.name == "novelty_counts":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        prev = energy
    assert ts.novelty_counts.sum() == 5 * B


def test_rewards_without_mult_and_episode():
    """The optional arguments default as in the JAX function."""
    jcfg, tcfg = (c(curriculum=True) for c in (jrew.RewardConfig,
                                               R.RewardConfig))
    arrays = dict(energy=np.full(4, -10.5, np.float32),
                  prev_energy=np.full(4, -10.0, np.float32),
                  best_energy=np.full(4, -10.5, np.float32),
                  initial_energy=np.full(4, -5.0, np.float32),
                  acc_rate=np.full(4, 0.3, np.float32),
                  temp=np.full(4, 5.0, np.float32),
                  step=np.full(4, 2, np.int32), improved=np.ones(4, bool))
    jr, _ = jrew.compute(jcfg, jrew.init_state(jcfg, 4), max_steps=10,
                         **{k: jnp.asarray(v) for k, v in arrays.items()})
    tr, _ = R.compute(tcfg, R.init_state(tcfg, 4, device="cpu"), max_steps=10,
                      **{k: torch.tensor(v) for k, v in arrays.items()})
    np.testing.assert_allclose(np.asarray(jr), tr.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# env: observe, decode, step, auto_reset, reset
# ---------------------------------------------------------------------------

def _stepped_states(mode="discrete", **cfg_kw):
    """A JAX state after one step (so every field is non-trivial), and the
    same state in the port."""
    jp, tp = _problems()
    jcfg = jenv.EnvConfig(n_envs=B, sweeps_per_step=2, max_steps=7,
                          action_mode=mode, **cfg_kw)
    tcfg = E.EnvConfig(n_envs=B, sweeps_per_step=2, max_steps=7,
                       action_mode=mode, **cfg_kw)
    key = jax.random.key(5)
    js, _ = jenv.reset(jp, jcfg, key)
    ja, _ = _actions(mode, np.random.default_rng(2))
    js, _, _, _ = jenv.step(jp, jcfg, js, ja, jax.random.key(6))
    return jp, tp, jcfg, tcfg, js, _carry(js)


@pytest.mark.parametrize("obs_mode", ["global", "spins"])
def test_observe_and_obs_dim_match_jax(obs_mode):
    """Observations rtol 1e-5, atol 1e-6 (log10, tanh and a z-score over the
    batch with the population deviation); the widths equal."""
    jp, tp, jcfg, tcfg, js, ts = _stepped_states(obs_mode=obs_mode)
    assert E.obs_dim(tp, tcfg) == jenv.obs_dim(jp, jcfg)
    jo, to = jenv.observe(jp, jcfg, js), E.observe(tp, tcfg, ts)
    assert tuple(to.shape) == (B, E.obs_dim(tp, tcfg))
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="obs_mode"):
        E.obs_dim(tp, E.EnvConfig(obs_mode="pixels"))


@pytest.mark.parametrize("mode", MODES)
def test_decode_action_matches_jax(mode):
    """Multipliers and clipped sweep fractions: exact."""
    ja, ta = _actions(mode, np.random.default_rng(4))
    jm, jf = jenv._decode_action(jenv.EnvConfig(action_mode=mode), ja)
    tm, tf = E._decode_action(E.EnvConfig(action_mode=mode), ta)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    with pytest.raises(ValueError):
        E._decode_action(E.EnvConfig(action_mode="other"), ta)


def _step_uniforms(key, s, shape):
    """The uniforms the JAX ``step`` draws under ``key``, sweep by sweep."""
    keys = jax.random.split(key, s)
    return torch.tensor(np.stack([np.asarray(jax.random.uniform(
        keys[i], shape, jnp.float32)) for i in range(s)]))


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_jax_under_shared_uniforms(mode):
    """Two chained steps of the JAX ``step(engine=None)`` under keys k
    against the port's ``step`` fed the uniforms those keys give: spins,
    counts (through acc_rate), energies, step / plateau counters and done
    bit for bit; rewards and observations rtol 1e-5 (atol 1e-6)."""
    jp, tp = _problems()
    kw = dict(n_envs=B, sweeps_per_step=4, max_steps=2, action_mode=mode,
              init_temp_range=(0.2, 5.0))
    jcfg, tcfg = jenv.EnvConfig(**kw), E.EnvConfig(**kw)
    js, _ = jenv.reset(jp, jcfg, jax.random.key(1))
    ts = _carry(js)
    rng = np.random.default_rng(8)
    for t in range(2):
        key = jax.random.key(20 + t)
        ja, ta = _actions(mode, rng)
        js, jo, jr, jd = jenv.step(jp, jcfg, js, ja, key)
        u = _step_uniforms(key, 4, (B, jp.n_padded))
        ts, to, tr, td = E.step(tp, tcfg, ts, ta, None, uniforms=u)
        _assert_state_equal(js, ts)
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        np.testing.assert_allclose(np.asarray(jr), tr.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert bool(td.all())   # max_steps = 2 reached


@pytest.mark.parametrize("mode", ["discrete", "continuous"])
def test_step_through_blocked_engine_matches_jax(mode):
    """The engine-plumbed env: the JAX step through ``BlockedXLAEngine``
    against the port's through ``BlockedEngine`` on the same uniforms, and
    both equal to the engine-less step: spins bit for bit, rewards rtol
    1e-5."""
    jp, tp = _problems()
    kw = dict(n_envs=B, sweeps_per_step=3, max_steps=9, action_mode=mode)
    jcfg, tcfg = jenv.EnvConfig(**kw), E.EnvConfig(**kw)
    jeng = BlockedXLAEngine(jp, block_size=jcfg.block_size)
    teng = engines.BlockedEngine(tp, block_size=tcfg.block_size)
    js, _ = jenv.reset(jp, jcfg, jax.random.key(2), jeng)
    ts = _carry(js)
    key = jax.random.key(9)
    ja, ta = _actions(mode, np.random.default_rng(1))
    js1, _, jr, _ = jenv.step(jp, jcfg, js, ja, key, jeng)
    u = _step_uniforms(key, 3, (B, jp.n_padded))
    ts1, _, tr, _ = E.step(tp, tcfg, ts, ta, None, teng, uniforms=u)
    ts2, _, tr2, _ = E.step(tp, tcfg, ts, ta, None, None, uniforms=u)
    _assert_state_equal(js1, ts1)
    assert torch.equal(ts1.spins, ts2.spins) and torch.equal(tr, tr2)
    np.testing.assert_allclose(np.asarray(jr), tr.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_step_with_generator_runs_engine_and_fallback():
    """Without explicit uniforms the sweeps draw from the host generator:
    equal under equal seeds, through the engine and through the fallback
    (the blocked engine draws its uniforms as the fallback does)."""
    _, tp = _problems()
    cfg = E.EnvConfig(n_envs=B, sweeps_per_step=2, max_steps=5)
    eng = E.default_engine(tp, cfg)
    assert isinstance(eng, engines.BlockedEngine)   # a CPU problem
    out = []
    for engine in (eng, None, eng):
        gen = torch.Generator().manual_seed(3)
        state, _ = E.reset(tp, cfg, gen, engine)
        action = torch.full((B,), 2)
        state, obs, reward, _ = E.step(tp, cfg, state, action, gen, engine)
        out.append((state.spins, reward))
        assert tuple(obs.shape) == (B, E.OBS_DIM)
        assert bool(torch.isfinite(reward).all())
    assert all(torch.equal(out[0][0], o[0]) and torch.equal(out[0][1], o[1])
               for o in out[1:])
    with pytest.raises(ValueError, match="explicit uniforms"):
        ell = S.EllProblem.from_problem(tp)
        scfg = E.EnvConfig(n_envs=4, sweeps_per_step=1)
        seng = E.default_engine(ell, scfg)
        st, _ = E.reset(ell, scfg, torch.Generator().manual_seed(0), seng)
        E.step(ell, scfg, st, torch.zeros(4, dtype=torch.long), None, seng,
               uniforms=torch.rand(1, 4, ell.n_padded))


class _InPlaceFlipEngine:
    """A stub engine that, like the CUDA kernels, writes the new spins over
    the old: every sweep flips every spin of every env in place."""

    name = "stub"

    def __init__(self, layout):
        self.layout = layout

    def to_layout(self, spins_rn):
        s = spins_rn.t() if self.layout == "nr" else spins_rn
        return s.clone(memory_format=torch.contiguous_format)

    def from_layout(self, spins):
        return spins.t() if self.layout == "nr" else spins

    def energy(self, spins):
        return torch.zeros(spins.shape[1 if self.layout == "nr" else 0])

    def sweep(self, spins, beta, generator):
        spins.neg_()
        r = beta.shape[0]
        return spins, torch.zeros(r), torch.full((r,), N, dtype=torch.int32)


@pytest.mark.parametrize("layout", ["rn", "nr"])
@pytest.mark.parametrize("mode", ["continuous", "hybrid"])
def test_sweep_frac_gate_with_engine_that_writes_in_place(mode, layout):
    """Envs whose sweep budget is spent keep their spins although the
    engine writes in place: with 4 sweeps per step, an env at fraction 0.25
    is flipped once and one at 1.0 four times."""
    _, tp = _problems()
    cfg = E.EnvConfig(n_envs=4, sweeps_per_step=4, max_steps=9,
                      action_mode=mode)
    gen = torch.Generator().manual_seed(0)
    state, _ = E.reset(tp, cfg, gen)
    frac = torch.tensor([0.25, 0.5, 0.75, 1.0])
    action = (torch.stack([torch.ones(4), frac], -1) if mode == "continuous"
              else {"temp_index": torch.zeros(4, dtype=torch.long),
                    "sweep_frac": frac})
    before = state.spins.clone()
    new, _, _, _ = E.step(tp, cfg, state, action, gen,
                          _InPlaceFlipEngine(layout))
    sign = torch.tensor([-1.0, 1.0, -1.0, 1.0])[:, None]
    assert torch.equal(new.spins, before * sign)
    assert torch.equal(state.spins, before)       # the old state is intact
    # counts: N per active sweep, over max(round(frac * 4), 1) sweeps
    np.testing.assert_allclose(new.acc_rate.numpy(), 1.0)


def test_auto_reset_mixes_by_done_and_keeps_episode_counter():
    """Done envs restart (fresh spins, counters at 0, reward state fresh)
    and the others are untouched; the episode counter counts completed
    episodes in both packages."""
    jp, tp, jcfg, tcfg, js, ts = _stepped_states()
    done = np.array([True, False] * (B // 2))
    episode = np.arange(B, dtype=np.int32)
    js = js.replace(done=jnp.asarray(done), episode=jnp.asarray(episode))
    ts = ts.replace(done=torch.tensor(done), episode=torch.tensor(episode))
    jm, _ = jenv.auto_reset(jp, jcfg, js, jax.random.key(3))
    tm, tobs = E.auto_reset(tp, tcfg, ts, torch.Generator().manual_seed(3))
    for name in ("step", "plateau", "episode", "done"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(tm, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(tm.episode.numpy(), episode + done)
    keep = torch.tensor(~done)
    for f in dataclasses.fields(ts):
        if f.name == "reward_state":
            for g in dataclasses.fields(ts.reward_state):
                a = getattr(tm.reward_state, g.name)
                assert torch.equal(a[keep], getattr(ts.reward_state,
                                                    g.name)[keep]), g.name
            continue
        if f.name != "episode":
            assert torch.equal(getattr(tm, f.name)[keep],
                               getattr(ts, f.name)[keep]), f.name
    fresh = torch.tensor(done)
    from spinglass_tpu_torch.core.energy import energy
    assert torch.equal(tm.energy[fresh], energy(tp, tm.spins)[fresh])
    assert torch.equal(tm.best_energy[fresh], tm.energy[fresh])
    assert float(tm.reward_state.novelty_counts[fresh].sum()) == 0.0
    assert bool((tm.reward_state.prev_temp[fresh] == -1.0).all())
    assert bool((tm.spins[:, N:] == 1.0).all())       # padding stays +1
    assert torch.equal(tobs, E.observe(tp, tcfg, tm))


def test_reset_draws_start_temperatures_in_range():
    """``init_temp_range`` draws per-env log-uniform start temperatures
    inside the range and spread out; ``initial_temp`` otherwise."""
    p = IsingProblem.from_dense(
        topology.fully_connected(16, dist="binary", seed=1), device="cpu")
    cfg = E.EnvConfig(n_envs=64, init_temp_range=(0.1, 10.0))
    state, obs = E.reset(p, cfg, torch.Generator().manual_seed(0))
    t = state.temp.numpy()
    assert t.min() >= 0.1 and t.max() <= 10.0 and t.std() > 0.5
    assert abs(np.log(t).mean() - 0.0) < 0.5      # log-uniform about 1.0
    assert obs.shape == (64, E.OBS_DIM) and state.spins.dtype == torch.float32
    assert set(np.unique(state.spins.numpy())) == {-1.0, 1.0}
    state2, _ = E.reset(p, E.EnvConfig(n_envs=8, initial_temp=2.0),
                        torch.Generator().manual_seed(0))
    np.testing.assert_allclose(state2.temp.numpy(), 2.0)


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

def _jax_tree(jparams):
    return jax.tree.map(np.asarray, jparams)


def _models(mode, hidden=(16, 12), obs_dim=E.OBS_DIM, seed=0):
    jmodel = jppo.ActorCritic(action_mode=mode, hidden_sizes=hidden)
    obs = np.random.default_rng(seed).normal(size=(6, obs_dim)).astype(
        np.float32)
    jparams = jmodel.init(jax.random.key(seed), jnp.asarray(obs))
    tmodel = actor_critic_from_flax(_jax_tree(jparams), mode, hidden,
                                    device="cpu")
    return jmodel, jparams, tmodel, obs


@pytest.mark.parametrize("mode", MODES)
def test_actor_critic_forward_matches_flax(mode):
    """flax parameters carried across: distribution and value rtol 1e-5."""
    jmodel, jparams, tmodel, obs = _models(mode)
    jdist, jvalue = jmodel.apply(jparams, jnp.asarray(obs))
    tdist, tvalue = tmodel(torch.tensor(obs))
    assert set(jdist) == set(tdist)
    for k in jdist:
        np.testing.assert_allclose(np.asarray(jdist[k]),
                                   tdist[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(np.asarray(jvalue), tvalue.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Dense layers"):
        actor_critic_from_flax(_jax_tree(jparams), mode, (16,), device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_log_prob_and_entropy_match_jax(mode):
    """On fixed distributions and actions: rtol 1e-5."""
    rng = np.random.default_rng(6)
    dist = {"logits": rng.normal(size=(B, 10)).astype(np.float32)}
    if mode == "continuous":
        dist = {"mean": rng.normal(size=(B, 2)).astype(np.float32),
                "log_std": np.full((B, 2), -0.7, np.float32)}
    elif mode == "hybrid":
        dist.update(mean=rng.normal(size=B).astype(np.float32),
                    log_std=np.full(B, -0.3, np.float32))
    ja, ta = _actions(mode, rng)
    _, jlogp, jent = jppo.make_policy(mode)
    tsample, tlogp, tent = P.make_policy(mode)
    jd = {k: jnp.asarray(v) for k, v in dist.items()}
    td = {k: torch.tensor(v) for k, v in dist.items()}
    np.testing.assert_allclose(np.asarray(jlogp(jd, ja)), tlogp(td, ta).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jent(jd)), tent(td).numpy(),
                               rtol=1e-5)
    # a sample has the action's structure and a finite log-probability
    a = tsample(td, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(tlogp(td, a)).all())
    with pytest.raises(ValueError):
        P.make_policy("other")


def test_categorical_sampling_follows_the_logits():
    logits = torch.log(torch.tensor([0.1, 0.2, 0.7])).repeat(20000, 1)
    sample, _, _ = P.make_policy("discrete")
    a = sample({"logits": logits}, torch.Generator().manual_seed(1))
    freq = np.bincount(a.numpy(), minlength=3) / 20000
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.015)


def test_gae_matches_numpy_transcription():
    """GAE on fixed [T, B] arrays against a numpy transcription of the JAX
    reverse scan: rtol 1e-6."""
    rng = np.random.default_rng(9)
    t, b = 7, 5
    reward = rng.normal(size=(t, b)).astype(np.float32)
    value = rng.normal(size=(t, b)).astype(np.float32)
    done = rng.random((t, b)) < 0.3
    last = rng.normal(size=b).astype(np.float32)
    cfg = P.PPOConfig(gamma=0.97, gae_lambda=0.9)
    adv_next, v_next = np.zeros(b, np.float32), last
    want = np.zeros((t, b), np.float32)
    for i in reversed(range(t)):
        nonterm = 1.0 - done[i].astype(np.float32)
        delta = reward[i] + cfg.gamma * v_next * nonterm - value[i]
        adv_next = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
        v_next = value[i]
        want[i] = adv_next
    advs, rets = P.gae(cfg, torch.tensor(reward), torch.tensor(value),
                       torch.tensor(done), torch.tensor(last))
    np.testing.assert_allclose(advs.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rets.numpy(), want + value, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_minibatch_steps_match_jax_optax(mode):
    """Three clipped-surrogate Adam steps on fixed minibatches against a JAX
    step built from the JAX package's ActorCritic, make_policy and optax
    chain (clip_by_global_norm then adam): loss and its parts rtol 1e-4,
    parameters rtol 1e-4 (atol 1e-6; torch's clip scales by
    max_norm / (norm + 1e-6), optax by max_norm / norm)."""
    cfg = P.PPOConfig(lr=1e-2, max_grad_norm=0.5, clip_eps=0.2,
                      entropy_coef=0.01, value_coef=0.5)
    jmodel, jparams, tmodel, _ = _models(mode, seed=2)
    _, jlogp, jent = jppo.make_policy(mode)
    _, tlogp, tent = P.make_policy(mode)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.lr))
    opt_state = tx.init(jparams)

    def jloss(params, batch):
        dist, value = jmodel.apply(params, batch["obs"])
        ratio = jnp.exp(jlogp(dist, batch["action"]) - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        clipped = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        policy_loss = -jnp.mean(jnp.minimum(ratio * adv, clipped))
        value_loss = jnp.mean((value - batch["ret"]) ** 2)
        entropy = jnp.mean(jent(dist))
        return (policy_loss + cfg.value_coef * value_loss
                - cfg.entropy_coef * entropy), dict(
                    policy_loss=policy_loss, value_loss=value_loss,
                    entropy=entropy)

    @jax.jit
    def jstep(params, opt_state, batch):
        (loss, aux), grads = jax.value_and_grad(jloss, has_aux=True)(params,
                                                                     batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, loss, aux,
                optax.global_norm(grads))

    tparams = dict(tmodel.named_parameters())
    opt = P.make_optimizer(cfg, tparams)
    rng = np.random.default_rng(12)
    for _ in range(3):
        ja, ta = _actions(mode, rng, b=16)
        arrays = dict(obs=rng.normal(size=(16, E.OBS_DIM)).astype(np.float32),
                      logp=rng.normal(-2.0, 0.3, 16).astype(np.float32),
                      adv=rng.normal(size=16).astype(np.float32),
                      ret=rng.normal(0, 5, 16).astype(np.float32))
        jb = {k: jnp.asarray(v) for k, v in arrays.items()}
        jb["action"] = ja
        tb = {k: torch.tensor(v) for k, v in arrays.items()}
        tb["action"] = ta
        jparams, opt_state, jl, jaux, gnorm = jstep(jparams, opt_state, jb)
        assert float(gnorm) > cfg.max_grad_norm      # the clip acts
        tl, _ = P.ppo_loss(cfg, tmodel, tparams, tb, tlogp, tent)
        taux = P.minibatch_step(cfg, tmodel, tparams, opt, tb, tlogp, tent)
        np.testing.assert_allclose(float(jl), float(tl.detach()), rtol=1e-4)
        for k in jaux:
            np.testing.assert_allclose(float(jaux[k]), float(taux[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    tree = _jax_tree(jparams)["params"]
    for k, layer in enumerate(tmodel.dense):
        np.testing.assert_allclose(tree[f"Dense_{k}"]["kernel"].T,
                                   layer.weight.detach().numpy(), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(tree[f"Dense_{k}"]["bias"],
                                   layer.bias.detach().numpy(), rtol=1e-4,
                                   atol=1e-6)
    if mode != "discrete":
        np.testing.assert_allclose(tree["log_std"],
                                   tmodel.log_std.detach().numpy(), rtol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_learn_matches_the_jax_update(mode):
    """The JAX package's own ``update_fn`` for one update (one epoch, one
    minibatch: the whole rollout in one Adam step) against the port's
    ``learn`` on the same trajectory. The JAX rollout is replayed outside
    the jitted update from the state's key, as ``rollout`` splits it, and
    its mean reward must be the update's own; the port then takes that
    trajectory with the parameters carried across. This holds the port's
    GAE, flattening, loss and optimiser to the JAX update itself: the loss
    parts rtol 1e-4, the parameters after the step rtol 1e-4 with atol
    5e-5. Adam's first step moves a weight by lr * g / (|g| + 1e-8), which
    is +-lr = 1e-2 wherever the gradient is not tiny (a wrong sign or
    advantage shows as 2e-2), and follows float32 rounding where the
    gradient is within rounding of 0, as for a weight on an observation
    feature that stays near 0: 5e-5 is half a hundredth of lr."""
    jp, tp = _problems()
    kw = dict(n_envs=B, sweeps_per_step=2, max_steps=3, action_mode=mode,
              init_temp_range=(0.2, 5.0))
    jcfg, tcfg = jenv.EnvConfig(**kw), E.EnvConfig(**kw)
    pkw = dict(rollout_len=4, n_epochs=1, n_minibatches=1, lr=1e-2, seed=5,
               hidden_sizes=(16, 12), gamma=0.97, gae_lambda=0.9)
    jcfg_p, tcfg_p = jppo.PPOConfig(**pkw), P.PPOConfig(**pkw)
    jinit, jupdate, jmodel = jppo.make_ppo(jp, jcfg, jcfg_p, engine=None)
    js = jinit()
    jsample, jlogp, _ = jppo.make_policy(mode)
    env_state, obs, key = js.env_state, js.obs, js.key
    steps = []
    for _ in range(4):
        key, k_act, k_env, k_reset = jax.random.split(key, 4)
        dist, value = jmodel.apply(js.params, obs)
        action = jsample(dist, k_act)
        step = dict(obs=obs, action=action, logp=jlogp(dist, action),
                    value=value)
        env_state, _, step["reward"], step["done"] = jenv.step(
            jp, jcfg, env_state, action, k_env, None)
        env_state, obs = jenv.auto_reset(jp, jcfg, env_state, k_reset, None)
        steps.append(step)
    _, last_value = jmodel.apply(js.params, obs)
    js1, jmetrics = jupdate(js)
    rewards = np.stack([np.asarray(s_["reward"]) for s_ in steps])
    dones = np.stack([np.asarray(s_["done"]) for s_ in steps])
    np.testing.assert_allclose(float(jmetrics["mean_reward"]), rewards.mean(),
                               rtol=1e-5)       # the replay is the rollout
    assert dones.any() and not dones.all()      # episodes end inside it

    def carry(x):
        return torch.tensor(np.asarray(x))

    traj = {k: (({n: torch.stack([carry(s_[k][n]) for s_ in steps])
                  for n in steps[0][k]}) if isinstance(steps[0][k], dict)
                else torch.stack([carry(s_[k]) for s_ in steps]))
            for k in steps[0]}
    _, tupdate, _ = P.make_ppo(tp, tcfg, tcfg_p, engine=None)
    carried = actor_critic_from_flax(_jax_tree(js.params), mode, (16, 12),
                                     device="cpu")
    params = dict(carried.named_parameters())
    state = P.TrainState(params=params, opt=P.make_optimizer(tcfg_p, params),
                         env_state=_carry(env_state), obs=carry(obs),
                         generator=torch.Generator().manual_seed(0), update=0)
    state, tmetrics = tupdate.learn(state, traj, carry(last_value))
    assert state.update == 1
    for k in ("mean_reward", "mean_best_energy", "policy_loss", "value_loss",
              "entropy"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    tree = _jax_tree(js1.params)["params"]
    for k, layer in enumerate(carried.dense):
        np.testing.assert_allclose(tree[f"Dense_{k}"]["kernel"].T,
                                   layer.weight.detach().numpy(), rtol=1e-4,
                                   atol=5e-5)
        np.testing.assert_allclose(tree[f"Dense_{k}"]["bias"],
                                   layer.bias.detach().numpy(), rtol=1e-4,
                                   atol=5e-5)
    if mode != "discrete":
        np.testing.assert_allclose(tree["log_std"],
                                   carried.log_std.detach().numpy(), rtol=1e-4,
                                   atol=5e-5)


def test_init_params_is_lecun_normal_with_zero_biases():
    """The start the JAX package's flax ``Dense`` gives: kernels of variance
    1 / fan_in cut at two deviations of the uncut normal, biases zero,
    log_std -0.7; equal seeds give equal parameters."""
    model = P.ActorCritic(64, "continuous", hidden_sizes=(256, 128))
    params = P.init_params(model, torch.Generator().manual_seed(0))
    again = P.init_params(model, torch.Generator().manual_seed(0))
    assert all(torch.equal(params[k], again[k]) for k in params)
    assert all(v.requires_grad for v in params.values())
    w = params["dense.1.weight"].detach()
    assert tuple(w.shape) == (128, 256)
    np.testing.assert_allclose(float(w.std()), np.sqrt(1 / 256), rtol=0.03)
    assert float(w.abs().max()) <= 2.0 * np.sqrt(1 / 256) / 0.87962566 + 1e-6
    assert float(params["dense.1.bias"].detach().abs().max()) == 0.0
    np.testing.assert_allclose(params["log_std"].detach().numpy(), -0.7)
    jparams = jppo.ActorCritic(action_mode="continuous",
                               hidden_sizes=(256, 128)).init(
        jax.random.key(0), jnp.zeros((1, 64)))
    jw = np.asarray(jparams["params"]["Dense_1"]["kernel"])
    np.testing.assert_allclose(float(w.std()), jw.std(), rtol=0.03)
    np.testing.assert_allclose(float(w.abs().max()), np.abs(jw).max(),
                               rtol=0.02)


def _sk(n=32, seed=0):
    j = topology.fully_connected(n, dist="gaussian", scale=1 / np.sqrt(n),
                                 seed=seed)
    return IsingProblem.from_dense(j, device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_train_two_updates_dense(mode):
    """``train`` on the CPU: the JAX package's keys in the returned dict,
    finite metrics, the blocked engine, and updates_per_dispatch accepted
    without effect."""
    env_cfg = E.EnvConfig(n_envs=8, sweeps_per_step=2, max_steps=10,
                          action_mode=mode)
    cfg = P.PPOConfig(rollout_len=4, n_epochs=1, n_minibatches=2, n_updates=2,
                      hidden_sizes=(32,), updates_per_dispatch=8)
    out = P.train(_sk(), env_cfg, cfg)
    assert {"params", "state", "history", "env_steps_per_second",
            "env_steps_per_second_incl_compile", "total_time", "update_times",
            "final_mean_best_energy"} <= set(out)
    assert len(out["history"]) == len(out["update_times"]) == 2
    assert set(out["history"][0]) == {"mean_reward", "mean_best_energy",
                                      "policy_loss", "value_loss", "entropy"}
    assert all(np.isfinite(v) for h in out["history"] for v in h.values())
    assert out["state"].update == 2 and out["engine"] == "blocked"
    assert out["kernel_launches"] == {}      # no kernel on the CPU
    assert out["final_mean_best_energy"] == out["history"][-1][
        "mean_best_energy"]
    state = out["state"].env_state
    assert bool((state.best_energy <= state.energy).all())


def test_train_resumes_from_a_state():
    env_cfg = E.EnvConfig(n_envs=4, sweeps_per_step=1, max_steps=6)
    cfg = P.PPOConfig(rollout_len=2, n_epochs=1, n_minibatches=1, n_updates=2,
                      hidden_sizes=(8,))
    p = _sk()
    first = P.train(p, env_cfg, cfg)
    more = P.train(p, env_cfg, dataclasses.replace(cfg, n_updates=3),
                   resume_state=first["state"])
    assert len(more["history"]) == 1 and more["state"].update == 3
    done = P.train(p, env_cfg, cfg, resume_state=more["state"])
    assert done["history"] == [] and np.isnan(done["final_mean_best_energy"])


def test_ppo_over_sparse_ellproblem():
    """PPO against a 200-spin ``EllProblem`` through the sorted sparse
    engine (the JAX suite's criterion: finite reward, and the env anneals
    the sparse problem)."""
    coo = topology.sparse_random_graph_coo(200, avg_degree=5.0,
                                           dist="gaussian", seed=11)
    ell = S.EllProblem.from_coo(200, *coo, device="cpu")
    env_cfg = E.EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=8)
    cfg = P.PPOConfig(rollout_len=3, n_epochs=1, n_minibatches=2, n_updates=1,
                      hidden_sizes=(16,))
    init_fn, update_fn, _ = P.make_ppo(ell, env_cfg, cfg)
    assert update_fn.engine.name == "sparse_sorted"
    state = init_fn()
    e0 = float(state.env_state.energy.mean())
    state, m = update_fn(state)
    assert np.isfinite(float(m["mean_reward"]))
    assert float(m["mean_best_energy"]) < e0


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------

def test_geometric_action_index_matches_jax():
    for kw, target, n_steps in (
            (dict(), 0.05, None), (dict(initial_temp=5.0, max_steps=20), 0.1, None),
            (dict(init_temp_range=(0.05, 50.0), max_steps=30), 0.05, None),
            (dict(init_temp_range=(0.1, 20.0)), 0.01, 12),
            (dict(initial_temp=0.5), 2.0, 5)):
        assert (V.geometric_action_index(E.EnvConfig(**kw), target, n_steps)
                == jev.geometric_action_index(jenv.EnvConfig(**kw), target,
                                              n_steps))
    policy = V.make_geometric_policy(E.EnvConfig(), 0.05)
    a = policy(torch.zeros(5, E.OBS_DIM), None)
    assert a.tolist() == [V.geometric_action_index(E.EnvConfig(), 0.05)] * 5


def test_welch_t_matches_jax_package():
    rng = np.random.default_rng(0)
    for a, b in ((rng.normal(0, 1, 8), rng.normal(0.5, 2, 6)),
                 (np.ones(4), np.ones(4)), (rng.normal(-3, 1, 5),
                                            rng.normal(3, 1, 5))):
        assert V.welch_t(a, b) == jval.welch_t(a, b)


def test_rollout_best_energy_takes_no_auto_reset():
    """Equal budget: exactly n_steps * sweeps_per_step sweeps through the
    engine, one reset, and no env restarts although all are done early."""
    p = _sk()
    env_cfg = E.EnvConfig(n_envs=6, sweeps_per_step=3, max_steps=4,
                          plateau_patience=1)

    class Counting(engines.BlockedEngine):
        sweeps = 0

        def sweep(self, spins, beta, generator):
            Counting.sweeps += 1
            return super().sweep(spins, beta, generator)

    eng = Counting(p)
    best = V.rollout_best_energy(p, env_cfg, V.make_random_policy(),
                                 torch.Generator().manual_seed(0), engine=eng,
                                 n_steps=7)
    assert Counting.sweeps == 7 * 3 and tuple(best.shape) == (6,)
    report, results = V.evaluate_controllers(
        p, env_cfg, {"geometric": V.make_geometric_policy(env_cfg),
                     "random": V.make_random_policy()}, n_seeds=3)
    assert set(report) == {"mean_best_energy", "per_seed",
                           "geometric_vs_random"}
    assert len(results["random"]) == 3
    again, _ = V.evaluate_controllers(
        p, env_cfg, {"geometric": V.make_geometric_policy(env_cfg),
                     "random": V.make_random_policy()}, n_seeds=3)
    assert again == report                      # seeds do not depend on hash()


def test_ppo_policy_is_greedy_or_sampled():
    model = P.ActorCritic(E.OBS_DIM, hidden_sizes=(8,))
    params = P.init_params(model, torch.Generator().manual_seed(0))
    obs = torch.randn(5, E.OBS_DIM, generator=torch.Generator().manual_seed(1))
    dist, _ = torch.func.functional_call(model, params, (obs,))
    greedy = V.make_ppo_policy(model, params)(obs, None)
    assert greedy.tolist() == dist["logits"].argmax(-1).tolist()
    sampled = V.make_ppo_policy(model, params, greedy=False)(
        obs, torch.Generator().manual_seed(2))
    assert sampled.dtype == torch.int32 and tuple(sampled.shape) == (5,)


@pytest.mark.slow
def test_trained_ppo_beats_geometric_and_random():
    """The JAX package's learning criterion at its own size, through the
    port's ``learning_report``: the trained controller beats the fixed
    geometric schedule and the random policy at an equal sweep budget, with
    Welch-t significance, and the learning curve moves."""
    p = _sk(32, 0)
    env_cfg = E.EnvConfig(n_envs=32, sweeps_per_step=4, max_steps=30,
                          init_temp_range=(0.05, 50.0),
                          plateau_patience=10 ** 9)
    cfg = P.PPOConfig(n_updates=80, rollout_len=16, lr=1e-3,
                      hidden_sizes=(64, 64), seed=0, entropy_coef=0.003)
    rep = V.learning_report(p, env_cfg, cfg, n_seeds=8, engine=None)
    means = rep["mean_best_energy"]
    assert means["trained_ppo"] < means["geometric"], means
    assert rep["trained_ppo_vs_geometric"]["p_value"] < 0.01
    assert means["trained_ppo"] < means["random"], means
    assert rep["trained_ppo_vs_random"]["p_value"] < 1e-6
    curve = np.asarray(rep["learning_curve"])
    assert curve[-5:].mean() < curve[:5].mean()


# ---------------------------------------------------------------------------
# the bench's protocol, the default device, and the repairs to the engines
# ---------------------------------------------------------------------------

def test_window_rates_protocol():
    """Warm-up left out, three windows, the remainder in the last, the
    median reported; one window below six steady updates."""
    times = [9.0, 9.0] + [1.0] * 3 + [2.0] * 3 + [4.0] * 5
    sps, rates = headline.window_rates(times, steps_per_update=8)
    assert rates == [8.0, 4.0, 8 * 5 / 20.0] and sps == 4.0
    sps, rates = headline.window_rates([5.0, 5.0, 1.0, 3.0], 10)
    assert rates == [20 / 4.0] and sps == 5.0
    with pytest.raises(ValueError, match="warm-up"):
        headline.window_rates([1.0, 1.0], 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        headline.bench_rl(n_updates=3)


def test_rl_defaults_to_the_card_and_cpu_must_be_asked_for():
    assert not torch.cuda.is_available()
    # engine=None is the plain sweep: refused for a problem on the card
    # (a stand-in here: the check reads the problem's device and no more)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    for call in (lambda: E.reset(on_card, E.EnvConfig(), None),
                 lambda: E.step(on_card, E.EnvConfig(), None, None, None),
                 lambda: E.auto_reset(on_card, E.EnvConfig(), None, None)):
        with pytest.raises(ValueError, match="default_engine"):
            call()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        R.init_state(R.RewardConfig(), 4)
    jparams = jppo.ActorCritic(hidden_sizes=(8,)).init(
        jax.random.key(0), jnp.zeros((1, E.OBS_DIM)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        actor_critic_from_flax(_jax_tree(jparams), hidden_sizes=(8,))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        env_state_from_numpy(*([np.zeros(2)] * 11), reward_state={})


def _small_ell():
    coo = topology.sparse_random_graph_coo(100, avg_degree=4.0, seed=1)
    return S.EllProblem.from_coo(100, *coo, device="cpu")


def test_sorted_t_engine_takes_single_rows_per_step():
    """The JAX constructor's argument and its error. The port's single-call
    sweep has no row step, so every accepted value sweeps alike."""
    ell = _small_ell()
    with pytest.raises(ValueError, match="single_rows_per_step must be 8, 16 "
                                         "or 32"):
        S.SortedSparseTEngine(ell, single_rows_per_step=12)
    spins = torch.ones(128, ell.n_padded)
    beta = torch.full((128,), 0.7)
    out = []
    for rps in (8, 16, 32):
        eng = S.SortedSparseTEngine(ell, accept_kernel="single",
                                    single_rows_per_step=rps)
        s, de, cnt = eng.sweep(eng.to_layout(spins), beta,
                               torch.Generator().manual_seed(5))
        out.append((s, de, cnt))
    assert int(out[0][2].sum()) > 0
    assert all(torch.equal(a, b) for o in out[1:] for a, b in zip(out[0], o))


def test_twin_engines_sweep_as_the_engines_do_for_cpu_tensors():
    """The twin engines (``anneal.twins``) draw the seeds the engines draw
    and sweep through the kernels' plain versions, which is what the engines
    themselves do for tensors on the CPU where they key Philox with the
    seed there too (the dense engine, and the sparse one on its per-colour
    accept path): equal bit for bit on +-J couplings (every field exact),
    no launch."""
    from spinglass_tpu_torch.anneal import twins

    _, tp = _problems()
    ell = S.EllProblem.from_coo(100, *topology.sparse_random_graph_coo(
        100, avg_degree=4.0, dist="binary", seed=1), device="cpu")
    pairs = [(engines.CudaFusedEngine(tp, block_size=128),
              twins.TwinFusedEngine(tp, block_size=128), 8, tp.n_padded),
             (S.SortedSparseTEngine(ell, accept_kernel="fused"),
              twins.TwinSparseTEngine(ell, accept_kernel="fused"), 128,
              ell.n_padded)]
    for eng, twin, r, npad in pairs:
        out = []
        for e in (eng, twin):
            gen = torch.Generator().manual_seed(4)
            s = e.to_layout(torch.ones(r, npad))
            for _ in range(2):
                s, de, cnt = e.sweep(s, torch.full((r,), 0.4), gen)
            out.append((s, de, cnt))
        assert int(out[0][2].sum()) > 0
        assert all(torch.equal(a, b) for a, b in zip(*out))
        assert not any(twin.launches.values())


@pytest.mark.parametrize("accept_kernel", ["single", "fused", "auto"])
def test_state_dtype_says_what_to_layout_gives(accept_kernel):
    """At a K2 width (128) and a K4 width (64): ``state_dtype(r)`` is the
    dtype of ``to_layout``'s tensor, while ``spin_dtype`` keeps reading
    float32 once the single-sweep tables exist."""
    eng = S.SortedSparseTEngine(_small_ell(), accept_kernel=accept_kernel)
    spins = {r: torch.ones(r, eng.ell.n_padded) for r in (128, 64)}
    for r, s in spins.items():
        assert eng.to_layout(s).dtype == eng.state_dtype(r)
        assert eng.from_layout(eng.to_layout(s)).dtype == torch.float32
    if accept_kernel == "single":
        assert eng.state_dtype(128) == torch.float32
        assert eng.state_dtype(64) == torch.int8
        assert eng.spin_dtype == torch.float32
    else:       # K4 and the CPU's "auto" (the threshold path): int8 throughout
        assert eng.state_dtype(128) == eng.state_dtype(64) == torch.int8


def test_pt_resume_without_checkpoint_dir_is_a_value_error(tmp_path):
    ell = _small_ell()
    with pytest.raises(ValueError, match="resume=True requires "
                                         "checkpoint_dir"):
        pt.run(ell, pt.PTConfig(n_replicas=4, n_sweeps=5), resume=True)
    with pytest.raises(NotImplementedError):
        pt.run(ell, pt.PTConfig(n_replicas=4, n_sweeps=5),
               checkpoint_dir=str(tmp_path), resume=True)
