"""The captured drivers on the CPU: ``anneal``, ``anneal_scan``, ``pt.run``,
``time_to_target`` and PPO's ``train`` run their step through
``anneal.graphs.CapturedStep`` and its random tape (on the CPU the step runs
eagerly, with its draws served from the tape's static seed slots and
tensors), and must equal the eager loop of the same step bit for bit under
one seed. Also: the schedules take a device sweep counter, ``anneal_scan``
returns what the JAX function returns, and the tape refuses a step that
draws otherwise than it recorded.

+-J couplings with h on a quarter grid keep every field exact.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.anneal import sa as jsa  # noqa: E402
from spinglass_tpu.anneal import schedules as JS  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu_torch.anneal import graphs, pt, sa  # noqa: E402
from spinglass_tpu_torch.anneal import schedules as S  # noqa: E402
from spinglass_tpu_torch.anneal import engines  # noqa: E402
from spinglass_tpu_torch.anneal.engines import (CudaFusedEngine,  # noqa: E402
                                                GivenUniforms)
from spinglass_tpu_torch.anneal.twins import (TwinFusedEngine,  # noqa: E402
                                              TwinSparseTEngine)
from spinglass_tpu_torch.benchmarks import planted  # noqa: E402
from spinglass_tpu_torch.benchmarks.headline import eager_anneal  # noqa: E402
from spinglass_tpu_torch.core import rng, topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.kernels.sparse import (EllProblem,  # noqa: E402
                                                SortedSparseEngine,
                                                SortedSparseTEngine)
from spinglass_tpu_torch.rl import env as env_mod  # noqa: E402
from spinglass_tpu_torch.rl import ppo  # noqa: E402

GEOMETRIC = S.ScheduleConfig(S.ScheduleType.GEOMETRIC, initial_temp=4.0,
                             final_temp=0.1)
ADAPTIVE = S.ScheduleConfig(S.ScheduleType.ADAPTIVE, initial_temp=4.0,
                            final_temp=0.1)


def _dense(n=40, seed=3):
    j = topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return IsingProblem.from_dense(j, h, device="cpu")


def _ell(n=150, seed=2):
    coo = topology.sparse_random_graph_coo(n, avg_degree=4.0, dist="binary",
                                           seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return EllProblem.from_coo(n, *coo, h=h, device="cpu")


def _assert_states_equal(a, b):
    for name in ("spins", "energy", "best_energy", "best_spins", "acc_rate"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.sched.temp, b.sched.temp)
    assert torch.equal(a.sched.acc_ema, b.sched.acc_ema)
    assert int(a.sweep) == int(b.sweep)


@pytest.mark.parametrize("kind,schedule", [
    ("blocked", GEOMETRIC), ("blocked", ADAPTIVE), ("colored", GEOMETRIC),
    ("colored", ADAPTIVE), ("sparse", GEOMETRIC), ("sparse_t", ADAPTIVE)])
def test_anneal_equals_eager_loop(kind, schedule):
    """Four chunks (10, 10, 10 and a shorter 5: two graphs on one state)."""
    if kind == "colored":
        problem = IsingProblem.from_dense(topology.grid_2d(6, 6), device="cpu")
    elif kind.startswith("sparse"):
        problem = _ell()
    else:
        problem = _dense()
    cfg = sa.SAConfig(n_sweeps=35, n_replicas=4, record_interval=10,
                      schedule=schedule, sweep_method=kind,
                      enable_early_stop=False, seed=5)
    res = sa.anneal(problem, cfg)
    state, hist, engine = eager_anneal(problem, cfg)
    assert res.metadata["engine"] == engine.name
    np.testing.assert_array_equal(res.energy_history, hist[:, 0])
    np.testing.assert_array_equal(res.mean_energy_history, hist[:, 1])
    np.testing.assert_array_equal(res.temperature_history, hist[:, 2])
    np.testing.assert_array_equal(res.acceptance_history, hist[:, 3])
    np.testing.assert_array_equal(res.replica_best_energy,
                                  state.best_energy.numpy())
    best = int(torch.argmin(state.best_energy))
    np.testing.assert_array_equal(
        res.best_spins, engine.from_layout(state.best_spins)[best].numpy()[
            :problem.n_spins])
    assert res.n_sweeps == 35


def _fused_sparse(problem, kernel):
    return SortedSparseTEngine(problem, accept_kernel=kernel)


@pytest.mark.parametrize("make,r", [
    (lambda p: CudaFusedEngine(p, block_size=128), 4),
    (lambda p: TwinFusedEngine(p, block_size=128), 4),
    (lambda p: _fused_sparse(_ell(), "fused"), 128),
    (lambda p: _fused_sparse(_ell(), "single"), 128),
    (lambda p: TwinSparseTEngine(_ell()), 16)],
    ids=["K1 plain", "K1 twin", "K4 plain", "K2 plain", "sparse twin"])
def test_captured_chunk_feeds_seed_slots_to_kernel_engines(make, r):
    """The kernel engines' plain versions on the CPU take the tape's seed
    slots (read with int): three replays of the captured chunk equal three
    eager chunks, state and statistics."""
    engine = make(_dense())
    problem = engine.problem
    cfg = sa.SAConfig(n_replicas=r, n_sweeps=30, schedule=GEOMETRIC, seed=9)
    plain = sa.init_state(problem, cfg, engine)
    step = sa.capture_chunk(problem, cfg, engine,
                            sa.init_state(problem, cfg, engine), 3)
    # one draw a sweep: a seed slot, or (K2's CPU twin: host thresholds)
    # a device generator
    assert len(step.tape.entries) == 3
    for _ in range(3):
        plain, stats = sa.run_chunk(problem, cfg, engine, plain, 3)
        vec = step.replay()
        assert torch.equal(vec, torch.stack([stats[k] for k in sa.STAT_KEYS]))
    _assert_states_equal(step.state, plain)


def test_anneal_scan_matches_jax_contract_and_anneal():
    n = 32
    j = topology.fully_connected(n, dist="binary", seed=1)
    cfg = sa.SAConfig(n_sweeps=30, n_replicas=4, record_interval=10,
                      enable_early_stop=False, seed=3)
    state, hist = sa.anneal_scan(IsingProblem.from_dense(j, device="cpu"), cfg)
    jcfg = jsa.SAConfig(n_sweeps=30, n_replicas=4, record_interval=10)
    jstate, jhist = jsa.anneal_scan(JaxProblem.from_dense(jnp.asarray(j)), jcfg)
    assert sorted(hist) == sorted(jhist)
    for k in hist:
        assert tuple(hist[k].shape) == tuple(jhist[k].shape) == (3,), k
    assert ({f.name for f in dataclasses.fields(state)} - {"generator"}
            == {f.name for f in dataclasses.fields(jstate)} - {"key"})
    assert int(state.sweep) == int(jstate.sweep) == 30
    assert tuple(state.spins.shape) == tuple(jstate.spins.shape)
    res = sa.anneal(IsingProblem.from_dense(j, device="cpu"), cfg)
    np.testing.assert_array_equal(hist["best_energy"].numpy(),
                                  res.energy_history.astype(np.float32))
    np.testing.assert_array_equal(hist["temperature"].numpy(),
                                  res.temperature_history.astype(np.float32))
    np.testing.assert_array_equal(hist["acceptance"].numpy(),
                                  res.acceptance_history.astype(np.float32))
    assert float(state.best_energy.min()) == res.best_energy


@pytest.mark.parametrize("st", list(S.ScheduleType), ids=lambda s: s.value)
def test_schedule_update_takes_a_device_counter(st):
    """update(cfg, state, t) with t a 0-d int64 tensor equals the host-int
    form bit for bit, and the JAX update to float32 ulps."""
    fn = (lambda t: 3.0 / (1.0 + 0.5 * t)) if st == S.ScheduleType.CUSTOM \
        else None
    ours = S.ScheduleConfig(st, initial_temp=5.0, final_temp=0.05,
                            total_sweeps=300, custom_fn=fn)
    theirs = JS.ScheduleConfig(JS.ScheduleType(st.value), initial_temp=5.0,
                               final_temp=0.05, total_sweeps=300, custom_fn=fn)
    a = b = S.init_state(ours)
    c = JS.init_state(theirs)
    for t in (0, 1, 7, 150, 298, 299, 400):
        acc = torch.tensor(0.3 + 0.001 * t)
        a = S.update(ours, a, t, acc)
        b = S.update(ours, b, torch.tensor(t, dtype=torch.int64), acc)
        c = JS.update(theirs, c, jnp.int32(t), jnp.float32(acc.item()))
        assert torch.equal(a.temp, b.temp) and torch.equal(a.acc_ema, b.acc_ema)
        assert float(a.temp) == pytest.approx(float(c.temp), rel=1e-6)


def _pt_cfg(method="nearest_neighbor"):
    return pt.PTConfig(n_replicas=6, n_sweeps=30, exchange_interval=5,
                       min_temp=0.2, max_temp=3.0, exchange_method=method,
                       seed=4)


@pytest.mark.parametrize("method", ["nearest_neighbor", "all_pairs"])
def test_pt_run_equals_eager_loop(method):
    problem = _ell()
    cfg = _pt_cfg(method)
    res = pt.run(problem, cfg)
    super_step, _, engine = pt.make_pt_step(problem, cfg)
    state = pt.init_state(problem, cfg,
                          torch.Generator().manual_seed(cfg.seed), engine)
    hist = []
    for _ in range(cfg.n_sweeps // cfg.exchange_interval):
        state, stats = super_step(state)
        hist.append({k: v.clone() for k, v in stats.items()})
    np.testing.assert_array_equal(
        res.energy_history, torch.stack([h["best_energy"] for h in hist]))
    np.testing.assert_array_equal(
        res.metadata["slot_trajectory"],
        torch.stack([h["slot_of_replica"] for h in hist]))
    np.testing.assert_array_equal(
        res.metadata["slot_energy_history"],
        torch.stack([h["slot_energy"] for h in hist]))
    np.testing.assert_array_equal(res.replica_best_energy,
                                  state.best_energy.numpy())
    rates = (state.exch_accepts.numpy()
             / np.maximum(state.exch_attempts.numpy(), 1))
    np.testing.assert_array_equal(res.metadata["exchange_rates"], rates)


def test_pt_super_step_parity_alternates_under_capture():
    """Three replays of the captured super-step: the device counter gives
    parities 1, 0, 1, so odd pairs are tried twice and even pairs once, as
    in the eager loop; the states are equal."""
    problem = _dense()
    cfg = _pt_cfg()
    super_step, _, engine = pt.make_pt_step(problem, cfg)
    plain = pt.init_state(problem, cfg, torch.Generator().manual_seed(1),
                          engine)
    step = pt.capture_super_step(super_step, pt.init_state(
        problem, cfg, torch.Generator().manual_seed(1), engine))
    for _ in range(3):
        plain, _ = super_step(plain)
        step.replay()
    got = step.state
    assert got.exch_attempts.tolist() == [1, 2, 1, 2, 1]
    for name in ("spins", "slot", "energy", "best_energy", "best_spins",
                 "exch_attempts", "exch_accepts", "acc_rate"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    assert int(got.sweep) == plain.sweep == 15


def test_time_to_target_sweep_counts_equal_eager_loop():
    inst = planted.planted_gauge_coo(60, 4.0, seed=1)
    ell = EllProblem.from_coo(60, inst.rows, inst.cols, inst.vals,
                              device="cpu")
    cfg = pt.PTConfig(n_replicas=8, exchange_interval=5, min_temp=0.1,
                      max_temp=3.0)
    out = planted.time_to_target(ell, inst.e0, cfg, rel_gap=0.02,
                                 max_sweeps=400, seeds=[1, 2, 3])
    threshold = inst.e0 + 0.02 * abs(inst.e0)
    super_step, _, engine = pt.make_pt_step(ell, cfg)
    for seed, run in zip((1, 2, 3), out["per_seed"]):
        gen = torch.Generator().manual_seed(seed)
        state = pt.init_state(ell, cfg, gen, engine)
        n, best = 0, float("inf")
        while best > threshold and n < 400 // 5:
            state, stats = super_step(state)
            n += 1
            best = min(best, float(stats["best_energy"]))
        assert run["sweeps"] == 5 * n and run["best_energy"] == best, seed


PT_LEAVES = ("spins", "slot", "energy", "best_energy", "best_spins", "sweep",
             "exch_attempts", "exch_accepts", "acc_rate")


@pytest.mark.parametrize("case", ["first", "before_last", "at_last", "miss"])
def test_time_to_target_pipelined_equals_serial_loop(case):
    """The pipelined loop (replays queued ``DEPTH`` - 1 ahead of the read,
    the latch at the end of the captured super-step) against the eager
    serial loop of the same super-step under one seed: sweeps, best energy,
    every leaf of the captured state after the call (the state at the hit,
    sweep counter included) and the generator, bit for bit. Cases: a hit on
    the first super-step, one a super-step before the cap, one on the cap
    itself, and a miss; no replay launched beyond the cap, one discarded
    after a hit before the cap."""
    inst = planted.planted_gauge_coo(80, 4.0, seed=3, frustration=0.3)
    ell = EllProblem.from_coo(80, inst.rows, inst.cols, inst.vals,
                              device="cpu")
    cfg = pt.PTConfig(n_replicas=4, exchange_interval=3, min_temp=0.3,
                      max_temp=3.0)
    super_step, _, engine = pt.make_pt_step(ell, cfg)

    def serial(threshold, max_super):
        gen = torch.Generator().manual_seed(7)
        state = graphs.device_counter(pt.init_state(ell, cfg, gen, engine))
        n, best, bests = 0, float("inf"), []
        while best > threshold and n < max_super:
            state, stats = super_step(state)
            n += 1
            best = min(best, float(stats["best_energy"]))
            bests.append(best)
        return n, best, bests, state, gen

    # the best energy after each of 40 super-steps picks the thresholds
    _, _, bests, _, _ = serial(-float("inf"), 40)
    steps = [k + 1 for k in range(1, 40) if bests[k] < bests[k - 1]]
    assert len(steps) >= 2
    k = steps[1]                      # a hit after a strict improvement
    threshold, max_super = {
        "first": (bests[0], 40),
        "before_last": (bests[k - 1], k + 1),
        "at_last": (bests[k - 1], k),
        "miss": (bests[-1] - 1.0, 12)}[case]
    n, best, _, state, gen_serial = serial(threshold, max_super)
    assert n == {"first": 1, "before_last": k, "at_last": k,
                 "miss": 12}[case]
    graphs.clear_caches()
    gen = torch.Generator().manual_seed(7)
    out = planted.time_to_target(ell, threshold, cfg, rel_gap=0.0,
                                 max_sweeps=max_super * 3, generator=gen)
    assert out["sweeps"] == 3 * n and out["best_energy"] == best
    assert out["hit"] == (case != "miss")
    assert out["launched"] <= max_super
    assert out["discarded"] == (1 if case in ("first", "before_last")
                                else 0)
    assert out["launched"] == n + out["discarded"]
    _, captured = graphs.PT_CACHE.get(ell, ("time_to_target",
                                            graphs.config_key(cfg)))
    for name in PT_LEAVES:
        assert torch.equal(getattr(captured.state, name),
                           getattr(state, name)), name
    assert int(captured.state.sweep) == 3 * n
    assert torch.equal(gen.get_state(), gen_serial.get_state())
    graphs.clear_caches()


def _result_arrays(res):
    return [res.best_spins, res.replica_best_energy, res.energy_history,
            res.mean_energy_history, res.temperature_history,
            res.acceptance_history]


@pytest.mark.parametrize("kind", ["blocked", "sparse_t"])
def test_anneal_repeat_call_replays_the_cached_chunks(kind):
    """A second call on the same problem object and config captures
    nothing (a cache hit), copies its own start state in, and gives what a
    call after a cleared cache gives, with the call's own launch count; a
    different seed is a different run on the same entry."""
    problem = _ell() if kind == "sparse_t" else _dense()
    cfg = sa.SAConfig(n_sweeps=25, n_replicas=4, record_interval=10,
                      schedule=GEOMETRIC, sweep_method=kind,
                      enable_early_stop=False, seed=5)
    graphs.clear_caches()
    first = sa.anneal(problem, cfg)
    hits = graphs.SA_CACHE.hits
    other = sa.anneal(problem, dataclasses.replace(cfg, seed=6))
    again = sa.anneal(problem, cfg)
    # the seed is not part of the key: both calls replay the one entry
    assert graphs.SA_CACHE.hits == hits + 2 and len(graphs.SA_CACHE) == 1
    for a, b in zip(_result_arrays(first), _result_arrays(again)):
        np.testing.assert_array_equal(a, b)
    assert again.metadata["kernel_launches"] == first.metadata[
        "kernel_launches"]
    assert first.metadata["capture_seconds"] > 0.0
    assert again.metadata["capture_seconds"] == 0.0
    assert not np.array_equal(other.energy_history, first.energy_history)
    spins = sa.random_spins(torch.Generator().manual_seed(8),
                            (4, problem.n_padded), problem.active_mask)
    gen_a, gen_b = (torch.Generator().manual_seed(11) for _ in range(2))
    a = sa.anneal(problem, cfg, generator=gen_a, init_spins=spins)
    graphs.clear_caches()
    b = sa.anneal(problem, cfg, generator=gen_b, init_spins=spins)
    for x, y in zip(_result_arrays(a), _result_arrays(b)):
        np.testing.assert_array_equal(x, y)


def test_anneal_scan_repeat_call_returns_its_own_copies():
    problem = _dense()
    cfg = sa.SAConfig(n_sweeps=20, n_replicas=4, record_interval=10,
                      enable_early_stop=False, seed=3)
    graphs.clear_caches()
    s1, h1 = sa.anneal_scan(problem, cfg)
    kept = (s1.spins.clone(), h1["best_energy"].clone())
    gen = torch.Generator().manual_seed(99)
    s2, h2 = sa.anneal_scan(problem, cfg, generator=gen)
    assert s2.generator is gen
    assert torch.equal(s1.spins, kept[0])
    assert torch.equal(h1["best_energy"], kept[1])
    assert not torch.equal(s2.spins, s1.spins)
    graphs.clear_caches()
    s3, h3 = sa.anneal_scan(problem, cfg, generator=torch.Generator()
                            .manual_seed(99))
    _assert_states_equal(s2, s3)
    for k in h2:
        assert torch.equal(h2[k], h3[k]), k


def test_pt_run_repeat_call_takes_the_new_ladder():
    """The cached super-step reads its ladder from a tensor that each call
    fills: a repeat call with a ladder_override equals a first call with
    it."""
    problem = _ell()
    cfg = _pt_cfg()
    ladder = np.geomspace(0.3, 2.5, cfg.n_replicas).astype(np.float32)
    graphs.clear_caches()
    pt.run(problem, cfg)
    hit = pt.run(problem, cfg, ladder_override=ladder)
    graphs.clear_caches()
    miss = pt.run(problem, cfg, ladder_override=ladder)
    for a, b in zip(_result_arrays(hit), _result_arrays(miss)):
        np.testing.assert_array_equal(a, b)
    assert hit.metadata["ladder"] == miss.metadata["ladder"]
    np.testing.assert_array_equal(hit.metadata["slot_trajectory"],
                                  miss.metadata["slot_trajectory"])
    assert hit.metadata["exchange_rates"] == miss.metadata["exchange_rates"]


def test_time_to_target_repeat_call_equals_first():
    inst = planted.planted_gauge_coo(60, 4.0, seed=1)
    ell = EllProblem.from_coo(60, inst.rows, inst.cols, inst.vals,
                              device="cpu")
    cfg = pt.PTConfig(n_replicas=8, exchange_interval=5, min_temp=0.1,
                      max_temp=3.0)
    graphs.clear_caches()
    hits = graphs.PT_CACHE.hits
    runs = [planted.time_to_target(ell, inst.e0, cfg, rel_gap=0.02,
                                   max_sweeps=200, seeds=[1, 2])
            for _ in range(2)]
    assert graphs.PT_CACHE.hits == hits + 1
    assert ([(r["sweeps"], r["best_energy"]) for r in runs[0]["per_seed"]]
            == [(r["sweeps"], r["best_energy"]) for r in runs[1]["per_seed"]])


def _ppo_setup(mode):
    problem = _dense(24, 5)
    env_cfg = env_mod.EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=4,
                                action_mode=mode, init_temp_range=(0.2, 5.0))
    cfg = ppo.PPOConfig(rollout_len=3, n_epochs=2, n_minibatches=2,
                        hidden_sizes=(8,), n_updates=2, seed=7)
    return problem, env_cfg, cfg


@pytest.mark.parametrize("mode", ["discrete", "continuous", "hybrid"])
def test_ppo_updates_through_tape_equal_eager_loop(mode):
    problem, env_cfg, cfg = _ppo_setup(mode)
    out = ppo.train(problem, env_cfg, cfg)
    init_fn, update_fn, _ = ppo.make_ppo(problem, env_cfg, cfg)
    state = init_fn()
    hist = []
    for _ in range(cfg.n_updates):
        state, metrics = update_fn(state)
        hist.append({k: float(metrics[k]) for k in ppo.METRIC_KEYS})
    assert out["history"] == hist
    assert out["state"].update == state.update == 2
    for name, p in state.params.items():
        assert torch.equal(out["params"][name], p), name
    for name in ("spins", "energy", "best_energy", "temp", "step", "done"):
        assert torch.equal(getattr(out["state"].env_state, name),
                           getattr(state.env_state, name)), name


def test_updates_per_dispatch_equals_single_updates():
    """k = 2 over 3 updates (one single first, then a block of two) gives
    the parameters and history of three single updates."""
    problem, env_cfg, cfg = _ppo_setup("discrete")
    one = ppo.train(problem, env_cfg, dataclasses.replace(cfg, n_updates=3))
    two = ppo.train(problem, env_cfg, dataclasses.replace(
        cfg, n_updates=3, updates_per_dispatch=2))
    assert one["history"] == two["history"] and len(two["history"]) == 3
    assert len(two["update_times"]) == 3 and two["n_warmup"] == 2
    for name, p in one["params"].items():
        assert torch.equal(two["params"][name], p), name


def test_tape_refuses_a_step_that_draws_otherwise():
    calls = {"n": 0}
    gen = torch.Generator().manual_seed(0)

    def step(st):
        calls["n"] += 1
        shape = (3,) if calls["n"] <= 1 else (4,)
        u = rng.device_uniforms(st["g"], shape, "cpu")
        return {"x": st["x"] + u.sum(), "g": st["g"]}, None

    with pytest.raises(RuntimeError, match="drew rand"):
        graphs.CapturedStep(step, {"x": torch.zeros(()), "g": gen},
                            gen).replay()


def test_warm_up_launches_are_taken_back():
    """A step that counts a launch: warm-up leaves the ledger's count as it
    was, and the eager replays on the CPU count for themselves."""
    build.count_launches({"k": 5})
    before = build.launch_snapshot()
    gen = torch.Generator().manual_seed(0)

    def step(st):
        build.count_launches({"k": 1})
        return {"s": st["s"] + rng.draw_seed(st["g"]) % 7, "g": st["g"]}, None

    cap = graphs.CapturedStep(step, {"s": torch.zeros((), dtype=torch.int64),
                                     "g": gen}, gen)
    assert build.LAUNCHES["k"] == before["k"] and cap.tape.entries == ["seed"]
    assert cap.launches == {}
    ref = torch.Generator().manual_seed(0)
    cap.replay()
    cap.replay()
    want = sum(rng.host_seed(ref) % 7 for _ in range(2))
    assert build.launches_since(before, ["k"]) == {"k": 2}
    assert int(cap.state["s"]) == want


def test_captured_step_gives_back_and_replays_its_graphs_launches():
    """What a warm-up or a capture counts is given back (``_give_back``:
    the launches since a snapshot, taken out); a replay of a graph adds the
    graph's launches per replay, ``launches``, in one update of the
    ledger."""
    before = build.launch_snapshot()
    build.count_launches({"a": 3, "b": 1})
    assert graphs._give_back(before) == {"a": 3, "b": 1}
    assert build.launches_since(before, ["a", "b"]) == {"a": 0, "b": 0}
    gen = torch.Generator().manual_seed(0)

    def step(st):
        build.count_launches({"a": 2})
        return {"s": st["s"] + 1}, None

    cap = graphs.CapturedStep(step, {"s": torch.zeros(())}, gen)
    assert build.launches_since(before) == {}

    class Graph:            # a captured graph: its replay runs nothing here
        def replay(self):
            pass

    # a capture on the card keeps the launches it counted (here: one step's)
    cap.graph, cap.launches = Graph(), {"a": 2, "b": 1}
    for _ in range(3):
        cap.replay()
    assert build.launches_since(before, ["a", "b", "c"]) == {
        "a": 6, "b": 3, "c": 0}
    assert float(cap.state["s"]) == 0.0      # the graph ran nothing


def test_launch_ledger_counts_threads_exactly():
    """Eight threads counting at once: the ledger holds their exact sum."""
    before = build.launch_snapshot()

    def count():
        for _ in range(5000):
            build.count_launches({"threads": 1, "pairs": 2})

    threads = [threading.Thread(target=count) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert build.launches_since(before) == {"threads": 40000, "pairs": 80000}


def _engines():
    """name -> (engine, its problem)."""
    dense, ell = _dense(), _ell()
    return {"blocked": (engines.BlockedEngine(dense), dense),
            "cuda_fused": (CudaFusedEngine(dense, block_size=128), dense),
            "sparse_sorted": (SortedSparseEngine(ell), ell),
            "sparse_sorted_t": (SortedSparseTEngine(
                ell, accept_kernel="fused"), ell)}


K123 = ("sparse_sweep", "sparse_thresholds", "sparse_accept")


@pytest.mark.parametrize("name,want", [
    ("blocked", ()), ("cuda_fused", ("metropolis_sweep",)),
    ("sparse_sorted", ()), ("sparse_sorted_t", K123)])
def test_engine_kernel_names_give_the_drivers_launch_keys(name, want):
    """Each engine's ``kernel_names``, and the keys of ``kernel_launches``
    made from them: SA adds ``sa_track``; a PT super-step adds C2 and C1
    with cluster moves and the overlap kernel with ``measure_overlaps``;
    a given-uniform engine has its engine's."""
    eng, problem = _engines()[name]
    assert eng.kernel_names == want
    assert GivenUniforms(eng, np.zeros((1, 1, 1))).kernel_names == want
    assert sa.step_kernels(eng) == want + ("sa_track",)

    def pt_kernels(**kw):
        cfg = pt.PTConfig(n_replicas=4, **kw)
        return pt.make_pt_step(problem, cfg, engine=eng)[0].kernel_names

    assert pt_kernels() == want
    assert pt_kernels(cluster_moves=2) == want + ("sw_bonds", "sw_labels")
    assert pt_kernels(n_chains=2, measure_overlaps=True) == want + (
        "replica_overlap",)
    assert pt_kernels(n_chains=2, cluster_moves=1, measure_overlaps=True) \
        == want + ("sw_bonds", "sw_labels", "replica_overlap")


class _OneRankMesh:
    """A mesh of one rank, enough to build a sharded step (no group)."""

    def get_local_rank(self):
        return 0

    def size(self):
        return 1

    def get_group(self):
        return None


@pytest.mark.parametrize("kind", ["sparse_t", "blocked"])
def test_sharded_step_names_the_kernels_it_built(kind):
    """The sharded super-step's ``kernel_names`` are its engine's and, with
    cluster moves, C2's and C1's; it builds no overlap kernel, so
    ``measure_overlaps`` adds no key to ``pt_sharded.run``'s launches."""
    from spinglass_tpu_torch.distributed import pt_sharded

    problem = _ell() if kind == "sparse_t" else _dense()
    cfg = pt.PTConfig(n_replicas=4, n_chains=2, sweep_method=kind,
                      measure_overlaps=True)
    for moves, extra in ((0, ()), (1, ("sw_bonds", "sw_labels"))):
        step, _, _, eng, _ = pt_sharded.make_sharded_pt_step(
            problem, dataclasses.replace(cfg, cluster_moves=moves),
            _OneRankMesh())
        assert step.kernel_names == eng.kernel_names + extra


@pytest.mark.parametrize("kind,cluster_moves,overlaps", [
    ("sparse_t", 0, False), ("sparse_t", 1, False), ("sparse_t", 0, True),
    ("blocked", 1, True)])
def test_pt_run_reports_its_step_kernels(kind, cluster_moves, overlaps):
    """``pt.run``'s ``kernel_launches`` on the CPU: every kernel its step
    can launch, each at 0 (no kernel runs on CPU tensors)."""
    problem = _ell() if kind == "sparse_t" else _dense()
    cfg = pt.PTConfig(n_replicas=4, n_chains=2, n_sweeps=10,
                      exchange_interval=5, sweep_method=kind,
                      cluster_moves=cluster_moves, measure_overlaps=overlaps)
    want = (dict.fromkeys(K123, 0) if kind == "sparse_t" else {})
    if cluster_moves:
        want.update(sw_bonds=0, sw_labels=0)
    if overlaps:
        want["replica_overlap"] = 0
    assert pt.run(problem, cfg).metadata["kernel_launches"] == want
