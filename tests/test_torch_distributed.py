"""The port's distributed layer against spinglass_tpu.distributed, and the
drivers' lock.

One 2-rank gloo group is spawned for the module (``tests/torch_dist_child.py``,
which imports the port only): the sharded PT super-steps on the JAX key
chain's uniforms, ``pt_sharded.run`` on its own draws, the model-sharded
sweeps, two sharded PPO updates and the multihost helpers. The JAX side runs
here, on tests/conftest.py's 8 virtual CPU devices. +-J couplings with h on
a quarter grid make every field exact, so spins, slots and energies compare
bit for bit.
"""

import json
import os
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.anneal import pt as jpt  # noqa: E402
from spinglass_tpu.core import topology as jtopo  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JIsing  # noqa: E402
from spinglass_tpu.distributed import model_sharded as JMS  # noqa: E402
from spinglass_tpu.distributed import pt_sharded as jpt_sharded  # noqa: E402
from spinglass_tpu.kernels import sparse as JS  # noqa: E402
from spinglass_tpu.kernels import sweeps as JK  # noqa: E402
from spinglass_tpu_torch.anneal import pt, sa  # noqa: E402
from spinglass_tpu_torch.anneal.engines import BlockedEngine  # noqa: E402
from spinglass_tpu_torch.benchmarks import planted  # noqa: E402
from spinglass_tpu_torch.core import rng, topology  # noqa: E402
from spinglass_tpu_torch.core.convert import pt_state_from_numpy  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.distributed import multihost  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402
from spinglass_tpu_torch.kernels import sweeps as K  # noqa: E402
from spinglass_tpu_torch.rl import env as env_mod  # noqa: E402
from spinglass_tpu_torch.rl import ppo as ppo_mod  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 3   # super-steps on given uniforms
STATE_KEYS = ("spins", "slot", "energy", "best_energy", "best_spins",
              "exch_attempts", "exch_accepts")
STAT_KEYS = ("best_energy", "cold_energy", "slot_energy", "slot_of_replica")


# -- the drivers' lock ---------------------------------------------------------

def _pm_j(n, seed):
    j = topology.fully_connected(n, dist="binary", seed=seed)
    return IsingProblem.from_dense(j, device="cpu")


def _threaded(fn, seeds):
    """fn(seed) for each seed, all at once from one thread each: (results,
    errors)."""
    out, errors = {}, []

    def work(s):
        try:
            out[s] = fn(s)
        except Exception as exc:   # recorded: the test asserts there is none
            errors.append(repr(exc))

    threads = [threading.Thread(target=work, args=(s,)) for s in seeds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, errors


def _same_result(a, b):
    return (a.best_energy == b.best_energy
            and np.array_equal(a.best_spins, b.best_spins)
            and np.array_equal(a.energy_history, b.energy_history)
            and np.array_equal(a.mean_energy_history, b.mean_energy_history)
            and np.array_equal(a.acceptance_history, b.acceptance_history))


def test_threaded_anneals_equal_their_sequential_calls():
    """Eight threads call ``sa.anneal`` at once on one problem and config
    (one cached captured step), seeds 0-7: no call raises, and each result
    equals the same seed's call made alone, bit for bit."""
    p = _pm_j(64, 0)

    def cfg(s):
        return sa.SAConfig(n_sweeps=100, n_replicas=8, seed=s)

    seq = {s: sa.anneal(p, cfg(s)) for s in range(8)}
    out, errors = _threaded(lambda s: sa.anneal(p, cfg(s)), range(8))
    assert not errors, errors
    assert all(_same_result(out[s], seq[s]) for s in range(8))


def test_threaded_pt_runs_equal_their_sequential_calls():
    p = _pm_j(48, 1)

    def cfg(s):
        return pt.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=5,
                           seed=s)

    seq = {s: pt.run(p, cfg(s)) for s in range(8)}
    out, errors = _threaded(lambda s: pt.run(p, cfg(s)), range(8))
    assert not errors, errors
    for s in range(8):
        assert _same_result(out[s], seq[s]), s
        np.testing.assert_array_equal(out[s].metadata["slot_trajectory"],
                                      seq[s].metadata["slot_trajectory"])


# -- the rank's view of the draws ----------------------------------------------

def test_fold_seed_keeps_rank_zero_and_folds_slots_as_ints():
    assert rng.fold_seed(12345, 0) == 12345
    seeds = [rng.fold_seed(12345, r) for r in range(4)]
    assert len(set(seeds)) == 4 and all(0 <= s < 2 ** 62 for s in seeds)
    big = 2 ** 62 - 3
    for r in (1, 2, 3):
        slot = torch.tensor(big, dtype=torch.int64)
        assert int(rng.fold_seed(slot, r)) == rng.fold_seed(big, r)


@pytest.mark.parametrize("axis", [0, 1])
def test_shard_stream_draws_its_slice_of_the_groups_draw(axis):
    """Each rank's device draws are its slice of the one-device draw of the
    group's width; the host generators stay in step; seeds fold."""
    shape = (6, 4) if axis == 0 else (4, 6)
    full = rng.device_uniforms(torch.Generator().manual_seed(3),
                               (12, 4) if axis == 0 else (4, 12), "cpu")
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    parts = [rng.device_uniforms(rng.ShardStream(g, r, 2, axis), shape, "cpu")
             for r, g in enumerate(gens)]
    assert torch.equal(torch.cat(parts, dim=axis), full)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    bits = [rng.random_bits(rng.ShardStream(torch.Generator().manual_seed(5),
                                            r, 2, axis), shape)
            for r in range(2)]
    assert torch.equal(torch.cat(bits, dim=axis), rng.random_bits(
        torch.Generator().manual_seed(5), full.shape))
    g1 = torch.Generator().manual_seed(9)
    assert rng.draw_seed(rng.ShardStream(g1, 0, 2)) == rng.draw_seed(
        torch.Generator().manual_seed(9))


def test_one_rank_stream_is_the_generator_itself():
    g = torch.Generator().manual_seed(1)
    dg = rng.device_generator(rng.ShardStream(g, 0, 1), "cpu")
    assert isinstance(dg, torch.Generator)
    perm = rng.randperm(10, rng.device_generator(
        rng.ShardStream(torch.Generator().manual_seed(2), 1, 2), "cpu"),
        "cpu")
    assert torch.equal(perm, rng.randperm(10, rng.device_generator(
        torch.Generator().manual_seed(2), "cpu"), "cpu"))


# -- multihost helpers without a group ------------------------------------------

def test_local_replica_slice_without_a_group():
    assert multihost.local_replica_slice(64) == slice(0, 64)


def test_scaling_report_matches_jax():
    from spinglass_tpu.distributed import multihost as jmh

    for args in (([1.0e9, 0.9e9],), ([1.0e9, 0.9e9], 1.0e9), ([2.0], 0.0),
                 ([],)):
        assert multihost.scaling_report(*args) == jmh.scaling_report(*args)
    rep = multihost.scaling_report([1.0e9, 0.9e9])
    assert rep["n_hosts"] == 2 and 0.9 < rep["efficiency"] <= 1.0


# -- the JAX side and the spawn ---------------------------------------------

class _JaxKeyUniforms(JS.SortedSparseTEngine):
    """Test-only JAX T engine: sweeps with uniforms drawn from the sweep key
    by ``sweep_with_uniforms``, so the host can replay them."""

    def sweep(self, spins_t, beta, key):
        u = jax.random.uniform(key, (self.n_sorted, spins_t.shape[1]),
                               jnp.float32)
        return self.sweep_with_uniforms(spins_t, beta, u)


def _dense_inputs(n=64, seed=4):
    j = jtopo.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-4, 5, n) / 4.0
    return j, h


def _sparse_inst(seed=11):
    return planted.planted_gauge_coo(200, 5.0, seed=seed, frustration=0.2,
                                     magnitude="ones")


PT_KW = dict(n_replicas=8, n_chains=2, exchange_interval=5, min_temp=0.2,
             max_temp=4.0, seed=3)


def _jax_sharded(kind, monkeypatch_engine):
    """Three JAX sharded super-steps on the 8 virtual devices, with the
    uniforms each sweep and exchange draws replayed from the key chain on
    the host (global order: device d's columns at [2d, 2d + 2))."""
    if kind == "dense":
        j, h = _dense_inputs()
        prob = JIsing.from_dense(j, h)
        kw = dict(PT_KW, sweep_method="blocked", use_pallas="never")
    else:
        inst = _sparse_inst()
        prob = JS.EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                      inst.vals)
        kw = dict(PT_KW, sweep_method="sparse_t")
        monkeypatch_engine(lambda *a, **k: _JaxKeyUniforms(prob))
    cfg = jpt.PTConfig(**kw)
    mesh = jpt_sharded.make_mesh(jax.devices())
    n_dev = mesh.devices.size
    step, init, _, engine, _ = jpt_sharded.make_sharded_pt_step(prob, cfg,
                                                                mesh)
    assert (kind == "dense") != isinstance(engine,
                                           jpt_sharded.ShardedSortedTEngine)
    st = init(jax.random.key(5))
    start = {k: np.asarray(getattr(st, k)) for k in STATE_KEYS}
    r_total = cfg.n_replicas * cfg.n_chains
    us, xus, states, stats = [], [], [], []
    for _ in range(N_STEPS):
        key = st.key
        for _ in range(cfg.exchange_interval):
            key, ku = jax.random.split(key)
            if kind == "dense":
                us.append(np.asarray(jax.random.uniform(
                    ku, (r_total, prob.n_padded), jnp.float32)))
            else:
                per = r_total // n_dev
                us.append(np.concatenate([np.asarray(jax.random.uniform(
                    jax.random.fold_in(ku, d), (engine.inner.n_sorted, per),
                    jnp.float32)) for d in range(n_dev)], axis=1))
        key, kx = jax.random.split(key)
        xus.append(np.asarray(jax.random.uniform(
            kx, (cfg.n_chains, cfg.n_replicas - 1))))
        st, stat = step(st)
        states.append({k: np.asarray(getattr(st, k))
                       for k in STATE_KEYS + ("acc_rate",)})
        stats.append({k: np.asarray(v) for k, v in stat.items()})
    return dict(kw=kw, start=start, u=np.stack(us), xu=np.stack(xus),
                states=states, stats=stats, n_dev=n_dev, engine=engine)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_runs():
    mp = pytest.MonkeyPatch()
    try:
        runs = {kind: _jax_sharded(kind, lambda fn: mp.setattr(
            jpt_sharded, "make_engine", fn)) for kind in ("dense", "sparse")}
    finally:
        mp.undo()
    return runs


PT_RUN = {   # pt_sharded.run on its own draws, against pt.run
    "rd_": dict(kind="dense", cfg=dict(n_replicas=8, n_sweeps=30,
                                       exchange_interval=5,
                                       sweep_method="blocked", seed=7)),
    "rs_": dict(kind="sparse", n=200,
                cfg=dict(n_replicas=8, n_chains=2, n_sweeps=30,
                         exchange_interval=5, sweep_method="sparse_t",
                         exchange_method="all_pairs", seed=8)),
}
PPO = dict(env=dict(n_envs=8, sweeps_per_step=2, max_steps=6,
                    plateau_patience=3),
           ppo=dict(hidden_sizes=[16, 16], rollout_len=4, n_epochs=2,
                    n_minibatches=2, seed=3),
           updates=2)


def _model_inputs():
    rng_np = np.random.default_rng(0)
    n = 1024 - 50
    j = jtopo.fully_connected(n, dist="binary", seed=0)
    h = rng_np.integers(-4, 5, n) / 4.0
    pb = JIsing.from_dense(j, h)
    spins_b = np.where(rng_np.random((3, pb.n_padded)) < 0.5, -1.0, 1.0)
    spins_b[:, n:] = 1.0
    u_b = rng_np.random((3, pb.n_padded)).astype(np.float32)
    jc = jtopo.grid_2d(32, 32, dist="binary", seed=1)
    colors = jtopo.greedy_coloring(jc)
    masks = np.asarray(JK.color_masks_from_colors(colors, 1024))
    spins_c = np.where(rng_np.random((3, 1024)) < 0.5, -1.0, 1.0)
    u_c = rng_np.random((3, 1024)).astype(np.float32)
    return dict(mb_j=j, mb_h=h, mb_spins=spins_b.astype(np.float32),
                mb_u=u_b, mb_beta=np.float32(0.8), mc_j=jc, mc_masks=masks,
                mc_spins=spins_c.astype(np.float32), mc_u=u_c,
                mc_beta=np.float32(0.8))


@pytest.fixture(scope="module")
def spawned(jax_runs, tmp_path_factory):
    """Both ranks' outputs (dicts of arrays), from one spawn of the 2-rank
    gloo group."""
    d = tmp_path_factory.mktemp("dist2")
    arrays, spec = {}, {"pt_given": {}, "pt_run": {}, "ppo": PPO}
    for kind, p in (("dense", "gd_"), ("sparse", "gs_")):
        run = jax_runs[kind]
        kw = {k: v for k, v in run["kw"].items() if k != "use_pallas"}
        spec["pt_given"][p] = dict(kind=kind, cfg=kw, steps=N_STEPS, n=200)
        st = run["start"]
        arrays.update({p + "spins": st["spins"], p + "slot": st["slot"],
                       p + "energy": st["energy"],
                       p + "att": st["exch_attempts"],
                       p + "acc": st["exch_accepts"], p + "u": run["u"],
                       p + "xu": run["xu"]})
    j, h = _dense_inputs()
    arrays.update(gd_j=j, gd_h=h, rd_j=j, rd_h=h)
    inst = _sparse_inst()
    for p in ("gs_", "rs_"):
        arrays.update({p + "rows": inst.rows, p + "cols": inst.cols,
                       p + "vals": inst.vals})
    spec["pt_run"] = PT_RUN
    arrays.update(_model_inputs())
    arrays["ppo_j"] = topology.fully_connected(32, dist="binary", seed=6)
    np.savez(d / "in.npz", **arrays)
    (d / "spec.json").write_text(json.dumps(spec))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_child.py"),
         str(r), "2", str(port), str(d)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]


def _joined(spawned, key, axis):
    return np.concatenate([spawned[r][key] for r in range(2)], axis=axis)


# -- sharded PT on given uniforms ---------------------------------------------

def _port_one_rank(kind, run):
    """The port's one-rank super-steps (``pt.make_pt_step``) on the same
    uniforms from the same start state."""
    kw = {k: v for k, v in run["kw"].items() if k != "use_pallas"}
    cfg = pt.PTConfig(**kw)
    queue = [u for u in run["u"]]
    if kind == "dense":
        j, h = _dense_inputs()
        prob = IsingProblem.from_dense(j, h, device="cpu")

        class Given(BlockedEngine):
            def sweep(self, spins, beta, generator):
                return self.sweep_with_uniforms(
                    spins, beta, torch.as_tensor(queue.pop(0)))

        eng = Given(prob, block_size=cfg.block_size)
        layout, dtype = "rn", np.float32
    else:
        inst = _sparse_inst()
        prob = S.EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                     inst.vals, device="cpu")

        class Given(S.SortedSparseTEngine):
            def sweep(self, spins, beta, generator):
                return self.sweep_with_uniforms(
                    spins, beta, torch.as_tensor(queue.pop(0)))

        eng = Given(prob)
        layout, dtype = "nr", np.int8
    step, _, _ = pt.make_pt_step(prob, cfg, engine=eng)
    st0 = run["start"]
    st = pt_state_from_numpy(st0["spins"], st0["slot"], st0["energy"],
                             st0["energy"], st0["spins"], 0,
                             st0["exch_attempts"], st0["exch_accepts"],
                             src_layout=layout, layout=layout,
                             spin_dtype=dtype, device="cpu")
    ex_u = [x for x in run["xu"]]
    orig = pt._exchange_draws
    pt._exchange_draws = lambda cfg, gen, dev: (None,
                                                torch.as_tensor(ex_u.pop(0)))
    states, stats = [], []
    try:
        for _ in range(N_STEPS):
            st, stat = step(st)
            states.append({k: getattr(st, k).numpy().copy()
                           for k in STATE_KEYS + ("acc_rate",)})
            stats.append({k: v.numpy().copy() for k, v in stat.items()})
    finally:
        pt._exchange_draws = orig
    assert not queue and not ex_u
    return states, stats


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_two_ranks_equal_jax_sharded_pt_and_the_one_rank_port(
        kind, jax_runs, spawned):
    """Three super-steps (5 sweeps, the gather, the exchange, the resync;
    2 chains of 8 replicas): the 2-rank sharded step (ranks joined along the
    replica axis), the JAX sharded step on 8 devices and the port's one-rank
    ``make_pt_step`` agree on slots, energies, spins and the stats, step by
    step, bit for bit."""
    run = jax_runs[kind]
    p = "gd_" if kind == "dense" else "gs_"
    axis = 0 if kind == "dense" else 1
    one_states, one_stats = _port_one_rank(kind, run)
    for k in range(N_STEPS):
        for name in STATE_KEYS:
            if name in ("exch_attempts", "exch_accepts"):
                two = spawned[0][f"{p}s{k}_{name}"]
                np.testing.assert_array_equal(two, spawned[1][f"{p}s{k}_{name}"])
            else:
                two = _joined(spawned, f"{p}s{k}_{name}",
                              axis if "spins" in name else 0)
            np.testing.assert_array_equal(two, run["states"][k][name],
                                          f"{name} step {k}")
            np.testing.assert_array_equal(two, one_states[k][name],
                                          f"{name} step {k}")
        acc = _joined(spawned, f"{p}s{k}_acc_rate", 0)
        np.testing.assert_array_equal(acc, one_states[k]["acc_rate"])
        # XLA turns cnt / n_spins into cnt * (1 / n_spins): last-bit rounding
        np.testing.assert_allclose(acc, run["states"][k]["acc_rate"],
                                   rtol=2e-7)
        for name in STAT_KEYS:
            for r in range(2):
                np.testing.assert_array_equal(
                    spawned[r][f"{p}s{k}_stat_{name}"], run["stats"][k][name],
                    f"{name} step {k}")
                np.testing.assert_array_equal(
                    spawned[r][f"{p}s{k}_stat_{name}"], one_stats[k][name])
        np.testing.assert_array_equal(spawned[0][f"{p}s{k}_stat_mean_acceptance"],
                                      one_stats[k]["mean_acceptance"])
    assert int(spawned[0][f"{p}s2_exch_accepts"].sum()) > 0


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_jax_sharded_engine_kinds(kind, jax_runs):
    """The JAX references took the paths the port's wrappers mirror: the
    dense blocked engine under GSPMD, the transposed engine under
    shard_map over 8 devices."""
    eng = jax_runs[kind]["engine"]
    assert jax_runs[kind]["n_dev"] == 8
    if kind == "sparse":
        assert eng.name.endswith("_shmap8")
    else:
        assert not isinstance(eng, jpt_sharded.ShardedPallasEngine)


# -- pt_sharded.run on its own draws -------------------------------------------

@pytest.fixture(scope="module")
def one_rank_runs():
    out = {}
    for p, s in PT_RUN.items():
        if s["kind"] == "dense":
            j, h = _dense_inputs()
            prob = IsingProblem.from_dense(j, h, device="cpu")
        else:
            inst = _sparse_inst()
            prob = S.EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                         inst.vals, device="cpu")
        out[p] = pt.run(prob, pt.PTConfig(**s["cfg"]))
    return out


@pytest.mark.parametrize("p", sorted(PT_RUN))
def test_two_rank_run_equals_pt_run(p, spawned, one_rank_runs):
    """``pt_sharded.run`` over 2 ranks (the captured super-step replayed on
    the CPU through the tape, each rank's draws its slice of the group's)
    equals ``pt.run`` on the same seed, bit for bit, on every rank."""
    ref = one_rank_runs[p]
    for r in range(2):
        got = spawned[r]
        np.testing.assert_array_equal(got[p + "best_spins"], ref.best_spins)
        assert float(got[p + "best_energy"]) == ref.best_energy
        np.testing.assert_array_equal(got[p + "replica_best"],
                                      ref.replica_best_energy)
        for k, v in (("energy_history", ref.energy_history),
                     ("mean_energy_history", ref.mean_energy_history),
                     ("acceptance_history", ref.acceptance_history),
                     ("slot_trajectory", ref.metadata["slot_trajectory"]),
                     ("exchange_rates", ref.metadata["exchange_rates"])):
            np.testing.assert_array_equal(got[p + k], np.asarray(v), k)
        assert int(got[p + "n_devices"]) == 2
        assert str(got[p + "algorithm"]).startswith("pt_sharded/")
        assert str(got[p + "algorithm"]).endswith("x2")


# -- model-sharded sweeps ----------------------------------------------------

@pytest.fixture(scope="module")
def model_inputs():
    return _model_inputs()


def test_blocked_sweep_sharded_equals_jax_and_the_plain_sweep(
        spawned, model_inputs):
    z = model_inputs
    mesh = JMS.make_mesh(jax.devices()[:2])
    jp = JIsing.from_dense(z["mb_j"], z["mb_h"])
    s_j, de_j, cnt_j = JMS.blocked_sweep_sharded(
        JMS.shard_problem_rows(jp, mesh), mesh, jnp.asarray(z["mb_spins"]),
        jnp.float32(z["mb_beta"]), jnp.asarray(z["mb_u"]), block_size=128)
    tp = IsingProblem.from_dense(z["mb_j"], z["mb_h"], device="cpu")
    s_p, de_p, cnt_p = K.blocked_sweep(tp, torch.as_tensor(z["mb_spins"]),
                                       float(z["mb_beta"]),
                                       torch.as_tensor(z["mb_u"]),
                                       block_size=128)
    for r in range(2):
        got = spawned[r]
        np.testing.assert_array_equal(got["mb_spins"], np.asarray(s_j))
        np.testing.assert_array_equal(got["mb_cnt"], np.asarray(cnt_j))
        np.testing.assert_array_equal(got["mb_de"], np.asarray(de_j))
        np.testing.assert_array_equal(got["mb_spins"], s_p.numpy())
        np.testing.assert_array_equal(got["mb_de"], de_p.numpy())
        np.testing.assert_array_equal(got["mb_cnt"], cnt_p.numpy())
        assert bool(got["mb_repeat_equal"])
    assert int(cnt_p.sum()) > 0


def test_colored_sweep_sharded_equals_jax_and_the_plain_sweep(
        spawned, model_inputs):
    z = model_inputs
    mesh = JMS.make_mesh(jax.devices()[:2])
    jp = JIsing.from_dense(z["mc_j"])
    s_j, de_j, cnt_j = JMS.colored_sweep_sharded(
        jp, mesh, jnp.asarray(z["mc_masks"]), jnp.asarray(z["mc_spins"]),
        jnp.float32(z["mc_beta"]), jnp.asarray(z["mc_u"]))
    tp = IsingProblem.from_dense(z["mc_j"], device="cpu")
    s_p, de_p, cnt_p = K.colored_sweep(tp, torch.as_tensor(z["mc_masks"]),
                                       torch.as_tensor(z["mc_spins"]),
                                       float(z["mc_beta"]),
                                       torch.as_tensor(z["mc_u"]))
    got = _joined(spawned, "mc_spins", 1)
    np.testing.assert_array_equal(got, np.asarray(s_j))
    np.testing.assert_array_equal(got, s_p.numpy())
    for r in range(2):
        np.testing.assert_array_equal(spawned[r]["mc_cnt"], np.asarray(cnt_j))
        np.testing.assert_array_equal(spawned[r]["mc_cnt"], cnt_p.numpy())
        np.testing.assert_array_equal(spawned[r]["mc_de"], np.asarray(de_j))
        np.testing.assert_array_equal(spawned[r]["mc_de"], de_p.numpy())


def test_blocked_sweep_sharded_rejects_short_row_shards(spawned):
    """Padded 128 over 2 ranks: 64 rows per rank < block 128 (the JAX
    module's ValueError)."""
    assert all(bool(spawned[r]["mb_raised"]) for r in range(2))


# -- data-parallel PPO -----------------------------------------------------

@pytest.fixture(scope="module")
def one_rank_ppo():
    """Two ``make_ppo`` updates on all 8 envs, with every env step's actions
    and rewards recorded."""
    prob = IsingProblem.from_dense(
        topology.fully_connected(32, dist="binary", seed=6), device="cpu")
    env_cfg = env_mod.EnvConfig(**PPO["env"])
    cfg = ppo_mod.PPOConfig(**dict(PPO["ppo"], hidden_sizes=(16, 16)))
    init_fn, update_fn, _ = ppo_mod.make_ppo(prob, env_cfg, cfg)
    actions, rewards, metrics = [], [], []
    mp = pytest.MonkeyPatch()
    orig = env_mod.step

    def recording(problem, cfg_, state, action, *a, **k):
        out = orig(problem, cfg_, state, action, *a, **k)
        actions.append(action.numpy().copy())
        rewards.append(out[2].numpy().copy())
        return out

    mp.setattr(env_mod, "step", recording)
    try:
        state = init_fn()
        for _ in range(PPO["updates"]):
            state, m = update_fn(state)
            metrics.append({k: v.numpy().copy() for k, v in m.items()})
    finally:
        mp.undo()
    return dict(actions=np.stack(actions), rewards=np.stack(rewards),
                metrics=metrics, state=state)


def test_sharded_ppo_actions_and_rewards_equal_one_rank(spawned, one_rank_ppo):
    """Each rank's envs take the actions and get the rewards that the same
    envs (its slice of the env axis) take and get in the one-rank run."""
    ref = one_rank_ppo
    assert ref["actions"].shape == (PPO["updates"] * 4, 8)
    for name in ("actions", "rewards"):
        np.testing.assert_array_equal(_joined(spawned, "ppo_" + name, 1),
                                      ref[name], name)


def test_sharded_ppo_parameters_equal_one_rank(spawned, one_rank_ppo):
    """The replicated learning phase on the gathered batch leaves the same
    parameters on both ranks, and those of the one-rank run: tolerance 0
    (the same operations on the same tensors in the same order)."""
    ref = one_rank_ppo["state"].params
    for r in range(2):
        for name, v in ref.items():
            np.testing.assert_array_equal(spawned[r]["ppo_param_" + name],
                                          v.detach().numpy(), name)
        assert int(spawned[r]["ppo_update"]) == PPO["updates"]
        for u, m in enumerate(one_rank_ppo["metrics"]):
            for k, v in m.items():
                np.testing.assert_array_equal(spawned[r][f"ppo_u{u}_{k}"], v,
                                              k)


def test_sharded_ppo_rejects_an_indivisible_env_count(spawned):
    assert all(bool(spawned[r]["ppo_raised"]) for r in range(2))


# -- multihost in the group ------------------------------------------------

def test_multihost_helpers_in_a_two_rank_group(spawned):
    for r in range(2):
        got = spawned[r]
        assert int(got["mh_process_count"]) == 2
        assert int(got["mh_process_index"]) == r
        assert int(got["mh_global_devices"]) == 2
        assert str(got["mh_backend"]) == "gloo"
        assert tuple(got["mh_axes"]) == ("replica",)
        assert tuple(got["mh_hybrid_axes"]) == ("host", "replica")
        assert tuple(got["mh_hybrid_shape"]) == (1, 2)
        assert tuple(got["mh_slice"]) == (32 * r, 32 * r + 32)
