"""Port parity for parallel tempering and the planted time-to-target path,
against spinglass_tpu.anneal.pt and spinglass_tpu.benchmarks.planted.

The JAX functions draw their randomness from keys; the tests compute those
uniforms (and permutations) from the keys on the host and hand the same
numbers to the port. The planted instances use +-1 couplings, so energies
are exact and the super-step states must be equal bit for bit.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.anneal import pt as jpt  # noqa: E402
from spinglass_tpu.benchmarks import planted as jplanted  # noqa: E402
from spinglass_tpu.kernels import sparse as JS  # noqa: E402
from spinglass_tpu_torch.anneal import pt  # noqa: E402
from spinglass_tpu_torch.benchmarks import planted  # noqa: E402
from spinglass_tpu_torch.core.convert import pt_state_from_numpy  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_METADATA_KEYS = {"ladder", "exchange_rates", "exchange_interval",
                     "slot_energy", "slot_trajectory", "slot_energy_history",
                     "exchange_method"}


def _ells(inst):
    return (JS.EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                   inst.vals),
            S.EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                  inst.vals, device="cpu"))


def _jax_state(cfg_kw, n_chains, seed):
    """A JAX PTState with random slots (a permutation per chain) and
    energies, and its port copy."""
    nr = cfg_kw["n_replicas"]
    rng = np.random.default_rng(seed)
    slot = np.concatenate([rng.permutation(nr) for _ in range(n_chains)]
                          ).astype(np.int32)
    energy = rng.normal(-50, 5, nr * n_chains).astype(np.float32)
    spins = np.ones((nr * n_chains, 128), np.float32)
    att = rng.integers(0, 5, nr - 1).astype(np.int32)
    jst = jpt.PTState(spins=jnp.asarray(spins), slot=jnp.asarray(slot),
                      energy=jnp.asarray(energy), best_energy=jnp.asarray(energy),
                      best_spins=jnp.asarray(spins), key=jax.random.key(0),
                      sweep=jnp.asarray(0, jnp.int32),
                      exch_attempts=jnp.asarray(att),
                      exch_accepts=jnp.asarray(att // 2),
                      acc_rate=jnp.zeros(nr * n_chains, jnp.float32))
    tst = pt_state_from_numpy(spins, slot, energy, energy, spins, 0, att,
                              att // 2, device="cpu")
    return jst, tst


def _same_exchange_state(tst, jst):
    np.testing.assert_array_equal(tst.slot.numpy(), np.asarray(jst.slot))
    np.testing.assert_array_equal(tst.exch_attempts.numpy(),
                                  np.asarray(jst.exch_attempts))
    np.testing.assert_array_equal(tst.exch_accepts.numpy(),
                                  np.asarray(jst.exch_accepts))


@pytest.mark.parametrize("ladder", ["geometric", "linear", "exponential"])
def test_temperature_ladder_matches_jax(ladder):
    kw = dict(n_replicas=12, min_temp=0.05, max_temp=3.0, ladder=ladder)
    ours = pt.temperature_ladder(pt.PTConfig(**kw))
    np.testing.assert_array_equal(ours, jpt.temperature_ladder(jpt.PTConfig(**kw)))
    assert ours.dtype == np.float32 and ours[0] == np.float32(0.05)


@pytest.mark.parametrize("parity,n_chains", [(0, 1), (1, 1), (0, 3), (1, 3)])
def test_exchange_step_matches_jax(parity, n_chains):
    kw = dict(n_replicas=10)
    betas = 1.0 / pt.temperature_ladder(pt.PTConfig(min_temp=0.5, max_temp=4.0,
                                                    **kw))
    for trial in range(4):
        jst, tst = _jax_state(kw, n_chains, seed=10 * trial + parity)
        key = jax.random.key(trial)
        u = np.array(jax.random.uniform(key, (n_chains, 9)))
        jst = jpt.exchange_step(jst, jnp.asarray(betas), jnp.int32(parity), key,
                                n_chains=n_chains)
        tst = pt.exchange_step(tst, torch.as_tensor(betas), parity,
                               torch.as_tensor(u), n_chains=n_chains)
        _same_exchange_state(tst, jst)
    assert int(tst.exch_accepts.sum()) > 0


@pytest.mark.parametrize("n_chains", [1, 3])
def test_exchange_step_all_pairs_matches_jax(n_chains):
    kw = dict(n_replicas=9)
    betas = 1.0 / pt.temperature_ladder(pt.PTConfig(min_temp=0.5, max_temp=4.0,
                                                    **kw))
    for trial in range(4):
        jst, tst = _jax_state(kw, n_chains, seed=trial)
        key = jax.random.key(100 + trial)
        k_perm, k_u = jax.random.split(key)
        perm = np.array(jax.random.permutation(k_perm, 9))
        u = np.array(jax.random.uniform(k_u, (n_chains, 4)))
        jst = jpt.exchange_step_all_pairs(jst, jnp.asarray(betas), key,
                                          n_chains=n_chains)
        tst = pt.exchange_step_all_pairs(tst, torch.as_tensor(betas),
                                         torch.as_tensor(perm),
                                         torch.as_tensor(u), n_chains=n_chains)
        _same_exchange_state(tst, jst)
        for c in range(n_chains):  # slots stay a permutation per chain
            assert sorted(tst.slot[9 * c:9 * (c + 1)].tolist()) == list(range(9))


class _JaxKeyUniforms(JS.SortedSparseTEngine):
    """Test-only JAX T engine: sweeps with uniforms drawn from the sweep key
    by ``sweep_with_uniforms``, so the host can replay them."""

    def sweep(self, spins_t, beta, key):
        u = jax.random.uniform(key, (self.n_sorted, spins_t.shape[1]),
                               jnp.float32)
        return self.sweep_with_uniforms(spins_t, beta, u)


class _TorchGivenUniforms(S.SortedSparseTEngine):
    """The port's counterpart: ignores the generator, takes the next given
    [NS, R] uniforms."""

    def __init__(self, problem, queue):
        super().__init__(problem)
        self.queue = queue

    def sweep(self, spins_t, beta, generator):
        return self.sweep_with_uniforms(spins_t, beta,
                                        torch.as_tensor(self.queue.pop(0)))


def test_super_step_matches_jax(monkeypatch):
    """Three PT super-steps (5 sweeps + exchange + resync, 2 chains of 8
    replicas) through the transposed sparse engine: slots, energies, best
    energies, exchange counts and spins equal the JAX driver's each step."""
    inst = planted.planted_gauge_coo(200, 5.0, seed=11, frustration=0.2,
                                     magnitude="ones")
    jell, tell = _ells(inst)
    kw = dict(n_replicas=8, n_chains=2, exchange_interval=5, min_temp=0.2,
              max_temp=4.0, sweep_method="sparse_t", seed=3)
    jcfg, tcfg = jpt.PTConfig(**kw), pt.PTConfig(**kw)
    queue = []
    jeng = _JaxKeyUniforms(jell)
    teng = _TorchGivenUniforms(tell, queue)
    assert teng.spin_dtype == torch.int8 and np.array_equal(teng.perm, jeng.perm)
    jstep, _, _ = jpt.make_pt_step(jell, jcfg, engine=jeng)
    tstep, tbetas, _ = pt.make_pt_step(tell, tcfg, engine=teng)
    jstep = jax.jit(jstep)
    jst = jpt.init_state(jell, jcfg, jax.random.key(5), jeng)
    tst = pt_state_from_numpy(
        np.asarray(jst.spins), np.asarray(jst.slot), np.asarray(jst.energy),
        np.asarray(jst.best_energy), np.asarray(jst.best_spins),
        int(jst.sweep), np.asarray(jst.exch_attempts),
        np.asarray(jst.exch_accepts), src_layout="nr", layout="nr",
        spin_dtype=np.int8, device="cpu")
    np.testing.assert_array_equal(teng.energy(tst.spins).numpy(),
                                  np.asarray(jst.energy))
    ex_u = []
    monkeypatch.setattr(pt, "_exchange_draws",
                        lambda cfg, gen, dev: (None, torch.as_tensor(ex_u.pop(0))))
    r_total = 16
    for step in range(3):
        key = jst.key  # replay the JAX driver's key chain on the host
        for _ in range(kw["exchange_interval"]):
            key, ku = jax.random.split(key)
            queue.append(np.array(jax.random.uniform(
                ku, (jeng.n_sorted, r_total), jnp.float32)))
        key, kx = jax.random.split(key)
        ex_u.append(np.array(jax.random.uniform(kx, (2, 7))))
        jst, jstats = jstep(jst, None)
        tst, tstats = tstep(tst)
        assert not queue and not ex_u
        _same_exchange_state(tst, jst)
        for name in ("energy", "best_energy"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)), name)
        # XLA turns cnt / n_spins into cnt * (1 / n_spins): last-bit rounding
        np.testing.assert_allclose(tst.acc_rate.numpy(), np.asarray(jst.acc_rate),
                                   rtol=2e-7)
        np.testing.assert_array_equal(tst.spins.numpy(), np.asarray(jst.spins))
        np.testing.assert_array_equal(tst.best_spins.numpy(),
                                      np.asarray(jst.best_spins))
        for name in ("best_energy", "cold_energy", "slot_energy",
                     "slot_of_replica"):
            np.testing.assert_array_equal(tstats[name].numpy(),
                                          np.asarray(jstats[name]), name)
        assert tst.sweep == int(jst.sweep) == 5 * (step + 1)
    assert int(tst.exch_accepts.sum()) > 0
    assert tst.best_spins.data_ptr() != tst.spins.data_ptr()


def test_super_steps_fused_engine_match_threshold_path():
    """Two PT super-steps (2 chains of 64 replicas) through
    SortedSparseTEngine(accept_kernel="fused") equal the same driver through
    the K3 path (threshold_rng="kernel"), bit for bit: one seed per sweep
    from the driver's generator, K4's twin and the per-colour sweep on K3's
    twin make the same decisions."""
    inst = planted.planted_gauge_coo(200, 5.0, seed=12, frustration=0.3,
                                     magnitude="ones")
    _, tell = _ells(inst)
    cfg = pt.PTConfig(n_replicas=64, n_chains=2, exchange_interval=5,
                      min_temp=0.2, max_temp=4.0, sweep_method="sparse_t")
    out = []
    for kw in (dict(accept_kernel="fused"), dict(threshold_rng="kernel")):
        eng = S.SortedSparseTEngine(tell, **kw)
        before = build.launch_snapshot()
        step, _, eng = pt.make_pt_step(tell, cfg, engine=eng)
        state = pt.init_state(tell, cfg, torch.Generator().manual_seed(3), eng)
        for _ in range(2):
            state, _ = step(state)
        out.append((state, build.launches_since(before, eng.kernel_names)))
    (a, la), (b, lb) = out
    for name in ("spins", "slot", "energy", "best_energy", "best_spins",
                 "exch_attempts", "exch_accepts", "acc_rate"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.spins.dtype == torch.int8 and int(a.exch_accepts.sum()) > 0
    assert la == lb == {"sparse_sweep": 0, "sparse_thresholds": 0,
                        "sparse_accept": 0}


def test_pt_run_reaches_planted_ground_state():
    inst = planted.planted_gauge_coo(200, avg_degree=5.0, seed=11)
    _, tell = _ells(inst)
    cfg = pt.PTConfig(n_replicas=8, exchange_interval=10, min_temp=0.1,
                      max_temp=5.0, seed=0)
    out = planted.time_to_target(tell, inst.e0, cfg, rel_gap=1e-3,
                                 max_sweeps=2000, seeds=(0, 1, 2))
    assert out["all_hit"], out
    assert out["best_energy"] <= out["threshold"] and out["seconds"] > 0
    assert out["engine"] == "sparse_sorted" and out["seeds"] == [0, 1, 2]
    secs = sorted(r["seconds"] for r in out["per_seed"])
    assert out["seconds"] == secs[1] and out["seconds_min"] == secs[0]


def test_planted_instances_match_jax_and_provenance_hash():
    for kw in (dict(n_spins=300, avg_degree=5.0, seed=2),
               dict(n_spins=100, avg_degree=4.0, seed=7, frustration=0.2,
                    magnitude="ones")):
        ours, theirs = planted.planted_gauge_coo(**kw), jplanted.planted_gauge_coo(**kw)
        for name in ("rows", "cols", "vals", "s_star"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name))
        assert ours.e0 == theirs.e0
        assert planted.instance_hash(ours) == jplanted.instance_hash(theirs)
    prov = json.loads((ROOT / "spinglass_tpu" / "benchmarks"
                       / "ttt_provenance.json").read_text())
    spec = prov["instance"]
    inst = planted.planted_gauge_coo(
        spec["n_spins"], avg_degree=spec["avg_degree"], seed=spec["seed"],
        frustration=spec["frustration"], magnitude=spec["magnitude"])
    assert planted.instance_hash(inst) == spec["sha256"]
    assert len(inst.rows) == spec["n_directed_entries"]


def test_pt_run_result_and_metadata():
    """pt.run on an EllProblem through both sparse engines; every metadata
    key of the JAX result is there, with the same shapes."""
    inst = planted.planted_gauge_coo(150, avg_degree=4.0, seed=4,
                                     frustration=0.2)
    _, tell = _ells(inst)
    for method, name in (("auto", "sparse_sorted"), ("sparse_t",
                                                     "sparse_sorted_t")):
        cfg = pt.PTConfig(n_replicas=6, n_chains=2, n_sweeps=60,
                          exchange_interval=10, sweep_method=method,
                          exchange_method="all_pairs" if method == "auto"
                          else "nearest_neighbor")
        res = pt.run(tell, cfg)
        assert JAX_METADATA_KEYS <= set(res.metadata)
        assert res.metadata["engine"] == name
        assert res.metadata["slot_trajectory"].shape == (6, 12)
        assert res.metadata["slot_energy_history"].shape == (6, 6)
        assert len(res.metadata["ladder"]) == 6
        assert len(res.metadata["exchange_rates"]) == 5
        assert res.algorithm == "pt/metropolis" and res.device == "cpu"
        assert res.n_sweeps == 60 and res.best_spins.shape == (150,)
        assert res.replica_best_energy.shape == (12,)
        assert np.isfinite(res.energy_history).all()
        s = torch.ones(1, tell.n_padded)
        s[0, :150] = torch.as_tensor(res.best_spins)
        assert float(S.sparse_energy(tell, s)[0]) == pytest.approx(
            res.best_energy, rel=1e-5)
        summary = pt.exchange_rate_summary(res)
        assert 0.0 <= summary["min_exchange_rate"] <= summary[
            "mean_exchange_rate"] <= 1.0
    again = pt.run(tell, cfg)
    assert again.best_energy == res.best_energy  # seeded


def test_pt_unported_options_raise(tmp_path):
    """The options that raised before the drivers' remaining paths were
    ported run now: cluster moves, a checkpoint directory and tune_ladder;
    each returns what the JAX driver returns."""
    inst = planted.planted_gauge_coo(60, avg_degree=3.0, seed=1)
    _, tell = _ells(inst)
    cm = pt.run(tell, pt.PTConfig(n_replicas=4, n_sweeps=10, cluster_moves=1))
    assert cm.n_sweeps == 10 and np.isfinite(cm.best_energy)
    assert cm.metadata["kernel_launches"]["sw_labels"] == 0   # CPU: no kernel
    plain = pt.run(tell, pt.PTConfig(n_replicas=4, n_sweeps=10))
    seg = pt.run(tell, pt.PTConfig(n_replicas=4, n_sweeps=10),
                 checkpoint_dir=str(tmp_path / "ck"))
    assert seg.best_energy == plain.best_energy
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_1.pt", "engine_meta.json", "history.npz"]
    temps, diag = pt.tune_ladder(tell, pt.PTConfig(n_replicas=4),
                                 n_pilot_sweeps=40, n_iters=1)
    assert temps.shape == (4,) and np.all(np.diff(temps) > 0)
    assert len(diag["iterations"]) == 1
    # j_dtype="bfloat16" is ported: it runs, and an unknown dtype raises
    res = pt.run(tell, pt.PTConfig(n_replicas=4, n_sweeps=10,
                                   j_dtype="bfloat16"))
    assert res.n_sweeps == 10 and np.isfinite(res.best_energy)
    with pytest.raises(ValueError, match="j_dtype"):
        pt.PTConfig(j_dtype="float16")
    st = pt.init_state(tell, dataclasses.replace(pt.PTConfig(n_replicas=4),
                                                 n_chains=2))
    assert st.spins.shape == (8, tell.n_padded) and st.slot.tolist() == [
        0, 1, 2, 3, 0, 1, 2, 3]
    np.testing.assert_allclose(st.energy.numpy(),
                               S.sparse_energy(tell, st.spins).numpy())
