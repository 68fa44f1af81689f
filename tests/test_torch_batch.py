"""The port's batch path (``spinglass_tpu_torch.anneal.batch``) on the CPU,
against ``spinglass_tpu.anneal.batch``: ``stack_problems``; the stacked
sweep's plain twin (K1 with a problem axis) against ``jax.vmap`` of the JAX
``blocked_sweep`` on given uniforms; the whole stacked anneal against the
JAX ``_anneal_stacked`` and ``BatchProcessor.process`` on the draws their
keys make (start spins and per-sweep uniforms reproduced in the test); the
captured stacked run against its eager loop; the processors' behaviour, as
``tests/unit/test_batch_adaptive.py::TestBatch`` holds the JAX ones.

+-J couplings with h on a quarter grid keep every field and energy exact, so
spins, dE, counts, best energies and best spins must be equal bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.anneal import batch as JB  # noqa: E402
from spinglass_tpu.anneal import sa as jsa  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.core.problem import random_spins as jax_random_spins  # noqa: E402
from spinglass_tpu.kernels import sweeps as JK  # noqa: E402
from spinglass_tpu_torch.anneal import batch as B  # noqa: E402
from spinglass_tpu_torch.anneal.sa import SAConfig  # noqa: E402
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels import metropolis_cuda as MC  # noqa: E402


def _pm_j(ns, seed=0):
    """(J, h) pairs: +-J couplings, h on a quarter grid."""
    rng = np.random.default_rng(seed)
    return [(topology.fully_connected(n, dist="binary", seed=seed + i),
             rng.integers(-8, 9, n) / 4.0) for i, n in enumerate(ns)]


def _both(pairs):
    """The same problems in both packages."""
    return ([IsingProblem.from_dense(j, h, device="cpu") for j, h in pairs],
            [JaxProblem.from_dense(j, h) for j, h in pairs])


def _problems(ns, seed=0):
    return [IsingProblem.from_dense(
        topology.fully_connected(n, dist="binary", seed=seed + i),
        device="cpu") for i, n in enumerate(ns)]


FAST = SAConfig(n_sweeps=60, n_replicas=8, use_kernel="never")


def _jax_cfg(cfg: SAConfig):
    return jsa.SAConfig(n_sweeps=cfg.n_sweeps, n_replicas=cfg.n_replicas,
                        update_rule=cfg.update_rule, use_pallas="never")


def test_stack_problems():
    st = B.stack_problems(_problems([10, 12]))
    assert st.j.shape == (2, 128, 128)
    assert st.h.shape == (2, 128) and st.active_mask.shape == (2, 128)
    assert st.n_spins == 12 and st.n_padded == 128 and st.n_problems == 2


def test_stack_requires_same_padding():
    with pytest.raises(ValueError, match="equal padded sizes"):
        B.stack_problems(_problems([10, 200]))


@pytest.mark.parametrize("n,r,rule", [
    (100, 1, "metropolis"), (100, 5, "glauber"), (100, 16, "metropolis"),
    (200, 1, "glauber"), (200, 5, "metropolis"), (200, 16, "glauber")])
def test_stacked_twin_matches_vmapped_blocked_sweep(n, r, rule):
    """P = 3 problems (Np = 128 or 256), per-problem per-replica betas and
    given uniforms: the stacked twin equals ``jax.vmap(blocked_sweep)`` bit
    for bit in spins, dE and counts."""
    tps, jps = _both(_pm_j([n] * 3, seed=n + r))
    st = B.stack_problems(tps)
    jst = JB.stack_problems(jps)
    n_pad = st.n_padded
    rng = np.random.default_rng(r)
    s0 = np.where(rng.random((3, r, n_pad)) < 0.5, -1.0, 1.0).astype(np.float32)
    s0[:, :, n:] = 1.0
    beta = rng.uniform(0.1, 2.0, (3, r)).astype(np.float32)
    u = rng.random((3, r, n_pad)).astype(np.float32)

    def one(j, h, mask, s, b, uu):
        p = JaxProblem(j=j, h=h, active_mask=mask, n_spins=jst.n_spins)
        return JK.blocked_sweep(p, s, b, uu, block_size=128, rule=rule)

    # JAX may alias an aligned numpy buffer and reads it when its queued
    # computation runs, and at R = 1 the transpose below is a view of s0,
    # which the twin sweeps in place: each side gets its own copy, and the
    # JAX results are read before the twin runs
    js, jde, jcnt = (np.asarray(x) for x in jax.vmap(one)(
        jst.j, jst.h, jst.active_mask, jnp.asarray(s0.copy()),
        jnp.asarray(beta), jnp.asarray(u)))
    sw = MC.StackedFusedSweep(st.j, st.h, st.active_mask, block_size=128,
                              rule=rule)
    spins = torch.tensor(s0).transpose(1, 2).contiguous()
    _, de, cnt = sw.sweep_with_uniforms(
        spins, torch.from_numpy(beta),
        torch.from_numpy(u).transpose(1, 2).contiguous())
    np.testing.assert_array_equal(spins.transpose(1, 2).numpy(), js)
    np.testing.assert_array_equal(de.numpy(), jde)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    assert sw.launches == 0


def _jax_draws(key, jst, cfg):
    """The draws of the JAX ``_anneal_stacked`` under ``key``
    (``batch.py:85-92, :110``): per problem a split for the start spins,
    then one split per sweep for its [R, Np] uniforms. Returns numpy
    (start spins [P, R, Np], uniforms [S, P, R, Np])."""
    keys = jax.random.split(key, jst.j.shape[0])
    r, n_pad = cfg.n_replicas, jst.j.shape[-1]
    spins, us = [], []
    for p in range(jst.j.shape[0]):
        k, sub = jax.random.split(keys[p])
        spins.append(np.asarray(jax_random_spins(sub, (r, n_pad),
                                                 jst.active_mask[p])))
        up = []
        for _ in range(cfg.n_sweeps):
            k, ku = jax.random.split(k)
            up.append(np.asarray(jax.random.uniform(ku, (r, n_pad),
                                                    jnp.float32)))
        us.append(np.stack(up))
    return np.stack(spins), np.stack(us, axis=1)


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_anneal_stacked_matches_jax_on_its_draws(rule):
    """The JAX ``_anneal_stacked``'s own output against the port's stacked
    anneal fed its start spins and uniforms: best energies and replica
    bests exact, best spins bitwise."""
    cfg = SAConfig(n_sweeps=12, n_replicas=4, update_rule=rule,
                   use_kernel="never")
    tps, jps = _both(_pm_j([20, 24, 30], seed=7))
    key = jax.random.key(11)
    jst = JB.stack_problems(jps)
    want = JB._anneal_stacked(jst, _jax_cfg(cfg), key)
    s0, u = _jax_draws(key, jst, cfg)
    got = B.anneal_stacked(B.stack_problems(tps), cfg,
                           init_spins=torch.from_numpy(s0),
                           uniforms=torch.from_numpy(u))
    for k in ("best_energy", "best_spins", "replica_best"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


def test_batch_processor_matches_jax_process():
    """``BatchProcessor.process`` with batches of 2: each batch's key is
    ``process``'s split (``batch.py:140``); the port's stacked anneal on
    that key's draws equals the JAX results problem by problem."""
    cfg = SAConfig(n_sweeps=10, n_replicas=4, use_kernel="never")
    tps, jps = _both(_pm_j([12, 15, 18, 21], seed=3))
    want = JB.BatchProcessor(_jax_cfg(cfg), JB.BatchConfig(
        max_batch_size=2)).process(jps, seed=5)
    key = jax.random.key(5)
    for lo in (0, 2):
        key, sub = jax.random.split(key)
        jst = JB.stack_problems(jps[lo:lo + 2])
        s0, u = _jax_draws(sub, jst, cfg)
        got = B.anneal_stacked(B.stack_problems(tps[lo:lo + 2]), cfg,
                               init_spins=torch.from_numpy(s0),
                               uniforms=torch.from_numpy(u))
        for k in range(2):
            w = want[lo + k]
            assert float(got["best_energy"][k]) == w.best_energy
            np.testing.assert_array_equal(
                got["best_spins"][k].numpy()[: tps[lo + k].n_spins],
                w.best_spins)
            np.testing.assert_array_equal(got["replica_best"][k].numpy(),
                                          w.replica_best_energy)


def test_captured_stacked_run_equals_eager_loop():
    """The captured run (on the CPU: the step replayed eagerly through its
    random tape) equals the eager loop on the same generator bit for bit;
    a second batch of the same shape reuses the captured run."""
    B.clear_runs()
    cfg = SAConfig(n_sweeps=8, n_replicas=4, use_kernel="never")
    st = B.stack_problems(_both(_pm_j([20, 25], seed=2))[0])
    run = B.stacked_run(st, cfg)
    got = run.run(st, torch.Generator().manual_seed(4))
    (be, bs, rep), launches = B.eager_stacked(st, cfg,
                                              torch.Generator().manual_seed(4))
    for a, b in zip(got, (be, bs, rep)):
        np.testing.assert_array_equal(a, b.numpy())
    assert launches == 0 and run.sweep.launches == 0
    st2 = B.stack_problems(_both(_pm_j([20, 25], seed=9))[0])
    assert B.stacked_run(st2, cfg) is run
    got2 = run.run(st2, torch.Generator().manual_seed(4))
    (be2, _, _), _ = B.eager_stacked(st2, cfg, torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(got2[0], be2.numpy())


def test_process_preserves_order_and_solves():
    ps = _problems([10, 14, 12, 16])
    proc = B.BatchProcessor(FAST, B.BatchConfig(max_batch_size=3))
    results = proc.process(ps)
    assert len(results) == 4 and proc.n_processed == 4
    assert proc.failures == []
    for p, r in zip(ps, results):
        assert len(r.best_spins) == p.n_spins
        assert np.isfinite(r.best_energy)
        assert r.algorithm == "sa/batched" and r.device == "cpu"
        s = torch.ones(p.n_padded)
        s[: p.n_spins] = torch.from_numpy(r.best_spins)
        e = -0.5 * s @ p.j @ s - p.h @ s
        assert float(e) == r.best_energy


def test_batched_matches_single_quality():
    """The ferromagnet's ground state, -N(N-1)/2, in every batch slot."""
    n = 12
    j = topology.fully_connected(n, dist="ferromagnetic", scale=1.0)
    p = IsingProblem.from_dense(j, device="cpu")
    cfg = SAConfig(n_sweeps=200, n_replicas=16, use_kernel="never",
                   schedule=ScheduleConfig(initial_temp=4.0, final_temp=0.01))
    res = B.BatchProcessor(cfg).process([p, p])
    for r in res:
        assert r.best_energy == pytest.approx(-0.5 * n * (n - 1), rel=1e-5)


def test_streaming():
    ps = _problems([10, 11, 12, 13, 14])
    proc = B.BatchProcessor(FAST, B.BatchConfig(max_batch_size=2))
    out = list(proc.process_stream(iter(ps), batch_size=2))
    assert len(out) == 5 and all(r.algorithm == "sa/batched" for r in out)


def test_checkpointing_names_as_jax(tmp_path):
    """batch_progress_{n}.json with the JAX keys, one per batch."""
    ps = _problems([10, 11, 12, 13])
    proc = B.BatchProcessor(
        FAST, B.BatchConfig(max_batch_size=2, checkpoint_interval=1,
                            checkpoint_dir=str(tmp_path)))
    proc.process(ps)
    files = sorted(os.listdir(tmp_path))
    assert files == ["batch_progress_1.json", "batch_progress_2.json"]
    last = json.loads((tmp_path / files[-1]).read_text())
    assert last == {"batch": 2, "completed": [0, 1, 2, 3], "n_failures": 0}


def test_failed_batch_falls_back_per_problem(monkeypatch):
    """The JAX per-batch isolation: a stacked run that raises leaves its
    problems to per-problem ``anneal`` (results ``sa/...``)."""
    def broken(*a, **k):
        raise RuntimeError("stacked run failed")

    monkeypatch.setattr(B, "stacked_run", broken)
    ps = _problems([10, 11])
    proc = B.BatchProcessor(FAST)
    res = proc.process(ps)
    assert [r.algorithm.split("/")[0] for r in res] == ["sa", "sa"]
    assert all(r.algorithm != "sa/batched" for r in res)
    assert proc.n_processed == 2 and proc.failures == []


def test_adaptive_batch_processor():
    ps = _problems([10] * 6)
    proc = B.AdaptiveBatchProcessor(FAST, B.BatchConfig(max_batch_size=8))
    results = proc.process(ps)
    assert all(r is not None for r in results)
    assert proc._current_bs >= 2
    assert sum(proc.batch_sizes) == 6 and proc.batch_sizes[0] == 2


def test_adaptive_growth_rule_matches_jax(monkeypatch):
    """With a clock that ticks 1 s per read, both packages grow the batch
    by the same rule: the same sizes in the same order."""
    import itertools

    def fake_clock(module):
        ticks = itertools.count()
        monkeypatch.setattr(module.time, "perf_counter",
                            lambda: float(next(ticks)))

    sizes = {}
    for name, mod in (("port", B), ("jax", JB)):
        fake_clock(mod)
        seen = []
        proc = mod.AdaptiveBatchProcessor(None,
                                          mod.BatchConfig(max_batch_size=8))
        orig = mod.BatchProcessor.process

        def spy(self, problems, seed=0, orig=orig, seen=seen):
            seen.append(len(problems))
            return [None] * len(problems)

        monkeypatch.setattr(mod.BatchProcessor, "process", spy)
        proc.process(list(range(23)))
        monkeypatch.setattr(mod.BatchProcessor, "process", orig)
        sizes[name] = (seen, proc._current_bs)
    assert sizes["port"] == sizes["jax"]
    assert sizes["port"][0][:3] == [2, 4, 7]


@pytest.mark.parametrize("n_pad,r,max_bs", [(128, 16, 7), (8192, 16, 64),
                                            (2048, 1024, 64)])
def test_estimate_batch_size_bounds(n_pad, r, max_bs):
    """On the CPU: the JAX function's figure for a device without memory
    stats, the same formula and bounds."""
    cfg = B.BatchConfig(max_batch_size=max_bs)
    bs = B.estimate_batch_size(n_pad, r, cfg, "cpu")
    assert 1 <= bs <= max_bs
    assert bs == JB.estimate_batch_size(n_pad, r, JB.BatchConfig(
        max_batch_size=max_bs))
