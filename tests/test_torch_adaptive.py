"""Adaptive SA (``spinglass_tpu_torch.anneal.adaptive``) and the minimal
stdlib model (``core/minimal.py``) on the CPU, against their JAX
counterparts: ``_intervene`` on the same state and the JAX draws
(reproduced from ``state.key``), dense and ELL; the ferromagnet run of
``tests/unit/test_batch_adaptive.py::TestAdaptiveSA``; the minimal
annealer under one ``random.Random`` seed.

Tolerances: spins bit for bit (the restarts are copies and fresh draws),
energies within 1e-5 relative (exact on the +-J instances), the reheated
temperature exactly (one float32 product and a min).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.anneal import adaptive as JA  # noqa: E402
from spinglass_tpu.anneal import sa as jsa  # noqa: E402
from spinglass_tpu.anneal.schedules import ScheduleConfig as JSchedule  # noqa: E402
from spinglass_tpu.core import energy as jenergy  # noqa: E402
from spinglass_tpu.core import minimal as jminimal  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.core.problem import random_spins as jax_random_spins  # noqa: E402
from spinglass_tpu.kernels import sparse as JS  # noqa: E402
from spinglass_tpu_torch.anneal import adaptive as A  # noqa: E402
from spinglass_tpu_torch.anneal import graphs  # noqa: E402
from spinglass_tpu_torch.anneal.sa import (SAConfig, capture_chunk,  # noqa: E402
                                           init_state, make_sweep_engine)
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig  # noqa: E402
from spinglass_tpu_torch.core import minimal  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.convert import sa_state_from_numpy  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels.sparse import EllProblem  # noqa: E402


def _dense_pair(n=40, seed=3):
    j = topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return IsingProblem.from_dense(j, h, device="cpu"), JaxProblem.from_dense(j, h)


def _ell_pair(n=150, seed=2):
    coo = topology.sparse_random_graph_coo(n, avg_degree=4.0, dist="binary",
                                           seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return (EllProblem.from_coo(n, *coo, h=h, device="cpu"),
            JS.EllProblem.from_coo(n, *coo, h=h))


def _jax_energy_in_layout(engine):
    """The JAX ``energy`` with an ``EllProblem`` sent to ``engine.energy``
    (spins in the engine's layout). The JAX ``_intervene`` calls
    ``energy(problem, spins)`` on the engine-layout spins, which reads
    ``problem.j``, and an ``EllProblem`` has none; the port's
    ``_intervene`` calls ``engine.energy``."""
    dense = jenergy.energy

    def energy(problem, spins, **kw):
        if isinstance(problem, JS.EllProblem):
            return engine.energy(spins)
        return dense(problem, spins, **kw)

    return energy


@pytest.mark.parametrize("kind,r,fracs", [
    ("dense", 8, (0.25, 0.25)), ("dense", 12, (0.5, 0.25)),
    ("ell", 8, (0.25, 0.25)), ("ell", 16, (0.25, 0.5))])
def test_intervene_matches_jax(kind, r, fracs, monkeypatch):
    """The same state (a JAX state after one chunk, carried over), the JAX
    draws from ``state.key``: the port's restarted spins equal JAX's bit
    for bit, the energies within 1e-5, the temperature exactly."""
    tp, jp = _ell_pair() if kind == "ell" else _dense_pair()
    restart, elite = fracs
    sched = dict(initial_temp=3.0, final_temp=0.05)
    jcfg = JA.AdaptiveSAConfig(
        base=jsa.SAConfig(n_sweeps=40, n_replicas=r, record_interval=10,
                          use_pallas="never", schedule=JSchedule(**sched)),
        restart_fraction=restart, elite_fraction=elite)
    tcfg = A.AdaptiveSAConfig(
        base=SAConfig(n_sweeps=40, n_replicas=r, record_interval=10,
                      use_kernel="never", schedule=ScheduleConfig(**sched)),
        restart_fraction=restart, elite_fraction=elite)
    jeng = jsa.make_sweep_engine(jp, jcfg.base)
    monkeypatch.setattr(jenergy, "energy", _jax_energy_in_layout(jeng))
    jst = jsa.init_state(jp, jcfg.base, jeng, jax.random.key(r))
    jst, _ = jsa.run_chunk(jp, jcfg.base, jeng, jst, 10)
    want = JA._intervene(jp, jcfg.base, jeng, jcfg, jst)

    n_restart = max(1, int(restart * r))
    n_elite = max(1, int(elite * r))
    _, k1, k2 = jax.random.split(jst.key, 3)
    pick = np.asarray(jax.random.randint(k1, (n_restart,), 0, n_elite))
    fresh = np.asarray(jax_random_spins(k2, (n_restart, jp.n_padded),
                                        jp.active_mask))

    teng = make_sweep_engine(tp, tcfg.base)
    assert teng.layout == jeng.layout == "rn"
    spins_rn = np.asarray(jeng.from_layout(jst.spins))
    best_rn = np.asarray(jeng.from_layout(jst.best_spins))
    tst = sa_state_from_numpy(
        spins_rn, jst.energy, jst.best_energy, best_rn, jst.sched.temp,
        jst.sched.acc_ema, 10, device="cpu")
    tst.spins = teng.to_layout(tst.spins)
    tst.best_spins = teng.to_layout(tst.best_spins)
    got = A._intervene(tp, tcfg.base, teng, tcfg, tst, draws=(pick, fresh))

    np.testing.assert_array_equal(teng.from_layout(got.spins).numpy(),
                                  np.asarray(jeng.from_layout(want.spins)))
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5)
    assert float(got.sched.temp) == float(want.sched.temp)
    np.testing.assert_array_equal(got.best_energy.numpy(),
                                  np.asarray(want.best_energy))


def test_intervene_writes_into_the_captured_state():
    """``adaptive_anneal`` assigns ``_intervene``'s state into the captured
    chunk's static tensors: the next replay anneals the restarted spins
    (not the old ones), and equals a fresh step's replay from them."""
    tp, _ = _dense_pair()
    cfg = A.AdaptiveSAConfig(base=SAConfig(
        n_sweeps=20, n_replicas=8, record_interval=5, use_kernel="never",
        schedule=ScheduleConfig(initial_temp=3.0, final_temp=0.05)))
    eng = make_sweep_engine(tp, cfg.base)
    gen = torch.Generator().manual_seed(1)
    step = capture_chunk(tp, cfg.base, eng, init_state(tp, cfg.base, eng, gen),
                         5)
    step.replay(gen)
    static = step.state.spins
    new = A._intervene(tp, cfg.base, eng, cfg, step.state, gen)
    graphs.assign(step.state, new)
    assert step.state.spins is static
    assert torch.equal(static, new.spins)
    assert torch.equal(step.state.energy, new.energy)
    assert torch.equal(step.state.sched.temp, new.sched.temp)
    ref = capture_chunk(tp, cfg.base, eng, graphs.clone(step.state), 5)
    g_ref = graphs.clone_generator(gen)
    step.replay(gen)
    ref.replay(g_ref)
    for name in ("spins", "energy", "best_energy", "best_spins"):
        assert torch.equal(getattr(step.state, name),
                           getattr(ref.state, name)), name


def test_adaptive_finds_ground_state_and_intervenes():
    """``TestAdaptiveSA``'s ferromagnet: the ground state, and stagnation
    fires interventions."""
    n = 16
    j = topology.fully_connected(n, dist="ferromagnetic", scale=1.0)
    p = IsingProblem.from_dense(j, device="cpu")
    cfg = A.AdaptiveSAConfig(
        base=SAConfig(n_sweeps=600, n_replicas=8, record_interval=25,
                      use_kernel="never",
                      schedule=ScheduleConfig(initial_temp=3.0,
                                              final_temp=0.05)),
        stagnation_chunks=3)
    res = A.adaptive_anneal(p, cfg)
    assert res.best_energy == pytest.approx(-0.5 * n * (n - 1), rel=1e-5)
    assert res.metadata["interventions"] >= 1
    assert res.algorithm.startswith("adaptive_sa")
    assert len(res.energy_history) == 600 // 25 and res.n_sweeps == 600


def test_adaptive_config_defaults_match_jax():
    t, j = A.AdaptiveSAConfig(), JA.AdaptiveSAConfig()
    for name in ("stagnation_chunks", "reheat_factor", "restart_fraction",
                 "elite_fraction", "max_interventions"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("n_sweeps", "n_replicas", "record_interval"):
        assert getattr(t.base, name) == getattr(j.base, name), name
    for name in ("initial_temp", "final_temp", "alpha", "total_sweeps"):
        assert (getattr(t.base.schedule, name)
                == getattr(j.base.schedule, name)), name
    assert (t.base.schedule.schedule_type.value
            == j.base.schedule.schedule_type.value)


@pytest.mark.parametrize("n,sweeps,seed", [(10, 50, 0), (16, 80, 3),
                                           (24, 40, 7)])
def test_minimal_equals_jax_copy(n, sweeps, seed):
    """One ``random.Random`` seed: the same instance and the same run."""
    tm = minimal.create_test_problem(n, seed=seed)
    jm = jminimal.create_test_problem(n, seed=seed)
    assert tm.j == jm.j
    tm.set_field(1, 0.5)
    jm.set_field(1, 0.5)
    got = minimal.MinimalAnnealer(n_sweeps=sweeps, seed=seed).anneal(tm)
    want = jminimal.MinimalAnnealer(n_sweeps=sweeps, seed=seed).anneal(jm)
    assert got == want
    assert tm.energy() == jm.energy() == got["final_energy"]
    rng = random.Random(seed)
    tm.randomize(rng)
    assert tm.delta_energy(0) == 2.0 * tm.spins[0] * tm.local_field(0)
