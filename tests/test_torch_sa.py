"""Port parity for the dense SA slice: the driver, sweep for sweep, against
spinglass_tpu.anneal.sa under shared uniforms; end-to-end anneals on the CPU;
and make_engine's choices.

The parity instance is the 64-spin +-J glass of the baseline's first
configuration, R=4 replicas, 200 sweeps of a geometric schedule. Integer
couplings make every field and energy exact, so energies, best energies and
acceptance rates must be equal; temperatures agree to float32 pow (rtol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.anneal import sa as jsa  # noqa: E402
from spinglass_tpu.anneal.engines import BlockedXLAEngine  # noqa: E402
from spinglass_tpu.anneal.schedules import (  # noqa: E402
    ScheduleConfig as JaxScheduleConfig, ScheduleType as JaxScheduleType)
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.kernels import sweeps as JK  # noqa: E402
from spinglass_tpu_torch import (  # noqa: E402
    AnnealResult, IsingProblem, SAConfig, ScheduleConfig, ScheduleType, anneal,
    magnetization)
from spinglass_tpu_torch.anneal import engines, sa  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.convert import (  # noqa: E402
    problem_from_numpy, sa_state_from_numpy)
from spinglass_tpu_torch.kernels import sweeps as K  # noqa: E402

N, R, SWEEPS = 64, 4, 200


class _JaxGivenUniforms(BlockedXLAEngine):
    """Test-only JAX engine: ignores the PRNG key and consumes the next
    [R, Np] block of the shared uniforms."""

    def __init__(self, problem, uniforms):
        super().__init__(problem, block_size=128)
        self.uniforms, self.t = uniforms, 0

    def sweep(self, spins, beta, key):
        u = jnp.asarray(self.uniforms[self.t])
        self.t += 1
        return JK.blocked_sweep(self.problem, spins, beta, u,
                                block_size=self.block_size, rule=self.rule)


class _TorchGivenUniforms(engines.BlockedEngine):
    """The port's counterpart: ignores the generator, same uniforms."""

    def __init__(self, problem, uniforms):
        super().__init__(problem, block_size=128)
        self.uniforms, self.t = uniforms, 0

    def sweep(self, spins, beta, generator):
        u = torch.as_tensor(self.uniforms[self.t])
        self.t += 1
        return K.blocked_sweep(self.problem, spins, beta, u,
                               block_size=self.block_size, rule=self.rule)


def test_driver_matches_jax_sweep_for_sweep():
    j = topology.fully_connected(N, dist="binary", seed=1)
    jp = JaxProblem.from_dense(j)
    tp = problem_from_numpy(np.asarray(jp.j), np.asarray(jp.h),
                            np.asarray(jp.active_mask), jp.n_spins,
                            device="cpu")
    rng = np.random.default_rng(7)
    uniforms = rng.random((SWEEPS, R, jp.n_padded)).astype(np.float32)
    init = np.where(rng.random((R, jp.n_padded)) < 0.5, -1.0, 1.0)
    init[:, N:] = 1.0
    init = init.astype(np.float32)

    jcfg = jsa.SAConfig(n_sweeps=SWEEPS, n_replicas=R, schedule=JaxScheduleConfig(
        JaxScheduleType.GEOMETRIC, initial_temp=5.0, final_temp=0.05))
    tcfg = SAConfig(n_sweeps=SWEEPS, n_replicas=R, schedule=ScheduleConfig(
        ScheduleType.GEOMETRIC, initial_temp=5.0, final_temp=0.05))
    jeng = _JaxGivenUniforms(jp, uniforms)
    teng = _TorchGivenUniforms(tp, uniforms)
    jst = jsa.init_state(jp, jcfg, jeng, jax.random.key(0), jnp.asarray(init))
    tst = sa_state_from_numpy(np.asarray(jst.spins), np.asarray(jst.energy),
                              np.asarray(jst.best_energy),
                              np.asarray(jst.best_spins),
                              np.asarray(jst.sched.temp),
                              np.asarray(jst.sched.acc_ema), int(jst.sweep),
                              device="cpu")
    ref_init = sa.init_state(tp, tcfg, teng, init_spins=torch.as_tensor(init))
    assert torch.equal(tst.energy, ref_init.energy)
    assert torch.equal(tst.spins, ref_init.spins)

    for t in range(SWEEPS):
        jst = jsa._one_sweep(jp, jcfg, jeng, jst)
        tst = sa._one_sweep(tp, tcfg, teng, tst)
        np.testing.assert_array_equal(tst.energy.numpy(), np.asarray(jst.energy))
        np.testing.assert_array_equal(tst.best_energy.numpy(),
                                      np.asarray(jst.best_energy))
        np.testing.assert_array_equal(tst.acc_rate.numpy(),
                                      np.asarray(jst.acc_rate))
        assert float(tst.sched.temp) == pytest.approx(float(jst.sched.temp),
                                                      rel=1e-6), t
    np.testing.assert_array_equal(tst.spins.numpy(), np.asarray(jst.spins))
    np.testing.assert_array_equal(tst.best_spins.numpy(),
                                  np.asarray(jst.best_spins))
    assert tst.sweep == int(jst.sweep) == SWEEPS
    # the chunk's exact-energy resync agrees with the incremental energies
    resynced = teng.energy(tst.spins)
    np.testing.assert_array_equal(resynced.numpy(), tst.energy.numpy())


def test_run_chunk_equals_sweep_loop_and_resyncs():
    p = IsingProblem.from_dense(topology.fully_connected(40, dist="gaussian",
                                                         seed=2), device="cpu")
    cfg = SAConfig(n_sweeps=30, n_replicas=3, sweep_method="blocked")
    eng = sa.make_sweep_engine(p, cfg)
    a = sa.init_state(p, cfg, eng, torch.Generator().manual_seed(3))
    b = sa.init_state(p, cfg, eng, torch.Generator().manual_seed(3))
    for _ in range(10):
        a = sa._one_sweep(p, cfg, eng, a)
    b, stats = sa.run_chunk(p, cfg, eng, b, 10)
    assert torch.equal(a.spins, b.spins) and b.sweep == 10
    np.testing.assert_allclose(b.energy.numpy(), a.energy.numpy(), rtol=1e-5)
    assert float(stats["best_energy"]) == float(torch.min(b.best_energy))
    assert float(stats["temperature"]) == float(b.sched.temp)


def test_ferromagnet_reaches_ground_state():
    n = 16
    p = IsingProblem.from_dense(topology.fully_connected(
        n, dist="ferromagnetic", seed=0), device="cpu")
    res = anneal(p, SAConfig(n_sweeps=100, n_replicas=4, record_interval=10))
    assert isinstance(res, AnnealResult)
    assert res.best_energy == -n * (n - 1) / 2
    assert res.best_spins.shape == (n,)
    assert abs(float(magnetization(p, torch.as_tensor(
        np.pad(res.best_spins, (0, p.n_padded - n), constant_values=1.0))))) == 1.0
    assert res.device == "cpu" and res.algorithm == "sa/blocked/metropolis"
    assert res.n_sweeps == 100 and res.n_replicas == 4
    assert len(res.energy_history) == len(res.temperature_history) == 10
    assert res.replica_best_energy.shape == (4,)
    capture_s = res.metadata.pop("capture_seconds")
    assert res.metadata == {"schedule": "geometric", "engine": "blocked",
                            "kernel_launches": {}}
    assert capture_s >= 0.0   # 0.0 where the problem's steps were cached
    assert res.sweeps_per_second > 0 and res.spin_flips_per_second > 0


def test_early_stop_and_colored_engine():
    """An 8x8 grid ferromagnet is 2-colourable, so auto picks the colored
    engine; once the best energy holds still for 20 records the run stops."""
    p = IsingProblem.from_dense(topology.grid_2d(8, 8, dist="ferromagnetic"), device="cpu")
    cfg = SAConfig(n_sweeps=400, n_replicas=4, record_interval=2,
                   schedule=ScheduleConfig(initial_temp=2.0, final_temp=0.05))
    res = anneal(p, cfg)
    assert res.algorithm == "sa/colored/metropolis"
    assert res.best_energy == -112.0
    assert res.converged and res.convergence_sweep == res.n_sweeps < 400
    assert len(res.energy_history) == res.n_sweeps // 2
    assert np.all(res.energy_history[-20:] == -112.0)


def test_anneal_is_seeded_and_glauber_runs():
    p = IsingProblem.from_dense(topology.fully_connected(30, dist="gaussian",
                                                         seed=4), device="cpu")
    cfg = SAConfig(n_sweeps=20, n_replicas=2, update_rule="glauber",
                   record_interval=5)
    a, b = anneal(p, cfg), anneal(p, cfg)
    np.testing.assert_array_equal(a.best_spins, b.best_spins)
    assert a.best_energy == b.best_energy
    c = anneal(p, dataclasses.replace(cfg, seed=7))
    assert c.seed == 7 and np.isfinite(c.best_energy)


def test_unported_options_raise():
    p = IsingProblem.from_dense(np.zeros((8, 8)), device="cpu")
    with pytest.raises(NotImplementedError):
        anneal(p, SAConfig(n_sweeps=2), checkpoint_dir="/nonexistent")
    # j_dtype="bfloat16" is ported: it runs, and an unknown dtype raises
    res = anneal(p, SAConfig(n_sweeps=2, j_dtype="bfloat16"))
    assert res.n_sweeps == 2 and np.isfinite(res.best_energy)
    with pytest.raises(ValueError, match="j_dtype"):
        SAConfig(j_dtype="float16")
    # anneal_scan is ported: it runs and returns the JAX keys
    state, hist = sa.anneal_scan(p, SAConfig(n_sweeps=2, record_interval=1))
    assert sorted(hist) == sorted(sa.STAT_KEYS)
    assert all(v.shape == (2,) for v in hist.values()) and int(state.sweep) == 2


def test_make_engine_choices():
    dense = IsingProblem.from_dense(topology.fully_connected(20, seed=0), device="cpu")
    assert isinstance(engines.make_engine(dense), engines.BlockedEngine)
    assert isinstance(engines.make_engine(dense, use_kernel="never"),
                      engines.BlockedEngine)
    grid = IsingProblem.from_dense(topology.grid_2d(4, 4), device="cpu")
    assert isinstance(engines.make_engine(grid), engines.ColoredEngine)
    with pytest.raises(ValueError, match="no CPU mode"):
        engines.make_engine(dense, use_kernel="always")
    for method, name in (("sparse", "sparse_sorted"),
                         ("sparse_t", "sparse_sorted_t")):
        assert engines.make_engine(dense, sweep_method=method).name == name
    with pytest.raises(NotImplementedError, match="sparse_compact"):
        engines.make_engine(dense, sweep_method="sparse_compact")
    sparse = IsingProblem.from_dense(topology.random_graph(
        engines.SPARSE_MIN_SPINS, density=0.002, dist="binary", seed=1), device="cpu")
    # sparse enough for the sorted sparse engine; on the CPU the [R, N] one
    assert engines.make_engine(sparse, r_hint=1024).name == "sparse_sorted"
    assert isinstance(engines.make_engine(sparse, sweep_method="blocked"),
                      engines.BlockedEngine)


def test_sa_state_from_numpy_layouts():
    """A JAX state in the Pallas engine's [Np, R] layout lands in the port's
    [R, Np] layout (and the reverse), values unchanged."""
    rng = np.random.default_rng(3)
    s_nr = np.where(rng.random((128, 5)) < 0.5, -1.0, 1.0).astype(np.float32)
    e = rng.normal(size=5).astype(np.float32)
    st = sa_state_from_numpy(s_nr, e, e, s_nr, 2.5, 0.44, 7,
                             src_layout="nr", layout="rn", device="cpu")
    assert st.spins.shape == (5, 128) and st.spins.is_contiguous()
    np.testing.assert_array_equal(st.spins.numpy(), s_nr.T)
    assert st.sweep == 7 and float(st.sched.temp) == 2.5
    assert st.acc_rate.shape == (5,)
    back = sa_state_from_numpy(st.spins.numpy(), e, e, st.spins.numpy(), 2.5,
                               0.44, 7, src_layout="rn", layout="nr",
                               device="cpu")
    np.testing.assert_array_equal(back.best_spins.numpy(), s_nr)
    with pytest.raises(ValueError):
        sa_state_from_numpy(s_nr, e, e, s_nr, 1.0, 0.4, 0, src_layout="xy",
                            device="cpu")
