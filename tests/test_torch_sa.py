"""Port parity for the dense SA slice: the driver, sweep for sweep, against
spinglass_tpu.anneal.sa under shared uniforms; end-to-end anneals on the CPU;
and make_engine's choices.

The parity instance is the 64-spin +-J glass of the baseline's first
configuration, R=4 replicas, 200 sweeps of a geometric schedule. Integer
couplings make every field and energy exact, so energies, best energies and
acceptance rates must be equal; temperatures agree to float32 pow (rtol 1e-6).
"""

import dataclasses
import os

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
from spinglass_tpu_torch.core.problem import random_spins  # noqa: E402
from spinglass_tpu_torch.core.rng import host_seed  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
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
    share = res.metadata.pop("best_copy_share")
    # sa_track's twin runs on the CPU: no kernel launch
    assert res.metadata == {"schedule": "geometric", "engine": "blocked",
                            "kernel_launches": {"sa_track": 0},
                            "start_spins": "drawn"}
    assert 0.0 < share <= 1.0
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


def test_unported_options_raise(tmp_path):
    p = IsingProblem.from_dense(np.zeros((8, 8)), device="cpu")
    # checkpointing is ported: a checkpoint every chunk, and a resume from
    # the last one runs nothing and returns the same result
    d = str(tmp_path / "ck")
    first = anneal(p, SAConfig(n_sweeps=2, record_interval=1),
                   checkpoint_dir=d, checkpoint_every=1)
    assert sorted(os.listdir(d)) == ["ckpt_1.pt", "ckpt_2.pt"]
    again = anneal(p, SAConfig(n_sweeps=2, record_interval=1),
                   checkpoint_dir=d, resume=True)
    assert again.n_sweeps == first.n_sweeps == 2
    np.testing.assert_array_equal(again.energy_history, first.energy_history)
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
    compact = engines.make_engine(dense, sweep_method="sparse_compact")
    assert compact.name == "sparse_colored" and compact.layout == "rn"
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


# -- the start spins: drawn on the problem's device -----------------------------

def _glass(n=100, seed=5):
    """A +-J glass of n spins, padded to 128: 28 padded positions."""
    return IsingProblem.from_dense(topology.fully_connected(
        n, dist="binary", seed=seed), device="cpu")


def test_init_state_draws_the_start_from_one_host_seed():
    """The start spins come from a generator on the problem's device seeded
    by one draw of the run's host generator: the same seed gives the same
    start, another seed another, and the host generator moves by that one
    draw."""
    p = _glass()
    cfg = SAConfig(n_sweeps=10, n_replicas=8, sweep_method="blocked")
    eng = sa.make_sweep_engine(p, cfg)
    g = torch.Generator().manual_seed(3)
    a = sa.init_state(p, cfg, eng, g)
    b = sa.init_state(p, cfg, eng, torch.Generator().manual_seed(3))
    c = sa.init_state(p, cfg, eng, torch.Generator().manual_seed(4))
    assert a.generator is g
    assert torch.equal(a.spins, b.spins) and not torch.equal(a.spins, c.spins)
    host = torch.Generator().manual_seed(3)
    dev = torch.Generator(device=p.device).manual_seed(host_seed(host))
    start = random_spins(dev, (8, p.n_padded), p.active_mask)
    assert torch.equal(eng.from_layout(a.spins), start)
    assert torch.equal(g.get_state(), host.get_state())
    assert torch.equal(a.energy, eng.energy(a.spins))
    assert torch.equal(a.best_spins, a.spins) and a.best_spins is not a.spins


def test_drawn_start_is_uniform_with_the_padding_up():
    """[1024, Np]: every active spin is +-1 and their mean lies within 5
    standard deviations of 0; every padded position is +1."""
    p = _glass()
    cfg = SAConfig(n_replicas=1024, sweep_method="blocked")
    eng = sa.make_sweep_engine(p, cfg)
    s = eng.from_layout(sa.init_state(p, cfg, eng,
                                      torch.Generator().manual_seed(9)).spins)
    assert s.shape == (1024, p.n_padded) and p.n_padded > p.n_spins
    assert torch.all(s[:, p.n_spins:] == 1.0)
    active = s[:, :p.n_spins]
    assert torch.all(active.abs() == 1.0)
    # the mean of n independent +-1 has standard deviation 1 / sqrt(n)
    assert abs(float(active.mean())) < 5.0 / active.numel() ** 0.5


def test_anneal_reports_whether_its_start_was_drawn_or_given():
    p = _glass()
    cfg = SAConfig(n_sweeps=4, n_replicas=2, record_interval=2,
                   enable_early_stop=False)
    assert anneal(p, cfg).metadata["start_spins"] == "drawn"
    given = torch.ones(2, p.n_padded)
    res = anneal(p, cfg, init_spins=given)
    assert res.metadata["start_spins"] == "given"
    assert torch.all(given == 1.0)            # copied, never modified
    uniforms = np.full((4, 2, p.n_padded), 0.5, np.float32)
    assert sa._anneal_given(p, cfg, uniforms).metadata["start_spins"] == \
        "drawn"
    assert sa._anneal_given(p, cfg, uniforms, init_spins=given).metadata[
        "start_spins"] == "given"


@pytest.mark.parametrize("kind", ["blocked", "sparse"])
def test_drawn_start_eager_and_captured_runs_agree(kind):
    """``anneal`` (captured chunks) and the eager loop of ``run_chunk``
    from ``init_state`` on one seed: the same histories and best energies,
    and the host generator left in the same state."""
    p = _glass()
    cfg = SAConfig(n_sweeps=30, n_replicas=4, record_interval=10,
                   sweep_method=kind, enable_early_stop=False)
    g_cap, g_eager = (torch.Generator().manual_seed(21),
                      torch.Generator().manual_seed(21))
    res = anneal(p, cfg, generator=g_cap)
    eng = sa.make_sweep_engine(p, cfg)
    st = sa.init_state(p, cfg, eng, g_eager)
    best, mean = [], []
    for _ in range(3):
        st, stats = sa.run_chunk(p, cfg, eng, st, 10)
        best.append(float(stats["best_energy"]))
        mean.append(float(stats["mean_energy"]))
    np.testing.assert_array_equal(res.energy_history, best)
    np.testing.assert_array_equal(res.mean_energy_history, mean)
    np.testing.assert_array_equal(res.replica_best_energy,
                                  st.best_energy.numpy())
    assert torch.equal(g_cap.get_state(), g_eager.get_state())


def test_drawn_start_resumes_bit_for_bit(tmp_path):
    """Checkpoint every chunk, keep only the earliest kept, resume: the
    resumed run draws its start, then takes the checkpoint's state and
    generator, and equals the uninterrupted run."""
    p = _glass()
    cfg = SAConfig(n_sweeps=40, n_replicas=4, record_interval=10,
                   enable_early_stop=False, seed=13)
    ref = anneal(p, cfg)
    d = str(tmp_path / "ck")
    anneal(p, cfg, checkpoint_dir=d, checkpoint_every=1)
    steps = sorted(int(f[5:-3]) for f in os.listdir(d))
    assert steps[0] < 4
    for s in steps[1:]:
        os.remove(os.path.join(d, f"ckpt_{s}.pt"))
    res = anneal(p, cfg, checkpoint_dir=d, resume=True)
    assert res.metadata["start_spins"] == "drawn"
    assert res.best_energy == ref.best_energy
    for name in ("best_spins", "replica_best_energy", "energy_history",
                 "mean_energy_history", "temperature_history",
                 "acceptance_history"):
        np.testing.assert_array_equal(getattr(res, name), getattr(ref, name))


# ---- best tracking: the sa_track kernel's twin and the driver around it ----

def _six_ops(energy, de, best_energy, cnt, spins, best_spins, layout,
             n_spins):
    """The driver's bookkeeping after a sweep before the kernel: six
    PyTorch ops, verbatim."""
    energy = energy + de
    improved = energy < best_energy
    imp_b = improved[None, :] if layout == "nr" else improved[:, None]
    best_energy = torch.where(improved, energy, best_energy)
    best_spins = torch.where(imp_b, spins, best_spins)
    acc_rate = cnt.to(torch.float32) / n_spins
    return energy, best_energy, best_spins, acc_rate, improved


def _track_inputs(layout, dtype, case, rows=100, pad=28, r=12, seed=0):
    """A sweep's [R] state and spins with ``pad`` padding rows: energies
    and changes on a quarter grid, each replica's best set against its new
    energy e by ``case`` ("random": below, equal or above at random; "ties":
    equal; "none": below; "all": above)."""
    g = torch.Generator().manual_seed(seed)
    shape = (rows + pad, r) if layout == "nr" else (r, rows + pad)
    spins, best_spins = ((2 * torch.randint(0, 2, shape, generator=g)
                          - 1).to(dtype) for _ in range(2))
    energy = torch.randint(-400, 400, (r,), generator=g).float() / 4
    de = torch.randint(-40, 41, (r,), generator=g).float() / 4
    e = energy + de
    step = {"random": torch.randint(-1, 2, (r,), generator=g).float() / 4,
            "ties": torch.zeros(r), "none": -torch.ones(r),
            "all": torch.ones(r)}[case]
    cnt = torch.randint(0, rows, (r,), generator=g, dtype=torch.int32)
    return energy, de, e + step, cnt, spins, best_spins, layout, rows


@pytest.mark.parametrize("case", ["random", "ties", "none", "all"])
@pytest.mark.parametrize("layout,dtype", [("nr", torch.float32),
                                          ("nr", torch.int8),
                                          ("rn", torch.float32)])
def test_best_track_twin_is_the_six_ops(layout, dtype, case):
    """On the CPU the best tracking gives exactly the six ops' energies,
    best energies, best spins (padding rows included) and acceptance
    rates, and counts each improved replica's copy (a tie is not one)."""
    from spinglass_tpu_torch.kernels import track_cuda as TC

    args = _track_inputs(layout, dtype, case)
    want = _six_ops(*(a.clone() if torch.is_tensor(a) else a for a in args))
    track = TC.BestTrack()
    before = build.launch_snapshot()
    got = track(*args)
    for g, w in zip(got, want[:4]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    n_imp = {"ties": 0, "none": 0, "all": 12}.get(case)
    if n_imp is not None:
        assert int(want[4].sum()) == n_imp
    assert torch.equal(track.copies, want[4].to(torch.int32))
    track(*args)
    assert torch.equal(track.copies, 2 * want[4].to(torch.int32))
    # the twin is no kernel launch
    assert build.launches_since(before, [TC.KERNEL]) == {TC.KERNEL: 0}
    track.reset(args[0])
    assert not track.copies.any()


class _FakeLib:
    """A stand-in for the built library: records each entry point's
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("sgt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("layout,dtype,elem", [("nr", torch.float32, 4),
                                               ("nr", torch.int8, 1),
                                               ("rn", torch.float32, 4)])
def test_best_track_launch_arguments(monkeypatch, layout, dtype, elem):
    """What the wrapper hands the kernel, through a stand-in for the built
    library: the [R] tensors, 1.0f / n in float32, the spin bytes, the
    layout, the spin rows and R; one launch counted; best_spins (int8)
    given back as it is. A state the kernel does not take is refused:
    float64 spins, float32 best spins, an int64 count."""
    import contextlib
    import types

    from spinglass_tpu_torch.kernels import track_cuda as TC

    fake = _FakeLib()
    monkeypatch.setattr(TC, "load_kernel", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    args = list(_track_inputs(layout, dtype, "random", rows=3000, pad=72))
    args[5] = args[5].to(torch.int8)       # best spins as on the card
    track = TC.BestTrack()
    track.reset(args[0])
    before = build.launch_snapshot()
    out = track._launch(*args)
    (name, a), = fake.calls
    assert name == "sgt_sa_track"
    assert build.launches_since(before, [TC.KERNEL]) == {TC.KERNEL: 1}
    assert a[4] == float(np.float32(1.0) / np.float32(3000))
    assert a[4] != 1.0 / 3000          # the float32 reciprocal, as PyTorch's
    assert a[8] == track.copies.data_ptr()
    assert a[10] == args[5].data_ptr() and out[2] is args[5]
    assert list(a[11:]) == [elem, int(layout == "nr"), 3072, 12, 0]
    bad = list(args)
    bad[4] = args[4].double()
    with pytest.raises(ValueError):
        track._launch(*bad)
    bad = list(args)
    bad[5] = args[5].float()
    with pytest.raises(ValueError):
        track._launch(*bad)
    bad = list(args)
    bad[3] = args[3].long()
    with pytest.raises(ValueError):
        track._launch(*bad)
    with pytest.raises(ValueError):
        track(*args[:6], "cols", args[7])
    assert build.launches_since(before, [TC.KERNEL]) == {TC.KERNEL: 1}


def _six_op_sweep(log, problem, config, engine, state):
    """``sa._one_sweep`` as it was before the kernel (the six ops after the
    sweep, verbatim); appends each sweep's improved replicas to ``log``."""
    from spinglass_tpu_torch.anneal import schedules

    beta = 1.0 / torch.clamp(state.sched.temp, min=1e-10)
    spins, de, cnt = engine.sweep(state.spins, beta, state.generator)
    energy = state.energy + de
    improved = energy < state.best_energy
    imp_b = improved[None, :] if engine.layout == "nr" else improved[:, None]
    best_energy = torch.where(improved, energy, state.best_energy)
    best_spins = torch.where(imp_b, spins, state.best_spins)
    acc_rate = cnt.to(torch.float32) / problem.n_spins
    sched = schedules.update(config.schedule, state.sched, state.sweep,
                             torch.mean(acc_rate))
    log.append(int(improved.sum()))
    return sa.SAState(spins=spins, energy=energy, best_energy=best_energy,
                      best_spins=best_spins, sched=sched,
                      generator=state.generator, sweep=state.sweep + 1,
                      acc_rate=acc_rate)


def _sparse_cpu(n=300, seed=4):
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    coo = topology.sparse_random_graph_coo(n, avg_degree=6.0, dist="binary",
                                           seed=seed)
    return EllProblem.from_coo(n, *coo, device="cpu")


@pytest.mark.parametrize("kind,engine_name", [
    ("dense", "blocked"), ("sparse", "sparse_sorted"),
    ("sparse_t", "sparse_sorted_t")])
def test_anneal_equals_the_six_op_path(monkeypatch, kind, engine_name):
    """``anneal`` on the CPU (the twin) against the driver with the six ops
    in its sweep, on one seed: histories, best energy and spins and every
    replica's best bit for bit; ``best_copy_share`` is the six ops' count of
    improved replicas over sweeps x R. Dense (blocked, [R, Np] float32), a
    sparse graph ([R, N] float32) and its transposed engine ([NS, R]
    int8)."""
    from spinglass_tpu_torch.anneal import graphs

    p = _glass() if kind == "dense" else _sparse_cpu()
    cfg = SAConfig(n_sweeps=30, n_replicas=6, record_interval=10,
                   enable_early_stop=False,
                   sweep_method="blocked" if kind == "dense" else kind)
    graphs.clear_caches()
    res = anneal(p, cfg, generator=torch.Generator().manual_seed(8))
    log = []
    monkeypatch.setattr(sa, "_one_sweep",
                        lambda *a: _six_op_sweep(log, *a))
    graphs.clear_caches()
    ref = anneal(p, cfg, generator=torch.Generator().manual_seed(8))
    graphs.clear_caches()
    assert res.metadata["engine"] == engine_name
    assert res.best_energy == ref.best_energy
    for name in ("best_spins", "replica_best_energy", "energy_history",
                 "mean_energy_history", "temperature_history",
                 "acceptance_history"):
        np.testing.assert_array_equal(getattr(res, name), getattr(ref, name))
    # the warm-up's sweeps come first in the log: the run's are the last 30
    share = res.metadata["best_copy_share"]
    assert share == sum(log[-30:]) / (30 * 6)
    assert 0.0 < share < 1.0
    assert res.metadata["kernel_launches"]["sa_track"] == 0


def test_anneal_counts_one_track_launch_a_sweep(monkeypatch):
    """With a stand-in that counts each call of the best tracking as a
    launch, ``kernel_launches["sa_track"]`` is the sweeps done: through two
    captured chunk lengths (10 and a last of 5; their warm-ups taken back),
    on a repeat call that replays them, on a resumed call and through
    ``_anneal_given``; ``best_copy_share`` lies in [0, 1]."""
    import tempfile

    from spinglass_tpu_torch.anneal import graphs
    from spinglass_tpu_torch.kernels import track_cuda as TC

    call = TC.BestTrack.__call__

    def counted(self, *args):
        build.count_launches({TC.KERNEL: 1})
        return call(self, *args)

    monkeypatch.setattr(TC.BestTrack, "__call__", counted)
    p = _glass()
    cfg = SAConfig(n_sweeps=35, n_replicas=4, record_interval=10,
                   enable_early_stop=False, seed=2)
    graphs.clear_caches()
    first, again = anneal(p, cfg), anneal(p, cfg)
    for res in (first, again):
        assert res.n_sweeps == 35
        assert res.metadata["kernel_launches"]["sa_track"] == 35
        assert 0.0 <= res.metadata["best_copy_share"] <= 1.0
    assert again.metadata["best_copy_share"] == \
        first.metadata["best_copy_share"]
    with tempfile.TemporaryDirectory() as d:
        anneal(p, cfg, checkpoint_dir=d, checkpoint_every=2)
        os.remove(os.path.join(d, "ckpt_4.pt"))
        res = anneal(p, cfg, checkpoint_dir=d, resume=True)
    assert res.metadata["kernel_launches"]["sa_track"] == 35 - 20
    assert 0.0 <= res.metadata["best_copy_share"] <= 1.0
    given = sa._anneal_given(p, dataclasses.replace(cfg, record_interval=7),
                             np.full((35, 4, p.n_padded), 0.5, np.float32))
    assert given.metadata["kernel_launches"]["sa_track"] == 35
    graphs.clear_caches()


@pytest.mark.parametrize("kind", ["blocked", "nr", "sparse", "sparse_t",
                                  "sparse_compact"])
def test_from_layout_copies_int8_best_spins_to_float32(kind):
    """On the card the SA best spins are int8: every engine's
    ``from_layout`` gives them as [R, Np] float32, a copy that later
    updates of the state leave alone (a reader that keeps the best spins of
    a run holds its own); float32 spins come back as float32."""
    cfg = SAConfig(n_replicas=3, sweep_method={
        "blocked": "blocked", "nr": "blocked"}.get(kind, kind))
    p = _glass() if kind in ("blocked", "nr") else _sparse_cpu()
    eng = sa.make_sweep_engine(p, cfg)
    if kind == "nr":   # the base class's "nr" layout, K1's on the card
        eng = type("NR", (engines.SweepEngine,), {"layout": "nr"})(p)
    start = random_spins(torch.Generator().manual_seed(1), (3, p.n_padded),
                         p.active_mask)
    s = eng.to_layout(start)
    best = s.to(torch.int8)
    out = eng.from_layout(best)
    assert out.dtype == torch.float32 and out.shape == (3, p.n_padded)
    assert torch.equal(out, eng.from_layout(s))
    want = out.clone()
    best.neg_()
    assert torch.equal(out, want)
    assert eng.from_layout(s.float()).dtype == torch.float32
