"""Simulated quantum annealing and PIMC on a sparse problem
(``spinglass_tpu_torch.research.quantum`` on an ``EllProblem``), on the CPU:
the sparse Trotter problem against the dense one entry for entry and its
two colours; the engine's in-place coupling rewrite against a fresh build;
SQA with the state carried against the plain reference
``tests/torch_reference/sqa2d.py`` (spins on the lattice, ``torch.roll``)
on given uniforms; ``carry_state=False`` as before; PIMC on an
``EllProblem``; the counters.

Tolerances: the Trotter couplings exact (J/P and J_perp computed in float64
and cast once on both paths). States after every stage equal: the port
decides s f < -ln(u) / (2 beta) in float32 on couplings cast once to
float32, the reference u < exp(-beta dE) in float64, so a decision could
differ only where a field lies within float32 rounding (~1e-7 relative) of
its threshold, which the continuous couplings and uniforms of these fixed
seeds never bring about in the few thousand decisions here. Energies and
actions to 2e-6 relative: the port sums in float32 over couplings rounded
to float32 (about 1e-7 relative each), the reference in float64.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu_torch.anneal import graphs, sa  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.core.topology import lattice_coo  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402
from spinglass_tpu_torch.research import quantum as Q  # noqa: E402

_SPEC = importlib.util.spec_from_file_location(
    "torch_reference_sqa2d",
    pathlib.Path(__file__).parent / "torch_reference" / "sqa2d.py")
ref = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ref)

RTOL = 2e-6


def _ell(L, seed=0, h=None):
    n, rows, cols, vals = lattice_coo(L, dims=2, dist="uniform", scale=2.0,
                                      seed=seed)
    return S.EllProblem.from_coo(n, rows, cols, vals, h=h, device="cpu")


def _dense_of(ell):
    """The Trotter problem's couplings as a dense [Np, Np] float32 J."""
    j = torch.zeros(ell.n_padded, ell.n_padded)
    rows = torch.arange(ell.n_padded)[:, None].expand_as(ell.idx)
    j.index_put_((rows.reshape(-1), ell.idx.long().reshape(-1)),
                 ell.val.reshape(-1), accumulate=True)
    return j


@pytest.mark.parametrize("L,seed", [(4, 0), (6, 3), (80, 20020329)])
def test_2d_lattice_matches_the_reference_generator(L, seed):
    n, rows, cols, vals = lattice_coo(L, dims=2, dist="uniform", scale=2.0,
                                      seed=seed)
    rn, rrows, rcols, rvals = ref.coo(ref.couplings(L, seed))
    assert n == rn == L * L
    for a, b in ((rows, rrows), (cols, rcols), (vals, rvals)):
        np.testing.assert_array_equal(a, b)
    assert np.all(np.abs(vals) < 2.0) and len(rows) == 4 * n


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5])
def test_sparse_trotterize_equals_the_dense_one(p):
    """J, h and the mask of the sparse Trotter problem equal the dense
    Trotter problem's entry for entry (a field on a quarter grid and one
    that rounds); time bonds: 2 N P directed entries, N for P = 2, none
    for P = 1."""
    L = 4
    h = np.random.default_rng(p).normal(0.0, 0.5, L * L)
    ell = _ell(L, seed=p, h=h)
    n, rows, cols, vals = lattice_coo(L, dims=2, dist="uniform", scale=2.0,
                                      seed=p)
    j = np.zeros((n, n))
    j[rows, cols] = vals
    dense = IsingProblem.from_dense(j, h, device="cpu")
    want = Q.trotterize(dense, p, beta=2.0, gamma=0.7)
    got = Q.trotterize(ell, p, beta=2.0, gamma=0.7)
    assert isinstance(got, Q.TrotterEll) and not hasattr(got, "j")
    assert got.n_spins == want.n_spins == p * n
    assert got.n_padded == want.n_padded
    assert torch.equal(_dense_of(got), want.j)
    assert torch.equal(got.h, want.h)
    assert torch.equal(got.active_mask, want.active_mask)
    edges = 0 if p == 1 else 1 if p == 2 else p
    assert len(got.time_bonds.rows) == 2 * edges * n
    assert float(got.field) == float(np.float32(Q.j_perp(2.0, 0.7, p)))


@pytest.mark.parametrize("L,p", [(4, 2), (6, 4), (80, 20)])
def test_the_even_trotter_lattice_has_degree_six_and_two_colours(L, p):
    """L and P even: the layered lattice is bipartite, and the balanced
    greedy colouring gives exactly 2 colours, the sublattice p + x + y even
    first (at 80 x 80 x 20: 768,000 directed entries)."""
    tp = Q.trotterize(_ell(L, seed=1), p, beta=20.0, gamma=2.5)
    n = p * L * L
    nnz = int((tp.val != 0).sum())
    assert nnz == n * (5 if p == 2 else 6)
    if (L, p) == (80, 20):
        assert nnz == 768_000
        assert bool(((tp.val[:n] != 0).sum(dim=1) == 6).all())
    colors = S._coloring(tp, 256)
    assert int(colors.max()) + 1 == 2
    par = np.indices((p, L, L)).sum(axis=0).ravel() % 2
    np.testing.assert_array_equal(colors[:n], par)


def _tables(eng):
    """Every copy of the couplings that ``eng`` keeps."""
    t = eng.kernels.tables
    slots = [] if t is None else [t["val"], eng.kernels._val_t]
    return ([b.val for _, _, bs in eng.groups for b in bs] + slots
            + [eng._coupling.values()])


@pytest.mark.parametrize("accept", ["single", "fused", "none"])
def test_coupling_rewrite_equals_a_fresh_build(accept):
    """An engine built at Gamma_a, its time bonds rewritten to J_perp at
    Gamma_b, against an engine built fresh at Gamma_b: every table equal,
    and so the energies, K2's twin and K4's twin on given thresholds and
    seeds, and the threshold path."""
    L, p, r = 6, 4, 8
    base = _ell(L, seed=2)
    old = Q.trotterize(base, p, beta=2.0, gamma=2.5)
    new = Q.trotterize(base, p, beta=2.0, gamma=0.3)
    a = S.SortedSparseTEngine(old, accept_kernel=accept)
    b = S.SortedSparseTEngine(new, accept_kernel=accept)
    assert not torch.equal(a._coupling.values(), b._coupling.values())
    a.write_couplings(old.time_bonds, new.field)
    a.write_couplings(old.time_bonds, new.field)   # mapped once, kept
    assert list(a._written) == [old.time_bonds]
    assert len(_tables(a)) == len(_tables(b))
    for x, y in zip(_tables(a), _tables(b)):
        assert torch.equal(x, y)
    g = torch.Generator().manual_seed(5)
    s = (2 * torch.randint(0, 2, (r, old.n_padded), generator=g) - 1).float()
    sa_, sb = a.to_layout(s, torch.float32), b.to_layout(s, torch.float32)
    assert torch.equal(a.energy(sa_), b.energy(sb))
    beta = torch.full((r,), 1.5)
    u = torch.rand(r, old.n_padded, generator=g)
    for eng, st in ((a, sa_), (b, sb)):
        eng.sweep_with_uniforms(st, beta, eng.to_layout(u, torch.float32))
    assert torch.equal(sa_, sb)
    if accept != "none":
        for eng, st in ((a, sa_), (b, sb)):
            eng.kernels.accept_sweep(st, beta, 12345)
        assert torch.equal(sa_, sb)


def test_set_field_rewrites_the_cached_engine():
    """``TrotterEll.set_field`` reaches the engine that ``sa.anneal`` keeps
    for the problem: after it the engine's tables equal a fresh engine's
    at the new field."""
    base = _ell(4, seed=4)
    tp = Q.trotterize(base, 4, beta=2.0, gamma=2.0)
    cfg = sa.SAConfig(n_sweeps=10, n_replicas=4, enable_early_stop=False,
                      sweep_method="sparse_t")
    graphs.clear_caches()
    sa.anneal(tp, cfg)
    engine, = graphs.sa_engines_of(tp)
    tp.set_field(2.0, 0.1)
    fresh = S.SortedSparseTEngine(Q.trotterize(base, 4, beta=2.0, gamma=0.1))
    for x, y in zip(_tables(engine), _tables(fresh)):
        assert torch.equal(x, y)
    graphs.clear_caches()


def test_write_couplings_refuses_an_entry_that_is_no_coupling():
    tp = Q.trotterize(_ell(4), 4, beta=2.0, gamma=1.0)
    eng = S.SortedSparseTEngine(tp)
    with pytest.raises(ValueError, match="coupling"):
        eng.write_couplings(S.CouplingSet(np.array([0]), np.array([2])),
                            tp.field)


def _carried_case(L=6, p=4, r=4, stages=3, sweeps=8, seed=7):
    base = _ell(L, seed=seed)
    rng = np.random.default_rng(seed)
    n_pad = Q.trotterize(base, p, 1.0, 1.0).n_padded
    s0 = np.ones((r, n_pad), np.float32)
    s0[:, : p * L * L] = np.where(rng.random((r, p * L * L)) < 0.5, -1, 1)
    u = rng.random((stages * sweeps, r, n_pad)).astype(np.float32)
    draws = [(s0 if k == 0 else None, u[k * sweeps:(k + 1) * sweeps])
             for k in range(stages)]
    cfg = Q.SQAConfig(n_trotter=p, beta=4.0, gamma_start=2.5,
                      n_stages=stages, sweeps_per_stage=sweeps, n_replicas=r,
                      carry_state=True, gamma_schedule="linear", seed=3)
    return base, cfg, s0, u, draws


def test_carried_sqa_matches_the_reference(monkeypatch):
    """SQA at L=6, P=4, R=4 with the state carried and the linear ramp, on
    given start spins and uniforms: the state after every stage equals the
    reference's; every replica's action at the last Gamma, its slice
    energies, its least slice energy and the job's best match."""
    L = 6
    base, cfg, s0, u, draws = _carried_case(L=L)
    p, r, n = cfg.n_trotter, cfg.n_replicas, L * L
    after = []
    drawn = Q.anneal_drawn

    def spy(*args, final_spins=None, **kw):
        res = drawn(*args, final_spins=final_spins, **kw)
        after.append(final_spins.clone())
        return res

    monkeypatch.setattr(Q, "anneal_drawn", spy)
    got = Q.simulated_quantum_annealing(base, cfg, draws=draws)
    j = ref.couplings(L, 7)
    gammas = ref.linear_gammas(cfg.gamma_start, cfg.n_stages)
    np.testing.assert_array_equal(got.metadata["gammas"], gammas)
    states = ref.sqa(j, ref.lattice(torch.as_tensor(s0[:, : p * n]).double(),
                                    L, p),
                     cfg.beta, gammas, cfg.sweeps_per_stage,
                     lambda t: ref.lattice(torch.as_tensor(
                         u[t, :, : p * n]).double(), L, p))
    assert len(after) == len(states) == cfg.n_stages
    for mine, want in zip(after, states):
        np.testing.assert_array_equal(
            ref.lattice(mine[:, : p * n], L, p).numpy(), want.numpy())
    final = states[-1]
    np.testing.assert_array_equal(
        ref.lattice(got.metadata["final_state"][:, : p * n], L, p).numpy(),
        final.numpy())
    moved = float((final != ref.lattice(torch.as_tensor(
        s0[:, : p * n]).double(), L, p)).double().mean())
    assert 0.05 < moved < 0.95
    e, least = ref.decode(j, final)
    np.testing.assert_allclose(got.metadata["slice_energies"], e.numpy(),
                               rtol=RTOL)
    np.testing.assert_allclose(got.replica_best_energy, least.numpy(),
                               rtol=RTOL)
    jp = float(np.float32(ref.j_perp(cfg.beta, gammas[-1], p)))
    np.testing.assert_allclose(got.metadata["final_action"],
                               ref.action(j, final, jp).numpy(), rtol=RTOL)
    assert got.best_energy == pytest.approx(float(least.min()), rel=RTOL)
    k = int(np.argmin(got.replica_best_energy))
    np.testing.assert_array_equal(
        got.best_spins, final[k, int(e[k].argmin())].reshape(-1).numpy())
    np.testing.assert_array_equal(
        got.metadata["replica_spins"],
        final[torch.arange(r), e.argmin(dim=1)].reshape(r, n).numpy())
    assert got.metadata["slice_energy_mean"] == pytest.approx(
        float(e.mean()), rel=RTOL)
    corr = ref.correlation(final)
    assert bool(((corr > -1) & (corr <= 1)).all())


def test_carried_sqa_counts_its_stages_writes_and_sweeps():
    base, cfg, *_ = _carried_case(stages=4, sweeps=6)
    graphs.clear_caches()
    l0 = build.launch_snapshot()
    first = Q.simulated_quantum_annealing(base, cfg)
    again = Q.simulated_quantum_annealing(base, cfg)
    md = first.metadata
    assert (md["stages"], md["field_writes"], md["sweeps"]) == (4, 4, 24)
    assert first.n_sweeps == 24
    assert md["captures"] == 1 and again.metadata["captures"] == 0
    assert md["kernel_launches"] == {} and build.launches_since(l0) == {}
    flips = 24 * cfg.n_replicas * cfg.n_trotter * base.n_spins
    assert first.spin_flips_per_second * first.total_time == \
        pytest.approx(flips)
    assert again.best_energy == first.best_energy   # the same default seed
    assert len(md["final_action"]) == cfg.n_replicas
    assert md["replica_spins"].dtype == np.int8
    assert md["replica_spins"].shape == (cfg.n_replicas, base.n_spins)
    assert np.all(np.abs(md["replica_spins"]) == 1)
    graphs.clear_caches()


def test_carried_sqa_starts_each_stage_from_the_last():
    """Stage k + 1's anneal gets stage k's final spins as its start; with
    ``carry_state`` False every stage draws its own."""
    base, cfg, *_ = _carried_case(stages=3, sweeps=4)
    for carried in (True, False):
        starts = []
        drawn = Q.anneal_drawn

        def spy(*args, init_spins=None, final_spins=None, **kw):
            starts.append(None if init_spins is None else init_spins.clone())
            res = drawn(*args, init_spins=init_spins,
                        final_spins=final_spins, **kw)
            starts.append(None if final_spins is None else
                          final_spins.clone())
            return res

        Q.anneal_drawn = spy
        try:
            Q.simulated_quantum_annealing(
                base, Q.SQAConfig(**{**cfg.__dict__,
                                     "carry_state": carried}))
        finally:
            Q.anneal_drawn = drawn
        if carried:
            for k in range(1, 3):   # start of stage k == end of stage k - 1
                assert torch.equal(starts[2 * k], starts[2 * k - 1])
        else:
            assert all(s is None for s in starts)


def test_fresh_sparse_sqa_is_a_sequence_of_fresh_anneals():
    """``carry_state`` False (the default) on an ``EllProblem``: each stage
    anneals the Trotter problem at its Gamma from its own start spins and
    the best slice of its best replica is kept, as the JAX function does;
    the defaults and the geometric schedule are the JAX function's."""
    assert Q.SQAConfig().carry_state is False
    assert Q.SQAConfig().gamma_schedule == "geometric"
    with pytest.raises(ValueError):
        Q.SQAConfig(gamma_schedule="cosine")
    base, cfg, s0, u, _ = _carried_case(stages=2, sweeps=5)
    cfg = Q.SQAConfig(**{**cfg.__dict__, "carry_state": False,
                         "gamma_schedule": "geometric", "gamma_end": 0.5})
    rng = np.random.default_rng(1)
    draws = [(np.where(rng.random(s0.shape) < 0.5, -1.0, 1.0).astype(
        np.float32), u[5 * k:5 * (k + 1)]) for k in range(2)]
    for d in draws:
        d[0][:, cfg.n_trotter * base.n_spins:] = 1.0
    got = Q.simulated_quantum_annealing(base, cfg, draws=draws)
    gammas = np.geomspace(2.5, 0.5, 2)
    np.testing.assert_array_equal(got.metadata["gammas"], gammas)
    best, hist = np.inf, []
    for k, gamma in enumerate(gammas):
        tp = Q.trotterize(base, cfg.n_trotter, cfg.beta, float(gamma))
        res = sa._anneal_given(tp, Q.stage_config(cfg, 5, cfg.seed + k,
                                                  "sparse_t"),
                               draws[k][1], None, torch.tensor(draws[k][0]))
        _, e = Q.slice_energies(base, res.best_spins, cfg.n_trotter)
        best = min(best, float(e.min()))
        hist.append(best)
    assert got.best_energy == best
    np.testing.assert_array_equal(got.energy_history, hist)
    assert "final_action" not in got.metadata


def test_pimc_on_an_ell_problem():
    """PIMC takes an ``EllProblem`` through the sparse builder: the
    transposed sparse engine sweeps, and the reported energy is the
    reference's energy of the returned slice."""
    L = 6
    base = _ell(L, seed=11)
    res = Q.path_integral_monte_carlo(base, Q.PIMCConfig(
        n_trotter=4, beta=4.0, gamma=0.5, n_sweeps=60, n_replicas=4))
    assert res.algorithm == "pimc" and res.metadata["engine"] == \
        "sparse_sorted_t"
    assert len(res.metadata["slice_energies"]) == 4
    s = torch.as_tensor(res.best_spins, dtype=torch.float64)
    want = float(ref.energies(ref.couplings(L, 11), s.reshape(1, L, L))[0])
    assert res.best_energy == pytest.approx(want, rel=RTOL)
    assert res.best_energy == min(res.metadata["slice_energies"])
