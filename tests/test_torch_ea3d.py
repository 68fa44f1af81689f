"""The 3-D Edwards-Anderson +-J glass on the port's parallel tempering,
against the plain reference ``tests/torch_reference/ea3d.py`` (spins on the
lattice, neighbours by ``torch.roll``): the lattice, its two colours, PT
super-steps on given uniforms (spins, slots, energies and overlaps equal),
the overlap twin, the super-step without overlaps unchanged, and the
``pt.*`` spans."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu_torch.anneal import pt  # noqa: E402
from spinglass_tpu_torch.anneal.engines import (GivenUniforms,  # noqa: E402
                                                make_engine)
from spinglass_tpu_torch.core.topology import lattice_coo  # noqa: E402
from spinglass_tpu_torch.kernels import build, overlap_cuda  # noqa: E402
from spinglass_tpu_torch.kernels.sparse import EllProblem  # noqa: E402
from spinglass_tpu_torch.utils.profiling import global_profiler  # noqa: E402

_SPEC = importlib.util.spec_from_file_location(
    "torch_reference_ea3d",
    pathlib.Path(__file__).parent / "torch_reference" / "ea3d.py")
ref = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ref)

STATS = {"best_energy", "cold_energy", "mean_acceptance", "slot_energy",
         "slot_of_replica"}


def _problem(L, seed=0):
    return EllProblem.from_coo(*lattice_coo(L, seed=seed), device="cpu")


@pytest.mark.parametrize("L,seed", [(4, 0), (4, 7), (6, 0), (6, 7)])
def test_lattice_matches_the_reference_generator(L, seed):
    n, rows, cols, vals = lattice_coo(L, seed=seed)
    rn, rrows, rcols, rvals = ref.coo(ref.couplings(L, seed))
    assert n == rn == L ** 3
    for a, b in ((rows, rrows), (cols, rcols), (vals, rvals)):
        np.testing.assert_array_equal(a, b)
    assert set(np.unique(vals)) == {-1.0, 1.0}


@pytest.mark.parametrize("L", [4, 6, 32])
def test_lattice_has_degree_six_and_two_colours(L):
    n, rows, cols, vals = lattice_coo(L, seed=3)
    assert len(rows) == 2 * 3 * n
    assert (np.bincount(rows, minlength=n) == 6).all()
    assert len(set(zip(rows.tolist(), cols.tolist()))) == len(rows)
    p = EllProblem.from_coo(n, rows, cols, vals, device="cpu")
    eng = make_engine(p, sweep_method="sparse_t", r_hint=136)
    assert eng.name == "sparse_sorted_t" and eng.n_colors == 2
    # colour 0 is the even sublattice, each colour one span of N / 2 rows
    perm = eng.perm[eng.perm >= 0]
    par = np.indices((L,) * 3).sum(axis=0).ravel() % 2
    assert (par[perm[: n // 2]] == 0).all() and (par[perm[n // 2:]] == 1).all()
    assert [size for _, size, _ in eng.groups][0] >= n // 2
    if L == 32:
        assert len(rows) == 196_608 and eng.n_sorted == n


def test_open_lattice_and_small_sides():
    n, rows, _, _ = lattice_coo(3, periodic=False)
    assert len(rows) == 2 * 3 * 9 * 2   # both ways, 3 axes, 9 lines of 2 bonds
    with pytest.raises(ValueError):
        lattice_coo(2)


@pytest.mark.parametrize("rule", ["heat_bath", "metropolis"])
def test_super_steps_match_the_reference(rule, monkeypatch):
    """Three super-steps (5 sweeps, an exchange, the resync, the overlaps)
    at L=4, 2 chains of 4 slots, on given sweep and exchange uniforms: the
    port's spins, slots, energies and overlaps equal the reference's."""
    L, n_chains, t, interval, steps = 4, 2, 4, 5, 3
    r_total = n_chains * t
    p = _problem(L, seed=5)
    j = ref.couplings(L, 5)
    cfg = pt.PTConfig(n_replicas=t, n_chains=n_chains, ladder="linear",
                      min_temp=0.7, max_temp=1.6, update_rule=rule,
                      exchange_interval=interval, measure_overlaps=True,
                      sweep_method="sparse_t")
    rng = np.random.default_rng(11)
    u = rng.random((steps * interval, r_total, p.n_padded)).astype(np.float32)
    ex_u = [rng.random((n_chains, t - 1)).astype(np.float32)
            for _ in range(steps)]
    eng = GivenUniforms(make_engine(p, sweep_method="sparse_t",
                                    update_rule=rule), u)
    step, betas, _ = pt.make_pt_step(p, cfg, engine=eng)
    queue = list(ex_u)
    monkeypatch.setattr(pt, "_exchange_draws", lambda c, g, d: (
        None, torch.as_tensor(queue.pop(0))))
    state = pt.init_state(p, cfg, torch.Generator().manual_seed(2), eng)
    s = ref.lattice(eng.from_layout(state.spins)[:, : L ** 3], L)
    slot = torch.arange(t).repeat(n_chains)
    temps = np.linspace(0.7, 1.6, t)
    b_ref = torch.as_tensor(1.0 / temps)
    sweeps, accepted = 0, 0
    for k in range(steps):
        state, stats = step(state)
        for _ in range(interval):
            s = ref.sweep(j, s, b_ref[slot], torch.as_tensor(
                u[sweeps, :, : L ** 3]).t().reshape(s.shape), rule)
            sweeps += 1
        e = ref.energies(j, s)
        new = ref.exchange(e, slot, b_ref, torch.as_tensor(ex_u[k]),
                           (sweeps // interval) % 2)
        accepted += int((new != slot).sum())
        slot = new
        got = eng.from_layout(state.spins)[:, : L ** 3]
        np.testing.assert_array_equal(got.numpy(),
                                      s.reshape(-1, r_total).t().numpy())
        np.testing.assert_array_equal(state.slot.numpy(), slot.numpy())
        np.testing.assert_array_equal(state.energy.numpy(), e.float().numpy())
        np.testing.assert_array_equal(stats["slot_overlap"].numpy(),
                                      ref.overlaps(s, slot, n_chains).float()
                                      .numpy())
        assert set(stats) == STATS | {"slot_overlap"}
    assert not queue and accepted > 0


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
@pytest.mark.parametrize("n_chains", [2, 4])
def test_overlap_twin_matches_the_reference(dtype, n_chains):
    """Random [rows, C T] states with padding rows and a random slot
    permutation per chain: the twin (and ``ReplicaOverlap`` on the CPU)
    equal the reference's q on the real rows."""
    rng = np.random.default_rng(n_chains)
    rows, t, n_real = 96, 5, 70
    s = torch.as_tensor(np.where(rng.random((rows, n_chains * t)) < 0.6,
                                 1, -1)).to(dtype)
    real = np.zeros(rows, bool)
    real[rng.choice(rows, n_real, replace=False)] = True
    mask = torch.as_tensor(np.where(real, 0.0, -np.inf), dtype=torch.float32)
    slot = torch.as_tensor(np.concatenate(
        [rng.permutation(t) for _ in range(n_chains)]), dtype=torch.int32)
    want = ref.overlaps(s[torch.as_tensor(real)], slot, n_chains).float()
    got = overlap_cuda.overlap_reference(s, mask, slot, n_chains, n_real)
    assert got.dtype == torch.float32
    assert got.shape == (t, n_chains * (n_chains - 1) // 2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    op = overlap_cuda.ReplicaOverlap(mask, n_chains, n_real)
    before = build.launch_snapshot()
    assert torch.equal(op(s, slot), got)
    assert build.launches_since(before, [overlap_cuda.KERNEL]) == {
        overlap_cuda.KERNEL: 0}


@pytest.mark.parametrize("method", ["sparse", "sparse_t", "sparse_compact",
                                    "blocked", "colored"])
def test_each_engine_masks_the_padding_of_its_own_layout(method):
    """``row_mask`` is 0 on the rows of real spins and -inf on padding,
    along the spin axis of the engine's own layout (the sorted layouts'
    order and padding too), and ``GivenUniforms`` forwards it where it
    takes the engine; so the overlap of a state with itself counts the N
    real spins."""
    from spinglass_tpu_torch.core.problem import IsingProblem

    if method in ("blocked", "colored"):   # 100 spins padded to 128
        j = np.triu(np.random.default_rng(1).normal(size=(100, 100)), 1)
        p = IsingProblem.from_dense(j + j.T, device="cpu")
    else:                                  # 125 spins, 7 colours' padding
        p = _problem(5)
    eng = make_engine(p, sweep_method=method)
    mask = eng.row_mask()
    s = eng.to_layout(torch.ones(4, p.n_padded), torch.float32)
    rows = s if eng.layout == "nr" else s.t()
    assert mask.dtype == torch.float32 and mask.shape == (rows.shape[0],)
    assert int((mask == 0).sum()) == p.n_spins
    assert bool(torch.isneginf(mask[mask != 0]).all())
    q = overlap_cuda.overlap_reference(rows, mask, torch.tensor(
        [0, 1, 0, 1], dtype=torch.int32), 2, p.n_spins)
    assert torch.equal(q, torch.ones(2, 1))
    if eng.name in GivenUniforms.ENGINES:
        given = GivenUniforms(eng, np.zeros((1, 4, p.n_padded), np.float32))
        assert torch.equal(given.row_mask(), mask)


def test_overlaps_off_leave_the_super_step_unchanged():
    """``measure_overlaps`` False (the default): today's stats keys and
    step kernels; on: one more key and the overlap kernel, and the same
    states from the same generator."""
    p = _problem(4)
    kw = dict(n_replicas=4, n_chains=2, exchange_interval=3,
              sweep_method="sparse_t")
    out = {}
    for on in (False, True):
        cfg = pt.PTConfig(**kw, measure_overlaps=on)
        step, _, eng = pt.make_pt_step(p, cfg)
        st = pt.init_state(p, cfg, torch.Generator().manual_seed(4), eng)
        for _ in range(2):
            st, stats = step(st)
        out[on] = (st, stats, step.kernel_names, eng.kernel_names)
    (a, sa, ca, la), (b, sb, cb, lb) = out[False], out[True]
    assert set(sa) == STATS and set(sb) == STATS | {"slot_overlap"}
    assert ca == la and cb == lb + (overlap_cuda.KERNEL,)
    for name in ("spins", "slot", "energy", "best_energy", "best_spins"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert pt.PTConfig().measure_overlaps is False
    with pytest.raises(ValueError):
        pt.PTConfig(measure_overlaps=True, n_chains=1)


def test_pt_run_records_overlaps_and_their_moments():
    p = _problem(4, seed=1)
    cfg = pt.PTConfig(n_replicas=4, n_chains=3, n_sweeps=60, ladder="linear",
                      min_temp=0.7, max_temp=1.6, update_rule="heat_bath",
                      exchange_interval=10, measure_overlaps=True,
                      sweep_method="sparse_t")
    res = pt.run(p, cfg)
    md = res.metadata
    q = md["slot_overlap_history"]
    assert q.shape == (6, 4, 3) and md["overlap_measurements"] == 6
    assert np.all(np.abs(q) <= 1) and np.all(q * 64 == np.round(q * 64))
    np.testing.assert_allclose(md["overlap_moments"]["q2"],
                               (q.astype(np.float64) ** 2).mean(axis=(0, 2)))
    np.testing.assert_allclose(md["overlap_moments"]["q4"],
                               (q.astype(np.float64) ** 4).mean(axis=(0, 2)))
    plain = pt.run(p, pt.PTConfig(n_replicas=4, n_chains=3, n_sweeps=60,
                                  sweep_method="sparse_t"))
    assert plain.metadata["overlap_measurements"] == 0
    assert "overlap_moments" not in plain.metadata


def test_pt_spans_nest_under_pt_run():
    p = _problem(4, seed=2)
    cfg = pt.PTConfig(n_replicas=4, n_chains=2, n_sweeps=20,
                      sweep_method="sparse_t", measure_overlaps=True)
    pt.run(p, cfg)                      # captured: the second call replays
    with global_profiler.recording() as spans:
        pt.run(p, cfg)
    names = [s.name for s in spans]
    assert names[0] == "pt.run" and spans[0].parent == -1
    assert names.count("pt.run") == 1
    assert names.count("pt.start") == names.count("pt.result") == 1
    assert names.count("step.launch") == 2
    assert all(s.parent == 0 for s in spans[1:])
    assert names.index("pt.start") < names.index("step.fill") < \
        names.index("pt.result")
    assert all(s.end_ns is not None for s in spans)
    assert spans[0].end_ns >= max(s.end_ns for s in spans[1:])
