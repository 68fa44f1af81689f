"""Port parity for the cluster updates (``core/cluster.py``) and PT's
cluster-move mix, against ``spinglass_tpu.core.cluster`` and
``spinglass_tpu.anneal.pt``.

The JAX functions draw from keys; the tests derive the same draws from the
keys on the host (``jax.random.split(key, 3)`` and the uniforms / coins of
``SwendsenWang._sweep``; the seed ``randint`` and one uniform per frontier
step of ``wolff_update``) and hand them to the port's ``*_with_draws``
entry points. +-J couplings with h on a quarter grid make every field exact.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

torch.set_num_threads(1)

from spinglass_tpu.anneal import pt as jpt  # noqa: E402
from spinglass_tpu.core import cluster as JC  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JProblem  # noqa: E402
from spinglass_tpu.kernels import sparse as JS  # noqa: E402
from spinglass_tpu_torch.anneal import pt  # noqa: E402
from spinglass_tpu_torch.benchmarks import planted  # noqa: E402
from spinglass_tpu_torch.core import cluster as TC  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.convert import pt_state_from_numpy  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels import cluster_cuda as CC  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402


def _pm_ell(n, degree, seed, field=True):
    rows, cols, vals = topology.sparse_random_graph_coo(
        n, avg_degree=degree, dist="binary", seed=seed)
    h = (np.random.default_rng(seed).integers(-4, 5, n) / 4.0 if field
         else None)
    return (JS.EllProblem.from_coo(n, rows, cols, vals, h),
            S.EllProblem.from_coo(n, rows, cols, vals, h, device="cpu"))


def _spins(r, n_pad, n, seed):
    s = np.where(np.random.default_rng(seed).random((r, n_pad)) < 0.5,
                 -1.0, 1.0).astype(np.float32)
    s[:, n:] = 1.0
    return s


def _sw_draws(key, r, n_pad, k):
    k_bond, k_ghost, k_flip = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k_bond, (r, n_pad, k))),
            np.array(jax.random.uniform(k_ghost, (r, n_pad))),
            np.array(jax.random.bernoulli(k_flip, 0.5, (r, n_pad))))


def _exact_labels(idx, bond, init):
    """Each active site's cluster label by graph search: -1 if a site of its
    cluster starts at -1 (ghost-bonded), else the cluster's least index."""
    r, n = init.shape
    k = idx.shape[1]
    out = np.empty_like(init)
    for q in range(r):
        rows, slots = np.nonzero(bond[q])
        g = coo_matrix((np.ones(len(rows)), (rows, idx[rows, slots])),
                       shape=(n, n))
        _, comp = connected_components(g, directed=True, connection="weak")
        for c in np.unique(comp):
            members = np.nonzero(comp == c)[0]
            lab = init[q, members]
            out[q, members] = -1 if (lab < 0).any() else members.min()
    assert k >= 1
    return out


@pytest.mark.parametrize("n,degree,seed", [(50, 3.0, 0), (200, 6.0, 1),
                                           (300, 4.0, 2), (4000, 6.0, 3)])
def test_reverse_slots_equal_jax(n, degree, seed):
    je, te = _pm_ell(n, degree, seed)
    got = TC._ell_reverse_slots(te.idx.numpy(), te.val.numpy())
    want = JC._ell_reverse_slots(je.idx, je.val)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rev_i, rev_k = got
    real = te.val.numpy() != 0
    np.testing.assert_array_equal(
        te.idx.numpy()[rev_i, rev_k][real],
        np.broadcast_to(np.arange(te.n_padded)[:, None], rev_i.shape)[real])


@pytest.mark.parametrize("kind,beta", [("ell", 0.3), ("ell", 1.2),
                                       ("dense", 0.7)])
def test_sw_sweep_with_jax_draws_equals_jax(kind, beta):
    """One SW sweep, 6 replicas at per-replica temperatures: spins and
    n_clusters equal JAX exactly, dE within 1e-5 relative; the labels equal
    the clusters of the active bonds found by graph search."""
    if kind == "ell":
        jp, tp = _pm_ell(180, 4.0, 3)
    else:
        j = topology.fully_connected(40, dist="binary", seed=4)
        h = np.random.default_rng(4).integers(-4, 5, 40) / 4.0
        jp = JProblem.from_dense(j, h)
        tp = IsingProblem.from_dense(j, h, device="cpu")
    jsw, tsw = JC.SwendsenWang(jp), TC.SwendsenWang(tp)
    r, n_pad = 6, tp.n_padded
    k = tsw.ell.idx.shape[1]
    betas = np.float32(beta) * np.linspace(0.5, 1.5, r, dtype=np.float32)
    s = _spins(r, n_pad, tp.n_spins, 5)
    for trial in range(3):
        key = jax.random.key(17 + trial)
        js, jde, jnc = jsw.sweep(jnp.asarray(s), jnp.asarray(betas), key)
        draws = _sw_draws(key, r, n_pad, k)
        captured = {}
        real = tsw.labeller

        def spy(idx, bond, init):
            captured.update(idx=idx.numpy(), bond=bond.numpy(),
                            init=init.numpy())
            lab, rounds = real(idx, bond, init)
            captured["labels"] = lab.numpy()
            return lab, rounds

        tsw.labeller = spy
        ts, tde, tnc = tsw.sweep_with_draws(
            torch.as_tensor(s), torch.as_tensor(betas),
            *(torch.as_tensor(d) for d in draws))
        tsw.labeller = real
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tnc.numpy(), np.asarray(jnc))
        np.testing.assert_allclose(tde.numpy(), np.asarray(jde), rtol=1e-5)
        act = tp.active_mask.numpy() > 0
        want = _exact_labels(captured["idx"], captured["bond"],
                             captured["init"])
        np.testing.assert_array_equal(captured["labels"][:, act], want[:, act])
        assert (captured["labels"][:, ~act] == n_pad).all()
        assert captured["bond"].any()
        s = ts.numpy()


def _path_bonds(n, rng):
    """One long path through all n sites in shuffled order, both ways."""
    order = rng.permutation(n)
    idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 2))
    bond = np.zeros((1, n, 2), bool)
    for a, b in zip(order[:-1], order[1:]):
        idx[a, 0], bond[0, a, 0] = b, True
        idx[b, 1], bond[0, b, 1] = a, True
    return idx, bond


@pytest.mark.parametrize("case", ["all", "none", "path", "path_ghost",
                                  "random"])
def test_labels_reference_reaches_the_unique_fixed_point(case):
    """The plain labelling (the JAX loop) on adversarial bond sets equals
    the clusters by graph search: everything bonded (one cluster), nothing
    bonded, one long path with shuffled indices (the most rounds), with a
    ghost at its far end, and random bonds."""
    rng = np.random.default_rng(7)
    n = 256
    if case in ("path", "path_ghost"):
        idx, bond = _path_bonds(n, rng)
    else:
        idx = rng.integers(0, n, (n, 4)).astype(np.int32)
        bond = np.zeros((2, n, 4), bool)
        for q in range(2):
            b = {"all": np.ones((n, 4), bool), "none": np.zeros((n, 4), bool),
                 "random": rng.random((n, 4)) < 0.3}[case]
            bond[q] = b
        # symmetric: add each bond's reverse as a slot of the other site
        idx = np.concatenate([idx, np.zeros((n, 4), np.int32)], axis=1)
        bond = np.concatenate([bond, np.zeros_like(bond)], axis=2)
        fill = np.full(n, 4)
        for i, kk in zip(*np.nonzero(bond[0, :, :4] | bond[-1, :, :4])):
            j = idx[i, kk]
            if fill[j] < idx.shape[1]:
                idx[j, fill[j]] = i
                bond[:, j, fill[j]] = bond[:, i, kk]
                fill[j] += 1
            else:
                bond[:, i, kk] = False
    r = bond.shape[0]
    init = np.tile(np.arange(n, dtype=np.int32), (r, 1))
    if case == "path_ghost":
        init[0, rng.integers(0, n)] = -1
    lab, rounds = CC.labels_reference(torch.as_tensor(idx),
                                      torch.as_tensor(bond),
                                      torch.as_tensor(init))
    np.testing.assert_array_equal(lab.numpy(), _exact_labels(idx, bond, init))
    if case == "none":
        assert rounds == 1
    if case == "all":
        assert (lab.numpy() == 0).all()
    if case == "path_ghost":
        assert (lab.numpy() == -1).all()
    # on CUDA tensors the wrapper launches C1; here it runs the plain loop
    labeller = CC.ClusterLabels()
    got, rounds_t = labeller(torch.as_tensor(idx), torch.as_tensor(bond),
                             torch.as_tensor(init))
    assert torch.equal(got, lab) and labeller.launches == 0
    assert labeller._lib is None and rounds_t.tolist() == [rounds] * r


def _wolff_uniforms(key, r, n_pad):
    """The seed sites and a function of the frontier step giving its
    uniforms, as jax's wolff_update draws them from ``key``."""
    k_seed, k_loop = jax.random.split(key)
    keys = []
    kk = k_loop
    for _ in range(n_pad):
        kk, ku = jax.random.split(kk)
        keys.append(ku)
    return k_seed, (lambda step: torch.as_tensor(np.array(
        jax.random.uniform(keys[step], (r, n_pad)))))


@pytest.mark.parametrize("kind,beta", [("dense", 0.2), ("dense", 0.9),
                                       ("ell", 0.4), ("ell", 1.5)])
def test_wolff_with_jax_draws_equals_jax(kind, beta):
    """One Wolff update per replica: spins and cluster sizes equal JAX's."""
    if kind == "dense":
        j = topology.fully_connected(60, dist="binary", seed=8)
        h = np.random.default_rng(8).integers(-4, 5, 60) / 4.0
        jp, tp = JProblem.from_dense(j, h), IsingProblem.from_dense(
            j, h, device="cpu")
        jfn = JC.wolff_update
    else:
        jp, tp = _pm_ell(150, 4.0, 9)
        jfn = JC.wolff_update_ell
    r, n_pad = 5, tp.n_padded
    s = _spins(r, n_pad, tp.n_spins, 10)
    betas = np.float32(beta) * np.linspace(0.5, 1.5, r, dtype=np.float32)
    for trial in range(3):
        key = jax.random.key(30 + trial)
        js, jsize = jfn(jp, jnp.asarray(s), jnp.asarray(betas), key)
        k_seed, uniform_at = _wolff_uniforms(key, r, n_pad)
        seeds = torch.as_tensor(np.array(jax.random.randint(
            k_seed, (r,), 0, tp.n_spins)))
        ts, tsize = TC.wolff_update_with_draws(tp, torch.as_tensor(s),
                                               torch.as_tensor(betas), seeds,
                                               uniform_at)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tsize.numpy(), np.asarray(jsize))
        s = ts.numpy()
    assert (tsize.numpy() >= 1).all()


def _ring(n=6):
    rows = np.arange(n)
    cols = (rows + 1) % n
    vals = np.array([1.0, -1.0, 1.0, 1.0, -1.0, 1.0])[:n]
    h = np.array([0.5, -0.25, 0.0, 0.25, 0.0, -0.5])[:n]
    return (np.concatenate([rows, cols]), np.concatenate([cols, rows]),
            np.concatenate([vals, vals]), h)


def _boltzmann(rows, cols, vals, h, n, beta):
    j = np.zeros((n, n))
    j[rows, cols] = vals
    states = np.array(list(itertools.product([-1.0, 1.0], repeat=n)))
    energies = np.array([-0.5 * s @ j @ s - h @ s for s in states])
    w = np.exp(-beta * (energies - energies.min()))
    codes = ((states > 0) * 2 ** np.arange(n)).sum(axis=1)
    probs = np.zeros(2 ** n)
    probs[codes] = w / w.sum()
    return probs


# Bound on the total-variation distance between the sampled and the exact
# distribution: 400 replicas x 150 recorded sweeps = 60k correlated samples
# over 64 states; the sampling noise alone is ~0.02, a sampler with a wrong
# stationary law (a cluster flip against a field, a bond drawn twice) is off
# by 0.1 or more.
TV_BOUND = 0.04


@pytest.mark.parametrize("method", ["sw", "wolff_ell", "wolff_dense"])
def test_cluster_moves_sample_boltzmann(method):
    """A frustrated 6-ring at beta = 0.8: the sampled states match exact
    enumeration within TV_BOUND. SW runs with a field (its ghost spin keeps
    detailed balance); Wolff without one: the JAX Wolff update, like the
    port's, grows clusters from J alone and ignores h, so it samples the
    Boltzmann law only where h = 0."""
    n, beta, r = 6, 0.8, 400
    rows, cols, vals, h = _ring(n)
    if method != "sw":
        h = np.zeros(n)
    ell = S.EllProblem.from_coo(n, rows, cols, vals, h, device="cpu")
    j = np.zeros((n, n))
    j[rows, cols] = vals
    dense = IsingProblem.from_dense(j, h, device="cpu")
    gen = torch.Generator().manual_seed(1)
    s = torch.ones(r, ell.n_padded)
    s[:, :n] = torch.where(torch.rand(r, n, generator=gen) < 0.5, -1.0, 1.0)
    sw = TC.SwendsenWang(ell)
    counts = np.zeros(2 ** n)
    weights = 2 ** np.arange(n)
    for it in range(200):
        if method == "sw":
            s, _, _ = sw.sweep(s, beta, gen)
        elif method == "wolff_ell":
            s, _ = TC.wolff_update_ell(ell, s, beta, gen)
        else:
            s, _ = TC.wolff_update(dense, s, beta, gen)
        if it >= 50:
            codes = ((s[:, :n].numpy() > 0) * weights).sum(axis=1)
            counts += np.bincount(codes, minlength=2 ** n)
    emp = counts / counts.sum()
    tv = 0.5 * np.abs(emp - _boltzmann(rows, cols, vals, h, n, beta)).sum()
    assert tv < TV_BOUND, f"TV={tv}"
    assert (s[:, n:] == 1).all()


def test_wolff_and_sw_sweeps_keep_the_energy_identity():
    jp, tp = _pm_ell(120, 4.0, 11)
    gen = torch.Generator().manual_seed(2)
    s = torch.as_tensor(_spins(4, tp.n_padded, tp.n_spins, 3))
    e0 = S.sparse_energy(tp, s)
    s1, de, flipped = TC.wolff_sweep_ell(tp, s, 0.5, gen, n_clusters=3)
    torch.testing.assert_close(e0 + de, S.sparse_energy(tp, s1), rtol=0,
                               atol=1e-3)
    assert (flipped >= 3).all()
    s2, de2, ncl = TC.SwendsenWang(tp).sweep(s1, 0.5, gen)
    torch.testing.assert_close(S.sparse_energy(tp, s1) + de2,
                               S.sparse_energy(tp, s2), rtol=0, atol=1e-3)
    dense = IsingProblem.from_dense(topology.grid_2d(5, 5, dist="binary",
                                                     seed=3), device="cpu")
    sd = torch.as_tensor(_spins(3, dense.n_padded, dense.n_spins, 4))
    sd1, de3, _ = TC.wolff_sweep(dense, sd, 0.5, gen, n_clusters=2)
    from spinglass_tpu_torch.core import energy as E

    torch.testing.assert_close(E.energy(dense, sd) + de3, E.energy(dense, sd1),
                               rtol=0, atol=1e-3)


class _JaxKeyUniforms(JS.SortedSparseTEngine):
    """Test-only JAX T engine: sweeps with uniforms drawn from the sweep key
    by ``sweep_with_uniforms``, so the host can replay them."""

    def sweep(self, spins_t, beta, key):
        u = jax.random.uniform(key, (self.n_sorted, spins_t.shape[1]),
                               jnp.float32)
        return self.sweep_with_uniforms(spins_t, beta, u)


class _TorchGivenUniforms(S.SortedSparseTEngine):
    def __init__(self, problem, queue):
        super().__init__(problem)
        self.queue = queue

    def sweep(self, spins_t, beta, generator):
        return self.sweep_with_uniforms(spins_t, beta,
                                        torch.as_tensor(self.queue.pop(0)))


def test_super_step_with_cluster_moves_matches_jax(monkeypatch):
    """Two PT super-steps (5 sweeps, one SW sweep, exchange, resync; 2
    chains of 4 replicas) fed the JAX driver's key chain: spins, slots,
    best spins and exchange counts equal, energies within 1e-5 relative."""
    inst = planted.planted_gauge_coo(150, 4.0, seed=13, frustration=0.2,
                                     magnitude="ones")
    jell = JS.EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                  inst.vals)
    tell = S.EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                 inst.vals, device="cpu")
    kw = dict(n_replicas=4, n_chains=2, exchange_interval=5, min_temp=0.3,
              max_temp=3.0, sweep_method="sparse_t", cluster_moves=1, seed=3)
    jcfg, tcfg = jpt.PTConfig(**kw), pt.PTConfig(**kw)
    queue, sw_queue, ex_u = [], [], []

    class GivenDraws(TC.SwendsenWang):
        def sweep(self, spins, beta, generator):
            return self.sweep_with_draws(
                spins, beta, *(torch.as_tensor(d) for d in sw_queue.pop(0)))

    monkeypatch.setattr(pt, "SwendsenWang", GivenDraws)
    monkeypatch.setattr(pt, "_exchange_draws",
                        lambda cfg, gen, dev: (None, torch.as_tensor(ex_u.pop(0))))
    jeng, teng = _JaxKeyUniforms(jell), _TorchGivenUniforms(tell, queue)
    jstep, _, _ = jpt.make_pt_step(jell, jcfg, engine=jeng)
    tstep, _, _ = pt.make_pt_step(tell, tcfg, engine=teng)
    assert tstep.sw is not None and tstep.counters[-1][0] == "sw_labels"
    jstep = jax.jit(jstep)
    jst = jpt.init_state(jell, jcfg, jax.random.key(5), jeng)
    tst = pt_state_from_numpy(
        np.asarray(jst.spins), np.asarray(jst.slot), np.asarray(jst.energy),
        np.asarray(jst.best_energy), np.asarray(jst.best_spins),
        int(jst.sweep), np.asarray(jst.exch_attempts),
        np.asarray(jst.exch_accepts), src_layout="nr", layout="nr",
        spin_dtype=np.int8, device="cpu")
    r_total, n_pad, k = 8, tell.n_padded, tell.idx.shape[1]
    for step in range(2):
        key = jst.key
        for _ in range(kw["exchange_interval"]):
            key, ku = jax.random.split(key)
            queue.append(np.array(jax.random.uniform(
                ku, (jeng.n_sorted, r_total), jnp.float32)))
        key, kc = jax.random.split(key)
        sw_queue.append(_sw_draws(kc, r_total, n_pad, k))
        key, kx = jax.random.split(key)
        ex_u.append(np.array(jax.random.uniform(kx, (2, 3))))
        jst, jstats = jstep(jst, None)
        tst, tstats = tstep(tst)
        assert not queue and not sw_queue and not ex_u
        for name in ("slot", "exch_attempts", "exch_accepts", "spins",
                     "best_spins"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)), name)
        for name in ("energy", "best_energy"):
            np.testing.assert_allclose(getattr(tst, name).numpy(),
                                       np.asarray(getattr(jst, name)),
                                       rtol=1e-5)
        np.testing.assert_array_equal(tstats["slot_of_replica"].numpy(),
                                      np.asarray(jstats["slot_of_replica"]))


def test_pt_run_with_cluster_moves_on_the_cpu():
    """pt.run with cluster_moves: the captured step's CPU replay equals the
    eager super-step loop, the best energy is the energy of the best
    spins, and C1 is listed among the launches (0 on the CPU)."""
    inst = planted.planted_gauge_coo(120, 4.0, seed=2)
    ell = S.EllProblem.from_coo(120, inst.rows, inst.cols, inst.vals,
                                device="cpu")
    cfg = pt.PTConfig(n_replicas=4, n_sweeps=60, exchange_interval=5,
                      cluster_moves=2, seed=6)
    res = pt.run(ell, cfg)
    assert res.metadata["kernel_launches"]["sw_labels"] == 0
    s = torch.ones(1, ell.n_padded)
    s[0, :120] = torch.as_tensor(res.best_spins)
    assert float(S.sparse_energy(ell, s)[0]) == pytest.approx(res.best_energy,
                                                              rel=1e-5)
    step, _, eng = pt.make_pt_step(ell, cfg)
    st = pt.init_state(ell, cfg, torch.Generator().manual_seed(6), eng)
    best = []
    for _ in range(12):
        st, stats = step(st)
        best.append(float(stats["best_energy"]))
    np.testing.assert_array_equal(res.energy_history, np.float32(best))
