"""Port parity for the sparse slice: COO generators, colouring, the ELL and
sorted layouts, sparse fields/energies and the sparse engines, against
spinglass_tpu on the same numpy inputs.

+-J couplings with h on a quarter grid make every field exact, so flips,
counts, dE and energies must be equal bit for bit; Gaussian couplings are
held to rtol 1e-5 (float32 sums in another order). Uniforms are drawn below
0.999999, where the clamped Glauber threshold of the kernels equals the
unclamped one of ``accept_threshold``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.anneal import engines as jengines  # noqa: E402
from spinglass_tpu.core import topology as JT  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.kernels import sparse as JS  # noqa: E402
from spinglass_tpu_torch.anneal import engines, sa  # noqa: E402
from spinglass_tpu_torch.core import topology as T  # noqa: E402
from spinglass_tpu_torch.core.convert import (  # noqa: E402
    ell_from_numpy, problem_from_numpy)
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402
from spinglass_tpu_torch.kernels import sparse_cuda as SC  # noqa: E402
from spinglass_tpu_torch.kernels.metropolis_cuda import (  # noqa: E402
    kernel_threshold, philox_uniforms4)

N = 300


def _coo(n=N, dist="binary", seed=3, deg=5.0):
    return T.sparse_random_graph_coo(n, avg_degree=deg, dist=dist, seed=seed)


def _pair(n=N, dist="binary", seed=3, with_h=True):
    """The same instance as a JAX and a port EllProblem."""
    coo = _coo(n, dist, seed)
    h = (np.random.default_rng(seed).integers(-8, 9, n) / 4.0
         if with_h else None)
    return (JS.EllProblem.from_coo(n, *coo, h=h),
            S.EllProblem.from_coo(n, *coo, h=h, device="cpu"))


def _spins(r, n_pad, n, seed=0):
    s = np.where(np.random.default_rng(seed).random((r, n_pad)) < 0.5,
                 -1.0, 1.0).astype(np.float32)
    s[:, n:] = 1.0
    return s


@pytest.mark.parametrize("dist", ["binary", "gaussian"])
def test_sparse_random_graph_coo_matches_jax(dist):
    for a, b in zip(T.sparse_random_graph_coo(500, avg_degree=6.0, dist=dist,
                                              seed=9),
                    JT.sparse_random_graph_coo(500, avg_degree=6.0, dist=dist,
                                               seed=9)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("balanced", [False, True])
def test_greedy_coloring_coo_matches_jax(balanced):
    rows, cols, _ = _coo(seed=4)
    ours = T.greedy_coloring_coo(rows, cols, N, balanced=balanced)
    np.testing.assert_array_equal(
        ours, JT.greedy_coloring_coo(rows, cols, N, balanced=balanced))
    assert np.all(ours[rows] != ours[cols])  # a proper colouring
    with pytest.raises(ValueError):
        T.greedy_coloring_coo(rows, cols, N, max_colors=2, balanced=balanced)


def test_ell_from_coo_and_from_problem_match_jax():
    je, te = _pair()
    for name in ("idx", "val", "h", "active_mask"):
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)), name)
    assert (te.n_spins, te.n_padded, te.max_degree) == (
        je.n_spins, je.n_padded, je.max_degree)
    assert te.idx.dtype == torch.int32 and te.device.type == "cpu"
    j = T.random_graph(120, density=0.05, dist="gaussian", seed=2)
    jp = JaxProblem.from_dense(j)
    tp = problem_from_numpy(np.asarray(jp.j), np.asarray(jp.h),
                            np.asarray(jp.active_mask), jp.n_spins,
                            device="cpu")
    jf, tf = JS.EllProblem.from_problem(jp), S.EllProblem.from_problem(tp)
    np.testing.assert_array_equal(tf.idx.numpy(), np.asarray(jf.idx))
    np.testing.assert_array_equal(tf.val.numpy(), np.asarray(jf.val))
    assert tf.h is tp.h and tf.n_spins == 120


def test_ell_from_terms_and_numpy_match_jax():
    rng = np.random.default_rng(5)
    terms = types.SimpleNamespace(
        quad_i=rng.integers(0, 50, 80), quad_j=rng.integers(0, 50, 80),
        quad_v=rng.normal(size=80), lin_i=rng.integers(0, 50, 10),
        lin_v=rng.normal(size=10))
    keep = terms.quad_i != terms.quad_j
    terms.quad_i, terms.quad_j = terms.quad_i[keep], terms.quad_j[keep]
    terms.quad_v = terms.quad_v[keep]
    je, te = JS.ell_from_terms(50, terms), S.ell_from_terms(50, terms, device="cpu")
    np.testing.assert_array_equal(te.idx.numpy(), np.asarray(je.idx))
    np.testing.assert_array_equal(te.val.numpy(), np.asarray(je.val))
    np.testing.assert_array_equal(te.h.numpy(), np.asarray(je.h))
    back = ell_from_numpy(np.asarray(je.idx), np.asarray(je.val),
                          np.asarray(je.h), np.asarray(je.active_mask),
                          je.n_spins, device="cpu")
    assert torch.equal(back.idx, te.idx) and torch.equal(back.val, te.val)


@pytest.mark.parametrize("bucket_order", ["degree", "index"])
def test_build_sorted_t_matches_jax(bucket_order):
    je, te = _pair(dist="gaussian")
    colors = T.greedy_coloring_coo(*_coo(dist="gaussian")[:2], N, balanced=True)
    jperm, jinv, jgroups, jmask, jns = JS.build_sorted_t(
        je, colors, bucket_order=bucket_order)
    perm, inv, groups, mask, ns = S.build_sorted_t(
        te, colors, bucket_order=bucket_order)
    assert ns == jns and ns % 256 == 0
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    assert [(o, m) for o, m, _ in groups] == [(o, m) for o, m, _ in jgroups]
    for (_, _, bs), (_, _, jbs) in zip(groups, jgroups):
        assert [(b.off, b.m, b.k) for b in bs] == [(b.off, b.m, b.k)
                                                   for b in jbs]
        for b, jb in zip(bs, jbs):
            np.testing.assert_array_equal(b.idx, np.asarray(jb.idx))
            np.testing.assert_array_equal(b.val, np.asarray(jb.val))
            np.testing.assert_array_equal(b.h, np.asarray(jb.h))
    with pytest.raises(ValueError):
        S.build_sorted_t(te, colors, bucket_order="random")


def test_build_single_tables_match_jax():
    je, te = _pair(dist="gaussian")
    colors = T.greedy_coloring_coo(*_coo(dist="gaussian")[:2], N, balanced=True)
    _, _, jgroups, _, jns = JS.build_sorted_t(je, colors)
    _, _, groups, _, ns = S.build_sorted_t(te, colors)
    ours = S.build_single_tables(groups, ns)
    theirs = JS.build_single_tables(jgroups, jns)
    for a, b in zip(ours[:4], theirs[:4]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert ours[4] == theirs[4]
    # the per-row degree K2 loops to: non-zeros first, zeros after
    idx_all, val_all, deg = ours[0], ours[1], ours[5]
    np.testing.assert_array_equal(deg, (val_all != 0).sum(axis=1))
    slots = np.arange(val_all.shape[1])[None, :]
    assert np.all((val_all != 0) == (slots < deg[:, None]))


@pytest.mark.parametrize("dist", ["binary", "gaussian"])
def test_sparse_fields_and_energy_match_jax(dist):
    je, te = _pair(dist=dist)
    s = _spins(5, te.n_padded, N, seed=1)
    f = S.sparse_local_fields(te, torch.as_tensor(s)).numpy()
    e = S.sparse_energy(te, torch.as_tensor(s)).numpy()
    jf = np.asarray(JS.sparse_local_fields(je, jnp.asarray(s)))
    jen = np.asarray(JS.sparse_energy(je, jnp.asarray(s)))
    if dist == "binary":
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(e, jen)
    else:
        np.testing.assert_allclose(f, jf, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(e, jen, rtol=1e-5)


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_t_engine_sweeps_match_jax(rule):
    """The T engine's threshold path and K2's twin (accept_kernel="single")
    against the JAX T engine's XLA path under shared uniforms, per-replica
    beta, three sweeps: spins, counts, dE and energies bit for bit, padding
    rows inert."""
    je, te = _pair()
    r = 128
    jeng = JS.SortedSparseTEngine(je, rule=rule)
    plain = S.SortedSparseTEngine(te, rule=rule)
    single = S.SortedSparseTEngine(te, rule=rule, accept_kernel="single")
    assert plain.spin_dtype == torch.int8 and single.spin_dtype == torch.float32
    rng = np.random.default_rng(11)
    s_rn = _spins(r, te.n_padded, N, seed=2)
    beta = rng.uniform(0.2, 2.0, r).astype(np.float32)
    js = jeng.to_layout(jnp.asarray(s_rn))
    jsweep, jenergy = jax.jit(jeng.sweep_with_uniforms), jax.jit(jeng.energy)
    ps = plain.to_layout(torch.as_tensor(s_rn))
    ss = single.to_layout(torch.as_tensor(s_rn))
    pad = plain.perm < 0
    assert pad.any()
    for _ in range(3):
        u = (rng.random((plain.n_sorted, r)) * 0.999999).astype(np.float32)
        js, jde, jc = jsweep(js, jnp.asarray(beta), jnp.asarray(u))
        ps, pde, pc = plain.sweep_with_uniforms(ps, torch.as_tensor(beta),
                                                torch.as_tensor(u))
        ss, sde, sc = single.sweep_with_uniforms(ss, torch.as_tensor(beta),
                                                 torch.as_tensor(u))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(pde.numpy(), np.asarray(jde))
        assert torch.equal(ss, ps.float()) and torch.equal(sc, pc)
        assert torch.equal(sde, pde)
        np.testing.assert_array_equal(plain.energy(ps).numpy(),
                                      np.asarray(jenergy(js)))
    assert np.all(ss.numpy()[pad] == single.to_layout(
        torch.as_tensor(s_rn)).numpy()[pad])
    assert int(pc.sum()) > 0


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_sorted_sparse_engine_rn_matches_jax(rule):
    je, te = _pair()
    jeng, teng = JS.SortedSparseEngine(je, rule=rule), S.SortedSparseEngine(
        te, rule=rule)
    np.testing.assert_array_equal(teng.perm, jeng.perm)
    rng = np.random.default_rng(12)
    r = 6
    s_rn = _spins(r, te.n_padded, N, seed=3)
    js, ts = jeng.to_layout(jnp.asarray(s_rn)), teng.to_layout(
        torch.as_tensor(s_rn))
    beta = rng.uniform(0.2, 2.0, r).astype(np.float32)
    jsweep = jax.jit(jeng.sweep_with_uniforms)
    for _ in range(3):
        u = (rng.random((r, te.n_padded)) * 0.999999).astype(np.float32)
        js, jde, jc = jsweep(js, jnp.asarray(beta), jnp.asarray(u))
        ts, tde, tc = teng.sweep_with_uniforms(ts, torch.as_tensor(beta),
                                               torch.as_tensor(u))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tde.numpy(), np.asarray(jde))
    np.testing.assert_array_equal(teng.energy(ts).numpy(),
                                  np.asarray(jeng.energy(js)))
    np.testing.assert_array_equal(teng.from_layout(ts).numpy(),
                                  np.asarray(jeng.from_layout(js)))


def test_make_engine_matches_jax():
    """Same engine class as the JAX package (on its CPU backend) over
    r_hint x sweep_method x {EllProblem, sparse dense problem}."""
    je, te = _pair(n=150)
    j = T.random_graph(engines.SPARSE_MIN_SPINS, density=0.002, dist="binary",
                       seed=1)
    jp = JaxProblem.from_dense(j)
    tp = problem_from_numpy(np.asarray(jp.j), np.asarray(jp.h),
                            np.asarray(jp.active_mask), jp.n_spins,
                            device="cpu")
    assert engines.SPARSE_T_MIN_REPLICAS == jengines.SPARSE_T_MIN_REPLICAS
    for jprob, tprob in ((je, te), (jp, tp)):
        for method in ("auto", "sparse", "sparse_t"):
            for r_hint in (0, 16, 128, 1024):
                want = jengines.make_engine(jprob, sweep_method=method,
                                            r_hint=r_hint).name
                got = engines.make_engine(tprob, sweep_method=method,
                                          r_hint=r_hint).name
                assert got == want, (type(tprob).__name__, method, r_hint)
    for prob in (te, tp):
        with pytest.raises(NotImplementedError, match="sparse_compact"):
            engines.make_engine(prob, sweep_method="sparse_compact")


def test_thresholds_reference_and_philox_twin():
    """K3's twin is kernel_threshold(philox_uniforms4) masked (the sparse
    kernels' stream: four uniforms per Philox call); K2's twin in Philox
    mode makes the decisions of the per-colour sweep on K3's twin."""
    _, te = _pair()
    eng = S.SortedSparseTEngine(te, rule="glauber", accept_kernel="single")
    r, seed = 128, 2 ** 40 + 77
    beta = torch.linspace(0.2, 3.0, r)
    th = eng.kernels.thresholds(beta, seed, r)
    u = philox_uniforms4(seed, eng.n_sorted, r)
    want = kernel_threshold(u, beta[None, :], "glauber")
    want = torch.where(eng.mask_col < 0, torch.full_like(want, -torch.inf), want)
    assert torch.equal(th, want)
    assert torch.all(torch.isneginf(th[torch.as_tensor(eng.perm < 0)]))
    s0 = eng.to_layout(torch.as_tensor(_spins(r, te.n_padded, N, seed=4)))
    a, de_a, c_a = eng.kernels.single_sweep(s0.clone(), beta, seed=seed)
    b, de_b, c_b = SC.single_sweep_reference(eng.groups, s0.clone(), th)
    assert torch.equal(a, b) and torch.equal(c_a, c_b) and torch.equal(de_a, de_b)
    assert eng.launches == {"sparse_sweep": 0, "sparse_thresholds": 0,
                            "sparse_accept": 0}
    with pytest.raises(ValueError, match="exactly one"):
        eng.kernels.single_sweep(s0, beta)
    ns = eng.n_sorted
    assert SC.default_tile(128, ns) == 1
    assert SC.default_tile(1024, ns) == 8
    assert SC.default_tile(8192, ns) == 8
    assert SC.default_tile(37, ns) == 1


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("spin_dtype", [torch.int8, torch.float32])
def test_fused_sweep_twin_matches_jax_sorted_t_sweep(rule, spin_dtype):
    """make_sorted_t_sweep_fused's twin under seed s makes the decisions of
    the JAX per-colour sweep fed the port's Philox thresholds for s (K3's
    twin), and K4's twin on one colour equals that colour's slice of it:
    spins, counts and dE bit for bit over two sweeps."""
    je, te = _pair()
    r = 128
    eng = S.SortedSparseTEngine(te, rule=rule, spin_dtype=spin_dtype,
                                accept_kernel="fused", bucket_order="index")
    jeng = JS.SortedSparseTEngine(je, rule=rule, bucket_order="index")
    np.testing.assert_array_equal(eng.perm, jeng.perm)
    jsweep = jax.jit(JS.make_sorted_t_sweep(jeng.groups))
    fused = S.make_sorted_t_sweep_fused(eng.kernels)
    s_rn = _spins(r, te.n_padded, N, seed=7)
    ts = eng.to_layout(torch.as_tensor(s_rn))
    js = jeng.to_layout(jnp.asarray(s_rn)).astype(
        jnp.int8 if spin_dtype == torch.int8 else jnp.float32)
    beta = torch.linspace(0.2, 2.5, r)
    for seed in (2 ** 40 + 5, 12345):
        th = SC.thresholds_reference(eng.mask_col, beta, seed, r, rule)
        js, jde, jc = jsweep(js, jnp.asarray(th.numpy()))
        ts, tde, tc = fused(ts, beta, seed)
        assert ts.dtype == spin_dtype
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tde.numpy(), np.asarray(jde))
    assert int(tc.sum()) > 0
    # one colour through the twin alone
    off, mc, bs = eng.groups[1]
    f = S._colour_fields(ts, bs)
    s_a, s_b = ts.clone(), ts.clone()
    de = torch.zeros(r)
    cnt = torch.zeros(r, dtype=torch.int32)
    SC.accept_reference(f, s_a, off, eng.mask_col, beta, 99, rule, de, cnt)
    th = SC.thresholds_reference(eng.mask_col, beta, 99, r, rule)[off:off + mc]
    acc = s_b[off:off + mc].float() * f < th
    s_b[off:off + mc] = torch.where(acc, -s_b[off:off + mc], s_b[off:off + mc])
    assert torch.equal(s_a, s_b) and torch.equal(cnt, acc.sum(0, dtype=torch.int32))
    assert eng.launches["sparse_accept"] == 0


def test_t_engine_layout_energy_and_dispatch(monkeypatch):
    je, te = _pair(dist="gaussian")
    eng = S.SortedSparseTEngine(te)
    s_rn = torch.as_tensor(_spins(4, te.n_padded, N, seed=5))
    s_t = eng.to_layout(s_rn)
    assert s_t.shape == (eng.n_sorted, 4) and s_t.is_contiguous()
    assert torch.equal(eng.from_layout(s_t), s_rn)
    np.testing.assert_allclose(eng.energy(s_t).numpy(),
                               S.sparse_energy(te, s_rn).numpy(), rtol=1e-5)
    # CPU auto: no kernels, int8 threshold path with host uniforms
    assert not eng._use_single and not eng._use_kernel_rng
    gen = torch.Generator().manual_seed(0)
    e0 = eng.energy(s_t)
    s1, de, cnt = eng.sweep(s_t, 0.7, gen)
    np.testing.assert_allclose((e0 + de).numpy(), eng.energy(s1).numpy(),
                               rtol=1e-4, atol=1e-3)
    assert int(cnt.sum()) > 0
    # "fused" runs K4's twin on the CPU (the JAX package refuses it off the
    # TPU), and needs R % 128 == 0 as in the JAX package
    fused = S.SortedSparseTEngine(te, accept_kernel="fused")
    assert fused.spin_dtype == torch.int8 and not fused._use_single
    s128 = fused.to_layout(torch.as_tensor(_spins(128, te.n_padded, N, seed=6)))
    e0 = fused.energy(s128)
    s128, de, cnt = fused.sweep(s128, 0.7, gen)
    np.testing.assert_allclose((e0 + de).numpy(), fused.energy(s128).numpy(),
                               rtol=1e-4, atol=1e-3)
    assert int(cnt.sum()) > 0 and fused.launches == {
        "sparse_sweep": 0, "sparse_thresholds": 0, "sparse_accept": 0}
    with pytest.raises(ValueError, match="128"):
        fused.sweep(fused.to_layout(s_rn), 1.0, gen)
    single = S.SortedSparseTEngine(te, accept_kernel="single")
    with pytest.raises(ValueError, match="128"):
        single.sweep(single.to_layout(s_rn), 1.0, gen)
    # an instance whose [NS, 128] float32 spins exceed the budget never
    # builds the single tables in auto mode (the JAX rule)
    monkeypatch.setattr(S.SortedSparseTEngine, "SINGLE_VMEM_SPIN_BYTES", 1024)
    assert not S.SortedSparseTEngine(te, accept_kernel="single")._single_fits(128)


def test_sparse_anneal_end_to_end():
    """anneal() takes an EllProblem: the [R, N] engine on the CPU, and the
    transposed engine when asked for; both improve on a random state."""
    _, te = _pair(n=200, dist="gaussian", with_h=False)
    e_rand = float(S.sparse_energy(te, torch.ones(1, te.n_padded))[0])
    for method, name in (("auto", "sparse_sorted"), ("sparse_t",
                                                     "sparse_sorted_t")):
        cfg = sa.SAConfig(n_sweeps=60, n_replicas=8, sweep_method=method,
                          record_interval=20, seed=1)
        res = sa.anneal(te, cfg)
        assert res.metadata["engine"] == name
        assert res.metadata["kernel_launches"] == (
            {} if name == "sparse_sorted"
            else {"sparse_sweep": 0, "sparse_thresholds": 0,
                  "sparse_accept": 0})
        assert res.best_spins.shape == (200,) and res.best_energy < e_rand
        s = torch.ones(1, te.n_padded)
        s[0, :200] = torch.as_tensor(res.best_spins)
        assert float(S.sparse_energy(te, s)[0]) == pytest.approx(
            res.best_energy, rel=1e-5)
