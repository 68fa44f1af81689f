"""The wide-PT path of the port on the CPU: the sparse kernels' four-word
Philox stream, the fused sweep's plain version (slot-ordered fields, then the
accept) against the JAX package's per-colour sweep, the one-seed equality of
K2's, K3's and K4's paths, PT through the fused engine, and the dispatch
rules that were set by measurement on the card.

Same numpy inputs to both packages. +-J couplings with h on a quarter grid
make every field exact, so spins, counts and dE compare bit for bit
(tolerance 0); on Gaussian couplings the order of a field's float32 sum
shows, and dE is held to 1e-5 relative. The CUDA kernels themselves run only
on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

from spinglass_tpu.kernels import sparse as JS  # noqa: E402
from spinglass_tpu_torch.anneal import engines, pt  # noqa: E402
from spinglass_tpu_torch.benchmarks import headline, planted  # noqa: E402
from spinglass_tpu_torch.core import topology as T  # noqa: E402
from spinglass_tpu_torch.kernels import metropolis_cuda as MC  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402
from spinglass_tpu_torch.kernels import sparse_cuda as SC  # noqa: E402

N = 300


def _pair(dist="binary", n=N, seed=3):
    """The same instance as a JAX and a port EllProblem; h on a quarter grid."""
    coo = T.sparse_random_graph_coo(n, avg_degree=5.0, dist=dist, seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return (JS.EllProblem.from_coo(n, *coo, h=h),
            S.EllProblem.from_coo(n, *coo, h=h, device="cpu"))


def _spins(r, n_pad, n, seed=0):
    s = np.where(np.random.default_rng(seed).random((r, n_pad)) < 0.5,
                 -1.0, 1.0).astype(np.float32)
    s[:, n:] = 1.0
    return s


# ---- the four-word stream ---------------------------------------------------

@pytest.mark.parametrize("r", [1, 4, 7, 130])
def test_philox_uniforms4_are_the_four_words(r):
    """Replica c of row i draws word c % 4 of Philox4x32-10 on counter
    (row0 + i, c // 4, 0, 0), mapped by ((x >> 9) << 1 | 1) * 2^-24."""
    seed, n, row0 = 2 ** 41 + 9, 5, 7
    u = MC.philox_uniforms4(seed, n, r, row0=row0)
    assert u.shape == (n, r) and u.dtype == torch.float32
    row = torch.arange(row0, row0 + n)[:, None]
    group = torch.arange(-(-r // 4))[None, :]
    words = MC.philox4x32((row, group, 0, 0), (seed & 0xFFFFFFFF, seed >> 32))
    for c in range(r):
        x = words[c % 4][:, c // 4]
        want = (((x >> 9) << 1) | 1).to(torch.float32) * 2.0 ** -24
        assert torch.equal(u[:, c], want), c
    # a slice of rows is the same stream
    assert torch.equal(MC.philox_uniforms4(seed, 2, r, row0=row0 + 3), u[3:5])
    # and it is not the dense kernels' stream, which keeps word 0 per replica
    if r >= 4:
        assert not torch.equal(u, MC.philox_uniforms(seed, n, r, row0=row0))


def test_philox_uniforms4_statistics():
    u = MC.philox_uniforms4(12345, 512, 256).double()
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 2e-3
    assert abs(float(u.var()) - 1.0 / 12.0) < 1e-3
    # the four words of a call are not correlated with each other
    quads = u.reshape(512, 64, 4)
    for a in range(4):
        for b in range(a + 1, 4):
            rho = np.corrcoef(quads[:, :, a].reshape(-1).numpy(),
                              quads[:, :, b].reshape(-1).numpy())[0, 1]
            assert abs(rho) < 0.02, (a, b, rho)
    assert not torch.equal(u, MC.philox_uniforms4(12346, 512, 256).double())


@pytest.mark.parametrize("r", [3, 128, 130])
def test_thresholds_reference_draws_the_four_word_stream(r):
    _, te = _pair()
    eng = S.SortedSparseTEngine(te, accept_kernel="none", threshold_rng="kernel")
    beta = torch.linspace(0.3, 2.0, r)
    th = SC.thresholds_reference(eng.mask_col, beta, 77, r, "metropolis")
    u = MC.philox_uniforms4(77, eng.n_sorted, r)
    want = torch.log(u) * (-0.5 / beta)[None, :]
    real = torch.as_tensor(eng.perm >= 0)
    assert torch.equal(th[real], want[real])
    assert torch.all(torch.isneginf(th[~real]))
    # a colour's slice is the same draw
    off, mc, _ = eng.groups[1]
    assert torch.equal(
        SC.thresholds_reference(eng.mask_col[off:off + mc], beta, 77, r,
                                "metropolis", row0=off), th[off:off + mc])


# ---- the fused sweep's plain version against the JAX per-colour sweep -------

@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("dist", ["binary", "gaussian"])
def test_fused_sweep_cpu_path_matches_jax_sorted_t_sweep(dist, rule):
    """make_sorted_t_sweep_fused on the CPU (slot-ordered fields, then
    accept_colour) against the JAX package's make_sorted_t_sweep (its XLA
    reference) fed the same thresholds, three sweeps: +-J exact in spins,
    counts and dE; Gaussian couplings within 1e-5 relative on dE and almost
    all spins equal (a field's last bit may decide a borderline flip)."""
    je, te = _pair(dist)
    r = 128
    eng = S.SortedSparseTEngine(te, rule=rule, accept_kernel="fused",
                                bucket_order="index")
    jeng = JS.SortedSparseTEngine(je, rule=rule, bucket_order="index")
    np.testing.assert_array_equal(eng.perm, jeng.perm)
    jsweep = jax.jit(JS.make_sorted_t_sweep(jeng.groups))
    s_rn = _spins(r, te.n_padded, N, seed=7)
    ts = eng.to_layout(torch.as_tensor(s_rn))
    assert ts.dtype == torch.int8
    js = jeng.to_layout(jnp.asarray(s_rn)).astype(jnp.int8)
    beta = torch.linspace(0.2, 2.5, r)
    for seed in (2 ** 40 + 5, 12345, 99):
        th = SC.thresholds_reference(eng.mask_col, beta, seed, r, rule)
        js, jde, jc = jsweep(js, jnp.asarray(th.numpy()))
        ts, tde, tc = eng._sweep_fused(ts, beta, seed)
        if dist == "binary":
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(tde.numpy(), np.asarray(jde))
        else:
            same = ts.numpy() == np.asarray(js)
            assert same.mean() >= 0.999
            ok = same.all(axis=0)          # replicas that made the same flips
            assert ok.mean() >= 0.9
            np.testing.assert_array_equal(tc.numpy()[ok], np.asarray(jc)[ok])
            np.testing.assert_allclose(tde.numpy()[ok], np.asarray(jde)[ok],
                                       rtol=1e-5, atol=1e-5)
            # keep the states together. A copy: the port's sweep writes ts
            # in place while the JAX sweep, dispatched before it, may still
            # be reading a buffer that aliases ts
            js = jnp.asarray(ts.numpy().copy())
    assert int(tc.sum()) > 0
    assert eng.launches["sparse_accept"] == 0


@pytest.mark.parametrize("dist", ["binary", "gaussian"])
def test_ordered_fields_match_colour_fields(dist):
    _, te = _pair(dist)
    eng = S.SortedSparseTEngine(te, accept_kernel="fused")
    s = eng.to_layout(torch.as_tensor(_spins(16, te.n_padded, N, seed=2)))
    for off, mc, bs in eng.groups:
        a = SC.ordered_fields(eng.kernels.tables, off, off + mc, s)
        b = S._colour_fields(s, bs)
        assert a.shape == (mc, 16) and a.dtype == torch.float32
        if dist == "binary":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_accept_gather_is_fields_then_accept_and_needs_tables():
    _, te = _pair()
    eng = S.SortedSparseTEngine(te, accept_kernel="fused", rule="glauber")
    k, r = eng.kernels, 8
    s = eng.to_layout(torch.as_tensor(_spins(r, te.n_padded, N, seed=3)))
    beta = torch.linspace(0.5, 1.5, r)
    off, mc, bs = eng.groups[2]
    out = [(torch.zeros(r), torch.zeros(r, dtype=torch.int32)) for _ in range(2)]
    s_a, s_b = s.clone(), s.clone()
    k.accept_gather(s_a, off, mc, beta, 5, *out[0])
    k.accept(S._colour_fields(s_b, bs), s_b, off, beta, 5, *out[1])
    assert torch.equal(s_a, s_b) and int(out[0][1].sum()) > 0
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert torch.equal(s_a[:off], s[:off]) and torch.equal(s_a[off + mc:],
                                                           s[off + mc:])
    bare = SC.SparseKernels(eng.mask_col, "metropolis")
    with pytest.raises(ValueError, match="tables"):
        bare.accept_gather(s, off, mc, beta, 5, *out[0])
    with pytest.raises(ValueError, match="tables"):
        bare.accept_sweep(s, beta, 5)
    assert k.accept_launches == 0 and bare.accept_launches == 0


# ---- one seed, three paths --------------------------------------------------

@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_one_seed_three_paths_through_the_engines(rule):
    """At R=128 the K2 engine (its twin), the K3 path and the K4 path (its
    plain version) draw one seed per sweep from equal generators and make
    the same decisions: spins, dE and counts bit for bit over three sweeps."""
    _, te = _pair()
    r = 128
    kinds = (dict(accept_kernel="single", threshold_rng="kernel"),
             dict(accept_kernel="none", threshold_rng="kernel"),
             dict(accept_kernel="fused"))
    engs = [S.SortedSparseTEngine(te, rule=rule, **kw) for kw in kinds]
    s_rn = torch.as_tensor(_spins(r, te.n_padded, N, seed=8))
    states = [e.to_layout(s_rn) for e in engs]
    assert [s.dtype for s in states] == [torch.float32, torch.int8, torch.int8]
    gens = [torch.Generator().manual_seed(21) for _ in engs]
    beta = torch.linspace(0.2, 3.0, r)
    for _ in range(3):
        outs = [e.sweep(s, beta, g) for e, s, g in zip(engs, states, gens)]
        (s2, de2, c2), (s3, de3, c3), (s4, de4, c4) = outs
        assert torch.equal(s2, s3.float()) and torch.equal(s3, s4)
        assert torch.equal(c2, c3) and torch.equal(c3, c4)
        assert torch.equal(de2, de3) and torch.equal(de3, de4)
        assert int(c4.sum()) > 0
    for e in engs:
        assert e.launches == {"sparse_sweep": 0, "sparse_thresholds": 0,
                              "sparse_accept": 0}


@pytest.mark.parametrize("spin_dtype", [torch.int8, torch.float32])
def test_one_seed_three_paths_at_an_odd_replica_count(spin_dtype):
    """R=130 (no multiple of 4 or 128) through the sweep functions directly:
    the fused engine refuses it, as in the JAX package, but the kernels'
    plain versions take any R."""
    _, te = _pair()
    r, seed = 130, 2 ** 63 + 11
    eng = S.SortedSparseTEngine(te, accept_kernel="fused", spin_dtype=spin_dtype)
    k = eng.kernels
    s0 = eng.to_layout(torch.as_tensor(_spins(r, te.n_padded, N, seed=9)))
    assert s0.dtype == spin_dtype
    beta = torch.linspace(0.2, 3.0, r)
    with pytest.raises(ValueError, match="128"):
        eng.sweep(s0.clone(), beta, torch.Generator().manual_seed(0))
    th = k.thresholds(beta, seed, r)                                   # K3
    assert th.shape == (eng.n_sorted, r)
    s3, de3, c3 = S.make_sorted_t_sweep(eng.groups)(s0.clone(), th)
    s2, de2, c2 = k.single_sweep(s0.clone(), beta, seed=seed)          # K2
    s4, de4, c4 = S.make_sorted_t_sweep_fused(k)(s0.clone(), beta, seed)  # K4
    so, deo, co = SC.single_sweep_ordered(k.tables, k.span_list, s0.clone(), th)
    for s, de, c in ((s2, de2, c2), (s4, de4, c4), (so, deo, co)):
        assert torch.equal(s, s3) and torch.equal(c, c3) and torch.equal(de, de3)
    assert int(c3.sum()) > 0 and s4.dtype == spin_dtype


# ---- PT through the fused engine --------------------------------------------

def test_pt_fused_engine_matches_threshold_path_two_chains_of_128():
    """Two PT super-steps, 2 chains x 128 replicas, through
    SortedSparseTEngine(accept_kernel="fused") and through the threshold
    path on K3's twin: every piece of the state bit for bit."""
    inst = planted.planted_gauge_coo(240, 5.0, seed=13, frustration=0.3,
                                     magnitude="ones")
    ell = S.EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols, inst.vals,
                                device="cpu")
    cfg = pt.PTConfig(n_replicas=128, n_chains=2, exchange_interval=3,
                      min_temp=0.2, max_temp=4.0, sweep_method="sparse_t")
    out = []
    for kw in (dict(accept_kernel="fused"),
               dict(accept_kernel="none", threshold_rng="kernel")):
        eng = S.SortedSparseTEngine(ell, **kw)
        step, _, eng = pt.make_pt_step(ell, cfg, engine=eng)
        state = pt.init_state(ell, cfg, torch.Generator().manual_seed(4), eng)
        for _ in range(2):
            state, stats = step(state)
        out.append((state, stats, eng.launches))
    (a, sa, la), (b, sb, lb) = out
    for name in ("spins", "slot", "energy", "best_energy", "best_spins",
                 "exch_attempts", "exch_accepts", "acc_rate"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(sa["slot_energy"], sb["slot_energy"])
    assert a.spins.shape[1] == 256 and a.spins.dtype == torch.int8
    assert int(a.exch_accepts.sum()) > 0
    assert la == lb == {"sparse_sweep": 0, "sparse_thresholds": 0,
                        "sparse_accept": 0}


# ---- the rules set by measurement -------------------------------------------

@pytest.mark.parametrize("mc,r,want", [
    (1460, 16, 16), (1460, 128, 16), (1460, 384, 16), (1460, 512, 32),
    (1460, 1024, 32), (1460, 1920, 32), (1460, 1921, 64), (1460, 4096, 64),
    (8, 4096, 64), (3_000_000, 128, 64), (9_000_000, 4096, 256),
])
def test_accept_rows_per_block_rule(mc, r, want):
    rows = SC.accept_rows_per_block(mc, r)
    assert rows == want and -(-mc // rows) <= 65535


def test_cpu_dispatch_is_unchanged_and_layout_dtype_follows_the_path():
    """On the CPU "auto" keeps the threshold path on int8 spins (the card's
    rule, K4 wherever K2 is not taken, applies to CUDA tensors only);
    to_layout gives float32 only at replica counts the single path takes."""
    _, te = _pair()
    auto = S.SortedSparseTEngine(te)
    assert not auto._use_single and not auto._use_fused
    assert auto.kernels.tables is None and auto._sweep_fused is None
    single = S.SortedSparseTEngine(te, accept_kernel="single")
    fused = S.SortedSparseTEngine(te, accept_kernel="fused")
    assert fused._use_fused and not fused._use_single
    assert fused.kernels.tables is not None
    s128 = torch.as_tensor(_spins(128, te.n_padded, N))
    s16 = s128[:16]
    assert single.to_layout(s128).dtype == torch.float32
    assert single.to_layout(s16).dtype == torch.int8
    assert single.spin_dtype == torch.float32
    for eng in (auto, fused):
        assert eng.to_layout(s128).dtype == torch.int8
    wide = S.SortedSparseTEngine(te, accept_kernel="single",
                                 spin_dtype=torch.float32)
    assert wide.to_layout(s16).dtype == torch.float32
    # the engine choice: the card's narrower threshold is a CUDA rule
    assert engines.SPARSE_T_MIN_REPLICAS_CUDA == 16
    assert engines.SPARSE_T_MIN_REPLICAS_CUDA < engines.SPARSE_T_MIN_REPLICAS
    for r_hint in (0, 16, 128, 4096):
        assert engines.make_engine(te, r_hint=r_hint).name == "sparse_sorted"


@pytest.mark.parametrize("path,kind,dtype", [
    ("threshold", "none", torch.int8), ("fused", "fused", torch.int8),
    ("single", "single", torch.float32)])
def test_pt_wide_engine_paths(path, kind, dtype):
    """The benchmark's three ways through PT at a wide R: each forces one
    path of the engine; "single" lifts the budget on its own instance only."""
    _, te = _pair()
    eng = headline.pt_wide_engine(te, path)
    assert eng._accept_kernel == kind
    budget = S.SortedSparseTEngine.SINGLE_VMEM_SPIN_BYTES
    assert budget == 80 * 1024 * 1024
    if path == "single":
        assert eng._takes_single(4096 * 128) and eng.SINGLE_VMEM_SPIN_BYTES > budget
    else:
        assert not eng._takes_single(128)
    s = eng.to_layout(torch.as_tensor(_spins(128, te.n_padded, N)))
    assert s.dtype == dtype
    s, de, cnt = eng.sweep(s, 0.8, torch.Generator().manual_seed(1))
    assert int(cnt.sum()) > 0 and de.shape == (128,)
    assert headline.PT_WIDE_PATHS == ("threshold", "fused", "single")
    cfg = headline.pt_wide_config()
    assert cfg.n_replicas * cfg.n_chains == 4096
