"""K1-K7 against their plain twins on a CUDA device (the smoke script's
parity phase at a small size). Needs a GPU and nvcc; skips elsewhere.

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest  # on the GPU
"""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu_torch.benchmarks.exact_instances import (  # noqa: E402
    bipartite_weights, grid_tsp)
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.kernels import metropolis_cuda as MC  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402
from spinglass_tpu_torch.kernels import sparse_cuda as SC  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("r,rule,block", list(itertools.product(
    (1, 37, 256), ("metropolis", "glauber"), (128, 256))))
def test_kernel_matches_twin_bitwise(cuda, r, rule, block):
    """+-J couplings, h on a quarter grid: exact fields, so spins, dE and
    counts equal the twin's bit for bit, in both random-number modes."""
    rng = np.random.default_rng(r)
    j = topology.fully_connected(500, dist="binary", seed=3)
    p = IsingProblem.from_dense(j, rng.integers(-8, 9, 500) / 4.0, device=cuda)
    fused = MC.FusedSweep(p, block_size=block, rule=rule)
    l0 = build.launch_snapshot()
    s = torch.as_tensor(np.where(rng.random((512, r)) < 0.5, -1.0, 1.0),
                        dtype=torch.float32, device=cuda)
    s[500:] = 1.0
    beta = torch.as_tensor(rng.uniform(0.1, 2.0, r), dtype=torch.float32,
                           device=cuda)
    for k in range(3):
        s_ref = s.clone()
        if k < 2:
            u = torch.rand(512, r, device=cuda)
            _, de, cnt = fused.sweep_with_uniforms(s, beta, u)
        else:
            _, de, cnt = fused(s, beta, 99 + k)
            u = MC.philox_uniforms(99 + k, 512, r, device=cuda)
        _, de_p, cnt_p = MC.fused_sweep_reference(p.j, p.h, p.active_mask,
                                                  s_ref, beta, u, rule, block)
        torch.cuda.synchronize()
        assert torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
        assert torch.equal(de, de_p)
    assert build.launches_since(l0, [MC.KERNEL_NAME]) == {MC.KERNEL_NAME: 3}


def _pm_j_ell(n, seed, device):
    coo = topology.sparse_random_graph_coo(n, avg_degree=6.0, dist="binary",
                                           seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return S.EllProblem.from_coo(n, *coo, h=h, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("r,rule", list(itertools.product(
    (128, 256), ("metropolis", "glauber"))))
def test_sparse_kernels_match_twins_bitwise(cuda, r, rule):
    """K3 equals its twin; K2 in both modes equals the per-colour sweep on
    the same thresholds, bit for bit in spins, dE and counts."""
    ell = _pm_j_ell(500, 3, cuda)
    eng = S.SortedSparseTEngine(ell, rule=rule, accept_kernel="single")
    l0 = build.launch_snapshot()
    gen = torch.Generator().manual_seed(r)
    s = eng.to_layout(torch.where(torch.rand(r, ell.n_padded, generator=gen)
                                  < 0.5, -1.0, 1.0).to(cuda))
    beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).to(cuda)
    for k in range(3):
        s_ref = s.clone()
        seed = 1000 + k
        th = SC.thresholds_reference(eng.mask_col, beta, seed, r, rule)
        if k == 0:
            assert torch.equal(eng.kernels.thresholds(beta, seed, r), th)
            _, de, cnt = eng.kernels.single_sweep(s, beta, th=th)
        else:
            _, de, cnt = eng.kernels.single_sweep(s, beta, seed=seed)
        _, de_p, cnt_p = SC.single_sweep_reference(eng.groups, s_ref, th)
        torch.cuda.synchronize()
        assert torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
        assert torch.equal(de, de_p)
    assert build.launches_since(l0, eng.kernel_names) == {
        "sparse_sweep": 3, "sparse_thresholds": 1, "sparse_accept": 0}


@pytest.mark.gpu
def test_sparse_engine_dispatch_on_cuda(cuda):
    """make_engine takes the transposed engine for r_hint >= 16 on the
    card; R=128 runs K2 on float32 spins, and a shape outside K2's budget
    (or no multiple of 128) runs K4 once per colour on int8 spins."""
    from spinglass_tpu_torch.anneal.engines import make_engine

    ell = _pm_j_ell(500, 4, cuda)
    l0 = build.launch_snapshot()
    eng = make_engine(ell, r_hint=128)
    assert eng.name == "sparse_sorted_t" and eng.spin_dtype == torch.float32
    assert make_engine(ell, r_hint=16).name == "sparse_sorted_t"
    assert make_engine(ell, r_hint=8).name == "sparse_sorted"
    gen = torch.Generator().manual_seed(0)
    s = eng.to_layout(torch.ones(128, ell.n_padded, device=cuda))
    assert s.dtype == torch.float32
    eng.sweep(s, torch.full((128,), 0.5, device=cuda), gen)
    eng.SINGLE_VMEM_SPIN_BYTES = eng.n_sorted * 128 * 4  # R=256 no longer fits
    for r in (256, 16):
        s = eng.to_layout(torch.ones(r, ell.n_padded, device=cuda))
        assert s.dtype == torch.int8
        eng.sweep(s, torch.full((r,), 0.5, device=cuda), gen)
    torch.cuda.synchronize()
    assert build.launches_since(l0, eng.kernel_names) == {
        "sparse_sweep": 1, "sparse_thresholds": 0,
        "sparse_accept": 2 * len(eng.groups)}
    none = S.SortedSparseTEngine(ell, accept_kernel="none")
    s = none.to_layout(torch.ones(256, ell.n_padded, device=cuda))
    l1 = build.launch_snapshot()
    none.sweep(s, torch.full((256,), 0.5, device=cuda), gen)
    assert build.launches_since(l1, none.kernel_names) == {
        "sparse_sweep": 0, "sparse_thresholds": 1, "sparse_accept": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("r,rule", list(itertools.product(
    (128, 4096, 130, 3), ("metropolis", "glauber"))))
def test_threshold_kernel_matches_twin_bitwise(cuda, r, rule):
    """K3 (four columns per thread, vector stores; scalar where R % 4 != 0)
    equals kernel_threshold(philox_uniforms4) masked, bit for bit."""
    ell = _pm_j_ell(500, 3, cuda)
    eng = S.SortedSparseTEngine(ell, rule=rule, accept_kernel="none")
    beta = torch.linspace(0.05, 3.0, r, device=cuda)
    seed = 2 ** 63 + r
    l0 = build.launch_snapshot()
    th = eng.kernels.thresholds(beta, seed, r)
    want = SC.thresholds_reference(eng.mask_col, beta, seed, r, rule)
    torch.cuda.synchronize()
    assert torch.equal(th, want)
    assert build.launches_since(l0, [SC.THRESHOLD_KERNEL]) == {
        SC.THRESHOLD_KERNEL: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("spin_dtype,rule,r", [
    (dtype, rule, r) for dtype in (torch.int8, torch.float32)
    for rule in ("metropolis", "glauber") for r in (128, 4096, 130)])
def test_accept_gather_matches_plain_version_bitwise(cuda, spin_dtype, rule, r):
    """K4 in gather mode, colour by colour and as a whole sweep, against the
    slot-ordered plain version: +-J spins, dE and counts bit for bit;
    Gaussian couplings spins and counts bit for bit, dE within 1e-5."""
    for dist in ("binary", "gaussian"):
        coo = topology.sparse_random_graph_coo(500, avg_degree=6.0, dist=dist,
                                               seed=6)
        h = np.random.default_rng(6).integers(-8, 9, 500) / 4.0
        ell = S.EllProblem.from_coo(500, *coo, h=h, device=cuda)
        eng = S.SortedSparseTEngine(ell, rule=rule, spin_dtype=spin_dtype,
                                    accept_kernel="fused")
        k = eng.kernels
        l0 = build.launch_snapshot()
        gen = torch.Generator().manual_seed(r)
        s = eng.to_layout(torch.where(torch.rand(r, ell.n_padded, generator=gen)
                                      < 0.5, -1.0, 1.0).to(cuda))
        assert s.dtype == spin_dtype
        beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).to(cuda)
        s_k, s_p, s_w = s.clone(), s.clone(), s.clone()
        out = [(torch.zeros(r, device=cuda),
                torch.zeros(r, dtype=torch.int32, device=cuda))
               for _ in range(2)]
        for off, mc, _ in eng.groups:
            k.accept_gather(s_k, off, mc, beta, 31, *out[0])
            SC.accept_gather_reference(k.tables, s_p, off, mc, eng.mask_col,
                                       beta, 31, rule, *out[1])
        _, de_w, cnt_w = k.accept_sweep(s_w, beta, 31)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p) and torch.equal(s_w, s_p)
        assert torch.equal(out[0][1], out[1][1]) and torch.equal(cnt_w, out[1][1])
        assert int(cnt_w.sum()) > 0
        if dist == "binary":
            assert torch.equal(out[0][0], out[1][0])
            assert torch.equal(de_w, out[1][0])
        else:
            tol = 1e-5 * float(out[1][0].abs().max())
            assert float((out[0][0] - out[1][0]).abs().max()) <= tol
            assert float((de_w - out[1][0]).abs().max()) <= tol
        assert build.launches_since(l0, [SC.ACCEPT_KERNEL]) == {
            SC.ACCEPT_KERNEL: 2 * len(eng.groups)}


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_one_seed_k2_k3_path_k4_path(cuda, rule):
    """Under one seed K2, the per-colour sweep on K3's thresholds and the
    fused sweep through K4 make the same decisions: spins, dE and counts bit
    for bit over three sweeps."""
    ell = _pm_j_ell(500, 8, cuda)
    single = S.SortedSparseTEngine(ell, rule=rule, accept_kernel="single")
    fused = S.SortedSparseTEngine(ell, rule=rule, accept_kernel="fused")
    assert np.array_equal(single.perm, fused.perm)
    r = 256
    gen = torch.Generator().manual_seed(5)
    s_rn = torch.where(torch.rand(r, ell.n_padded, generator=gen) < 0.5,
                       -1.0, 1.0).to(cuda)
    s2, s3, s4 = single.to_layout(s_rn), single.to_layout(s_rn), fused.to_layout(s_rn)
    beta = torch.linspace(0.05, 3.0, r, device=cuda)
    for seed in (2 ** 63 + 5, 6, 7):
        _, de2, c2 = single.kernels.single_sweep(s2, beta, seed=seed)
        th = single.kernels.thresholds(beta, seed, r)
        _, de3, c3 = S.make_sorted_t_sweep(single.groups)(s3, th)
        _, de4, c4 = fused._sweep_fused(s4, beta, seed)
        torch.cuda.synchronize()
        assert s4.dtype == torch.int8
        assert torch.equal(s2, s3) and torch.equal(s3, s4.float())
        assert torch.equal(c2, c3) and torch.equal(c3, c4)
        assert torch.equal(de2, de3) and torch.equal(de3, de4)


def _variant_against_twin_and_k1(cuda, n, flags, r, rule, block, sweeps=3):
    """``sweeps`` sweeps of the variant (host uniforms, then Philox) on a
    +-J problem of n spins, each against its twin and K1 on the same
    uniforms: spins, dE and counts bit for bit. Returns the variant."""
    rng = np.random.default_rng(r + n)
    j = topology.fully_connected(n, dist="binary", seed=3)
    p = IsingProblem.from_dense(j, rng.integers(-8, 9, n) / 4.0, device=cuda)
    n_pad = p.n_padded
    fused = MC.FusedSweep(p, block_size=block, rule=rule, **flags)
    flat = MC.FusedSweep(p, block_size=block, rule=rule)
    l0 = build.launch_snapshot()
    s = torch.as_tensor(np.where(rng.random((n_pad, r)) < 0.5, -1.0, 1.0),
                        dtype=torch.float32, device=cuda)
    s[n:] = 1.0
    beta = torch.as_tensor(rng.uniform(0.1, 2.0, r), dtype=torch.float32,
                           device=cuda)
    for k in range(sweeps):
        s_ref, s_k1 = s.clone(), s.clone()
        if k < sweeps - 1:
            u = torch.rand(n_pad, r, device=cuda)
            _, de, cnt = fused.sweep_with_uniforms(s, beta, u)
        else:
            _, de, cnt = fused(s, beta, 77 + k)
            u = MC.philox_uniforms(77 + k, n_pad, r, device=cuda)
        _, de_p, cnt_p = fused.reference(s_ref, beta, u)
        _, de_1, cnt_1 = flat.sweep_with_uniforms(s_k1, beta, u)
        torch.cuda.synchronize()
        assert torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
        assert torch.equal(de, de_p)
        assert torch.equal(s, s_k1) and torch.equal(cnt, cnt_1)
        assert torch.equal(de, de_1)
    assert build.launches_since(l0, [fused.kernel_name]) == {
        fused.kernel_name: sweeps}
    return fused


@pytest.mark.gpu
@pytest.mark.parametrize("flags,r,rule,block", [
    (flags, r, rule, block)
    for flags in (dict(pipelined=True), dict(interleave=2),
                  dict(interleave=4), dict(folded=True))
    for r, rule, block in ((1, "metropolis", 128), (16, "glauber", 256),
                           (72, "metropolis", 256), (73, "glauber", 128),
                           (1024, "metropolis", 128), (1100, "glauber", 256))])
def test_dense_variants_match_twins_and_k1_bitwise(cuda, flags, r, rule, block):
    """K5, K6 and K7 equal their own twins and K1 on +-J, in both
    random-number modes: spins, dE and counts bit for bit. R covers a part
    of K5's and K7's 72-column tile, one tile, a second, 15 tiles (one wave
    of clusters on the H100) and 16 (a second wave)."""
    fused = _variant_against_twin_and_k1(cuda, 500, flags, r, rule, block)
    assert fused.tile == MC.CLUSTER_TILE


@pytest.mark.gpu
@pytest.mark.parametrize("flags,block,beyond", [
    (flags, block, beyond)
    for flags in (dict(pipelined=True), dict(folded=True),
                  dict(interleave=2), dict(interleave=4))
    for block in (128, 256) for beyond in (False, True)])
def test_cluster_variants_at_their_envelope(cuda, flags, block, beyond):
    """K5, K6 and K7 at the largest n_pad their cluster kernels take, and
    one block beyond it, where the one-block float32 kernels run: bitwise
    equal to their twins and K1 (R = 73, two tiles)."""
    name = MC.FusedSweep(IsingProblem.from_dense(np.zeros((8, 8)),
                                                 device="cpu"),
                         **flags).kernel_name
    n = MC.cluster_envelope(name, block) + (block if beyond else 0)
    fused = _variant_against_twin_and_k1(cuda, n, flags, 73, "metropolis",
                                         block, sweeps=2)
    assert (fused.tile == MC.CLUSTER_TILE) == (not beyond)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [dict(pipelined=True), dict(folded=True)])
def test_cluster_variants_anneal_like_k1(cuda, flags):
    """The SK glass (N=4096, R=1024, Gaussian couplings: K5's repair and
    K7's delayed update sum in another order than K1): 500 sweeps of sa's
    schedule through the variant's engine keep the energy identity (1e-4
    relative per 50-sweep resync) and end within 0.005 of K1's best E/N
    through the same driver."""
    import dataclasses

    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.anneal.engines import CudaFusedEngine

    j = topology.fully_connected(4096, dist="gaussian", scale=1.0 / 64,
                                 seed=42)
    p = IsingProblem.from_dense(j, device=cuda)
    cfg = sa.SAConfig(n_sweeps=500, n_replicas=1024)
    best = []
    for kw in ({}, flags):
        engine = CudaFusedEngine(p, block_size=cfg.block_size, **kw)
        l0 = build.launch_snapshot()
        state = sa.init_state(p, cfg, engine)
        for _ in range(10):
            for _ in range(50):
                state = sa._one_sweep(p, cfg, engine, state)
            exact = engine.energy(state.spins)
            rel = ((state.energy - exact).abs() / exact.abs().clamp(min=1.0))
            assert float(rel.max()) <= 1e-4
            state = dataclasses.replace(state, energy=exact)
        best.append(float(state.best_energy.min()) / 4096)
        assert build.launches_since(l0, engine.kernel_names) == {
            engine.fused.kernel_name: 500}
    assert best[1] <= -0.72 and abs(best[1] - best[0]) <= 0.005, best


@pytest.mark.gpu
@pytest.mark.parametrize("spin_dtype,r", [(torch.int8, 128),
                                          (torch.float32, 256)])
def test_fused_accept_matches_twin_and_threshold_path(cuda, spin_dtype, r):
    """K4 on given fields (one colour) equals its twin; a whole K4-path
    sweep (gather mode) equals the per-colour sweep on K3's thresholds for
    the same seed, bit for bit."""
    ell = _pm_j_ell(500, 5, cuda)
    eng = S.SortedSparseTEngine(ell, accept_kernel="fused",
                                spin_dtype=spin_dtype)
    l0 = build.launch_snapshot()
    gen = torch.Generator().manual_seed(r)
    s = eng.to_layout(torch.where(torch.rand(r, ell.n_padded, generator=gen)
                                  < 0.5, -1.0, 1.0).to(cuda))
    beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).to(cuda)
    off, _, bs = eng.groups[0]
    f = S._colour_fields(s, bs)
    s_k, s_p = s.clone(), s.clone()
    acc = [(torch.zeros(r, device=cuda), torch.zeros(r, dtype=torch.int32,
                                                     device=cuda))
           for _ in range(2)]
    eng.kernels.accept(f, s_k, off, beta, 1234, *acc[0])
    SC.accept_reference(f, s_p, off, eng.mask_col, beta, 1234, eng.rule,
                        *acc[1])
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_p) and torch.equal(acc[0][1], acc[1][1])
    assert torch.equal(acc[0][0], acc[1][0])
    s_ref = s.clone()
    _, de, cnt = eng._sweep_fused(s, beta, 4321)
    th = SC.thresholds_reference(eng.mask_col, beta, 4321, r, eng.rule)
    _, de_p, cnt_p = S.make_sorted_t_sweep(eng.groups)(s_ref, th)
    torch.cuda.synchronize()
    assert torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
    assert torch.equal(de, de_p)
    assert build.launches_since(l0, [SC.ACCEPT_KERNEL]) == {
        SC.ACCEPT_KERNEL: 1 + len(eng.groups)}


def _three_plane_problem(n, seed, device):
    """Couplings +-(1 + 2^-9 + 2^-17) on a random graph of density 0.4: all
    three bf16 planes of J are non-zero (hi 1, mid 2^-9, lo 2^-17), and with
    n <= 200 (fewer than 126 couplings per spin) and h on a quarter grid
    every partial sum of a field is a multiple of 2^-17 below 128, so
    float32 sums are exact in any order."""
    rng = np.random.default_rng(seed)
    j = topology.random_graph(n, density=0.4, dist="binary", seed=seed)
    assert int((j != 0).sum(axis=1).max()) < 126
    j = j * (1.0 + 2.0 ** -9 + 2.0 ** -17)
    return IsingProblem.from_dense(j, rng.integers(-8, 9, n) / 4.0,
                                   device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("r,rule,block,planes", [
    (r, rule, block, planes)
    for r, rule, block in ((1, "metropolis", 128), (37, "glauber", 256),
                           (64, "metropolis", 256), (1000, "glauber", 128))
    for planes in (1, 3)])
def test_cluster_kernel_matches_twin_bitwise(cuda, r, rule, block, planes):
    """K1's cluster launch at replica counts that leave dead columns in a
    72-column tile, one tile and fourteen, with one and with three bf16
    planes of J: spins and counts equal the twin's bit for bit, in both
    random-number modes (dE too where its sum is exact); so does
    j_dtype="bfloat16" on +-J."""
    if planes == 3:
        p = _three_plane_problem(200, r, cuda)
    else:
        rng = np.random.default_rng(r)
        p = IsingProblem.from_dense(
            topology.fully_connected(500, dist="binary", seed=3),
            rng.integers(-8, 9, 500) / 4.0, device=cuda)
    n, n_pad = p.n_spins, p.n_padded
    fused = MC.FusedSweep(p, block_size=block, rule=rule)
    assert fused.planes == planes and fused.tile == MC.CLUSTER_TILE
    sweeps = [fused]
    if planes == 1:
        sweeps.append(MC.FusedSweep(p, block_size=block, rule=rule,
                                    j_dtype="bfloat16"))
    rng = np.random.default_rng(r + 1)
    beta = torch.as_tensor(rng.uniform(0.1, 2.0, r), dtype=torch.float32,
                           device=cuda)
    for sweep in sweeps:
        l0 = build.launch_snapshot()
        s = torch.as_tensor(np.where(rng.random((n_pad, r)) < 0.5, -1.0, 1.0),
                            dtype=torch.float32, device=cuda)
        s[n:] = 1.0
        for k in range(2):
            s_ref = s.clone()
            if k == 0:
                u = torch.rand(n_pad, r, device=cuda)
                _, de, cnt = sweep.sweep_with_uniforms(s, beta, u)
            else:
                _, de, cnt = sweep(s, beta, 2 ** 63 + k)
                u = MC.philox_uniforms(2 ** 63 + k, n_pad, r, device=cuda)
            _, de_p, cnt_p = MC.fused_sweep_reference(
                p.j, p.h, p.active_mask, s_ref, beta, u, rule, block)
            torch.cuda.synchronize()
            assert torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
            assert int(cnt.sum()) > 0
            if planes == 1:
                assert torch.equal(de, de_p)
            else:  # dE sums 2^-16 steps beyond 24 bits: its order shows
                assert float((de - de_p).abs().max()) <= 1e-3
        assert build.launches_since(l0, [sweep.kernel_name]) == {
            sweep.kernel_name: 2}


@pytest.mark.gpu
def test_one_block_kernel_and_cluster_occupancy(cuda):
    """Beyond the cluster kernel's shapes the wrapper takes the one-block
    float32 kernel (here asked for by its tile): bitwise equal to the twin;
    and the card reports how many clusters it holds."""
    p = _three_plane_problem(200, 7, cuda)
    fused = MC.FusedSweep(p, block_size=128)
    fused.tile = MC.BLOCK_TILE
    rng = np.random.default_rng(7)
    s = torch.as_tensor(np.where(rng.random((256, 37)) < 0.5, -1.0, 1.0),
                        dtype=torch.float32, device=cuda)
    s[200:] = 1.0
    s_ref = s.clone()
    beta = torch.full((37,), 0.7, device=cuda)
    _, de, cnt = fused(s, beta, 5)
    u = MC.philox_uniforms(5, 256, 37, device=cuda)
    _, de_p, cnt_p = MC.fused_sweep_reference(p.j, p.h, p.active_mask, s_ref,
                                              beta, u, "metropolis", 128)
    torch.cuda.synchronize()
    assert torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
    assert float((de - de_p).abs().max()) <= 1e-3  # the order of dE's sum
    occ = MC.cluster_occupancy(4096, 1024, 128)
    assert occ["clusters_launched"] == 15 and occ["max_active_clusters"] >= 1
    assert occ["smem_bytes_per_block"] == MC.cluster_smem_bytes(4096, 128)
    big = MC.FusedSweep(IsingProblem(
        j=torch.zeros(1, 8448, device=cuda), h=torch.zeros(8448, device=cuda),
        active_mask=torch.ones(8448, device=cuda), n_spins=8448),
        block_size=128)
    assert big.tile == MC.BLOCK_TILE


@pytest.mark.gpu
@pytest.mark.parametrize("n,tile", [(27500, 8), (30000, 4)])
def test_sparse_sweep_at_the_shared_memory_envelope(cuda, n, tile):
    """K2 with the int8 tile just inside the block's shared memory at 8
    columns, and just beyond it, where the rule halves the tile: both equal
    the twin bit for bit on +-J. Beyond one column's envelope the wrapper
    raises before it launches."""
    ell = _pm_j_ell(n, 11, cuda)
    eng = S.SortedSparseTEngine(ell, accept_kernel="single")
    k = eng.kernels
    l0 = build.launch_snapshot()
    r = 1024 + 16  # dead columns in the last block
    assert SC.default_tile(r, eng.n_sorted) == tile
    assert (eng.n_sorted * 8 <= SC.TILE_SMEM_BYTES) == (tile == 8)
    gen = torch.Generator().manual_seed(n)
    # K2 itself takes any R on float32 spins (the engine's layout is int8
    # where its own rule, R % 128 == 0, does not take K2)
    s = eng.to_layout(torch.where(torch.rand(r, ell.n_padded, generator=gen)
                                  < 0.5, -1.0, 1.0).to(cuda)).float()
    beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).to(cuda)
    for it in range(2):
        s_ref = s.clone()
        seed = 2 ** 63 + it
        th = SC.thresholds_reference(eng.mask_col, beta, seed, r, "metropolis")
        kw = dict(seed=seed) if it else dict(th=th)
        _, de, cnt = k.single_sweep(s, beta, **kw)
        _, de_p, cnt_p = SC.single_sweep_reference(eng.groups, s_ref, th)
        torch.cuda.synchronize()
        assert torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
        assert torch.equal(de, de_p) and int(cnt.sum()) > 0
    assert build.launches_since(l0, [SC.SWEEP_KERNEL]) == {
        SC.SWEEP_KERNEL: 2}
    big = SC.SparseKernels(torch.zeros(SC.TILE_SMEM_BYTES + 256, 1, device=cuda),
                           "metropolis", k.groups, k.tables)
    big.tables = dict(k.tables, idx=torch.zeros(SC.TILE_SMEM_BYTES + 256, 1))
    with pytest.raises(ValueError, match="shared memory"):
        big.single_sweep(torch.ones(SC.TILE_SMEM_BYTES + 256, 128, device=cuda),
                         beta[:128], seed=1)
    assert build.launches_since(l0, [SC.SWEEP_KERNEL]) == {
        SC.SWEEP_KERNEL: 2}   # the refused launch counted nothing


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["discrete", "continuous", "hybrid"])
@pytest.mark.parametrize("kind,n_envs", [("K1", 40), ("K2", 128), ("K4", 48)])
def test_env_step_through_kernels_matches_twins(cuda, kind, n_envs, mode):
    """Two env steps through make_engine's engine (K1 dense; K2 at a
    multiple of 128 envs and K4 at another count on a sparse problem)
    against the same steps through the twin under one generator seed, with
    sweep fractions below 1 for some envs: the kernels write in place, and
    the state, rewards, observations and done must be equal bit for bit."""
    from spinglass_tpu_torch.anneal.twins import (TwinFusedEngine,
                                                  TwinSparseTEngine)
    from spinglass_tpu_torch.rl import env as E

    if kind == "K1":
        rng = np.random.default_rng(5)
        problem = IsingProblem.from_dense(
            topology.fully_connected(300, dist="binary", seed=5),
            rng.integers(-8, 9, 300) / 4.0, device=cuda)
        key, per_sweep = MC.KERNEL_NAME, 1
    else:
        problem = _pm_j_ell(1500, 7, cuda)
        key = "sparse_sweep" if kind == "K2" else "sparse_accept"
    cfg = E.EnvConfig(n_envs=n_envs, sweeps_per_step=4, max_steps=20,
                      action_mode=mode, init_temp_range=(0.1, 20.0))
    engine = E.default_engine(problem, cfg)
    twin = (TwinFusedEngine(problem, block_size=128) if kind == "K1"
            else TwinSparseTEngine(problem))
    if kind == "K4":
        per_sweep = len(engine.groups)
        assert engine.state_dtype(n_envs) == torch.int8
    elif kind == "K2":
        per_sweep = 1
        assert engine.state_dtype(n_envs) == torch.float32
    g = torch.Generator().manual_seed(1)
    idx = torch.randint(0, 10, (n_envs,), generator=g).to(cuda)
    frac = torch.linspace(0.05, 1.1, n_envs).to(cuda)
    action = {"discrete": idx,
              "continuous": torch.stack([frac + 0.6, frac], dim=-1),
              "hybrid": {"temp_index": idx, "sweep_frac": frac}}[mode]
    out, launched = [], []
    for eng in (engine, twin):
        gen = torch.Generator().manual_seed(9)
        l0 = build.launch_snapshot()
        state, _ = E.reset(problem, cfg, gen, eng)
        for _ in range(2):
            state, obs, reward, done = E.step(problem, cfg, state, action,
                                              gen, eng)
        out.append((state, obs, reward, done))
        launched.append(build.launches_since(l0, [key])[key])
    torch.cuda.synchronize()
    (a, *a_rest), (b, *b_rest) = out
    for name in ("spins", "energy", "best_energy", "acc_rate", "temp",
                 "plateau"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert all(torch.equal(x, y) for x, y in zip(a_rest, b_rest))
    assert a.spins.dtype == torch.float32 and float(a.acc_rate.sum()) > 0
    assert launched == [2 * 4 * per_sweep, 0]   # the engine's, the twin's


@pytest.mark.gpu
def test_rl_entry_points_reach_the_kernel_by_default(cuda, monkeypatch):
    """Left to their defaults on a problem on the card, the evaluation entry
    points build ``default_engine``'s engine once and every sweep is a K1
    launch; the env's ``engine=None`` (the plain sweep) is refused there."""
    from spinglass_tpu_torch.anneal.engines import CudaFusedEngine
    from spinglass_tpu_torch.rl import env as E
    from spinglass_tpu_torch.rl import evaluate as V

    problem = IsingProblem.from_dense(
        topology.fully_connected(300, dist="gaussian", scale=300 ** -0.5,
                                 seed=5), device=cuda)
    cfg = E.EnvConfig(n_envs=40, sweeps_per_step=3, max_steps=5)
    built = []
    real = E.default_engine

    def counting(p, c):
        built.append(real(p, c))
        return built[-1]

    monkeypatch.setattr(E, "default_engine", counting)
    policies = {"geometric": V.make_geometric_policy(cfg),
                "random": V.make_random_policy()}
    l0 = build.launch_snapshot()
    report, _ = V.evaluate_controllers(problem, cfg, policies, n_seeds=2)
    assert len(built) == 1 and type(built[0]) is CudaFusedEngine
    assert build.launches_since(l0, [MC.KERNEL_NAME]) == {
        MC.KERNEL_NAME: 2 * 2 * 5 * 3}
    assert all(np.isfinite(v) for v in report["mean_best_energy"].values())
    l1 = build.launch_snapshot()
    best = V.rollout_best_energy(problem, cfg, policies["random"],
                                 torch.Generator().manual_seed(0))
    assert len(built) == 2 and build.launches_since(
        l1, [MC.KERNEL_NAME]) == {MC.KERNEL_NAME: 5 * 3}
    assert best.is_cuda and bool(torch.isfinite(best).all())
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="default_engine"):
        E.reset(problem, cfg, gen)
    state, _ = E.reset(problem, cfg, gen, built[0])
    with pytest.raises(ValueError, match="default_engine"):
        E.step(problem, cfg, state, torch.zeros(40, dtype=torch.long,
                                                device=cuda), gen)
    with pytest.raises(ValueError, match="default_engine"):
        E.auto_reset(problem, cfg, state, gen)



# -- the device-seed mode and the captured drivers ---------------------------

def _slot(seed, device):
    return torch.tensor([seed], dtype=torch.int64, device=device)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("flags,n", [
    ({}, 500), ({}, 9000), (dict(pipelined=True), 500),
    (dict(interleave=2), 500), (dict(interleave=4), 500),
    (dict(folded=True), 500)],
    ids=["K1", "K1 one-block", "K5", "K6x2", "K6x4", "K7"])
def test_dense_device_seed_equals_by_value(cuda, flags, n):
    """A seed slot in device memory gives the by-value seed's sweep, bit for
    bit (n = 9000: K1's one-block kernel)."""
    rng = np.random.default_rng(n)
    j = topology.fully_connected(n, dist="binary", seed=3)
    p = IsingProblem.from_dense(j, rng.integers(-8, 9, n) / 4.0, device=cuda)
    fused = MC.FusedSweep(p, block_size=128, **flags)
    s0 = torch.as_tensor(np.where(rng.random((p.n_padded, 80)) < 0.5, -1.0,
                                  1.0), dtype=torch.float32, device=cuda)
    beta = torch.full((80,), 0.7, device=cuda)
    a, b = s0.clone(), s0.clone()
    l0 = build.launch_snapshot()
    _, de_a, cnt_a = fused(a, beta, 2 ** 61 + 12345)
    _, de_b, cnt_b = fused(b, beta, _slot(2 ** 61 + 12345, cuda))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(de_a, de_b)
    assert torch.equal(cnt_a, cnt_b) and not torch.equal(a, s0)
    assert build.launches_since(l0, [fused.kernel_name]) == {
        fused.kernel_name: 2}


@pytest.mark.gpu
@pytest.mark.parametrize("r", [128, 130])
def test_sparse_device_seed_equals_by_value(cuda, r):
    """K2 (R = 128), K3 and K4 (whole sweep, and on given fields) take a
    seed slot and make the by-value seed's draws, bit for bit."""
    ell = _pm_j_ell(800, 4, cuda)
    eng = S.SortedSparseTEngine(ell, accept_kernel="fused")
    k = eng.kernels
    seed = 2 ** 40 + 77
    gen = torch.Generator().manual_seed(r)
    s0 = eng.to_layout(torch.where(torch.rand(r, ell.n_padded, generator=gen)
                                   < 0.5, -1.0, 1.0).to(cuda))
    beta = torch.full((r,), 0.9, device=cuda)
    assert torch.equal(k.thresholds(beta, seed, r),
                       k.thresholds(beta, _slot(seed, cuda), r))
    outs = []
    for sd in (seed, _slot(seed, cuda)):
        s = s0.clone()
        outs.append((s,) + tuple(k.accept_sweep(s, beta, sd)[1:]))
    f = S._colour_fields(s0, eng.groups[0][2])
    for sd in (seed, _slot(seed, cuda)):
        s = s0.clone()
        de = torch.zeros(r, device=cuda)
        cnt = torch.zeros(r, dtype=torch.int32, device=cuda)
        k.accept(f, s, eng.groups[0][0], beta, sd, de, cnt)
        outs.append((s, de, cnt))
    if r == 128:
        for sd in (seed, _slot(seed, cuda)):
            s = s0.float().contiguous()
            single = S.SortedSparseTEngine(ell, accept_kernel="single")
            outs.append((s,) + tuple(single.kernels.single_sweep(
                s, beta, seed=sd)[1:]))
    torch.cuda.synchronize()
    for x, y in zip(outs[::2], outs[1::2]):
        assert all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.mark.gpu
def test_captured_step_counts_its_graphs_launches(cuda):
    """A step of three K1 sweeps captured on the card: the warm-up's and
    the capture's launches are given back, the graph's launches per replay
    are kept, and each replay adds them to the ledger."""
    from spinglass_tpu_torch.anneal import graphs

    p = IsingProblem.from_dense(
        topology.fully_connected(300, dist="binary", seed=1), device=cuda)
    fused = MC.FusedSweep(p, block_size=128)
    gen = torch.Generator().manual_seed(0)
    beta = torch.full((16,), 0.5, device=cuda)

    def step(st):
        s = st["s"]
        for _ in range(3):
            s, _, _ = fused(s, beta, 7)
        return {"s": s}, None

    l0 = build.launch_snapshot()
    cap = graphs.CapturedStep(
        step, {"s": torch.ones(p.n_padded, 16, device=cuda)}, gen)
    assert build.launches_since(l0) == {}
    assert cap.launches == {MC.KERNEL_NAME: 3}
    for _ in range(2):
        cap.replay()
    torch.cuda.synchronize()
    assert build.launches_since(l0) == {MC.KERNEL_NAME: 6}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["K1", "K2", "K4"])
def test_captured_anneal_equals_eager(cuda, kind):
    """anneal (two graphs: chunks of 10 and a last of 5) against the eager
    loop of run_chunk under one seed: histories, best energies and best
    spins bit for bit; the launches counted through the replays. A repeat
    call replays the cached graphs and gives the same result, and the
    profiler counts as many of the kernel's launches in its replays as the
    counter adds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from spinglass_tpu_torch.anneal import graphs, sa
    from spinglass_tpu_torch.benchmarks.headline import (KERNEL_SYMBOLS,
                                                         eager_anneal)

    if kind == "K1":
        problem = IsingProblem.from_dense(
            topology.fully_connected(600, dist="binary", seed=2), device=cuda)
        r, key, per = 100, MC.KERNEL_NAME, 1
    else:
        problem = _pm_j_ell(2000, 6, cuda)
        r = 128 if kind == "K2" else 48
        key = "sparse_sweep" if kind == "K2" else "sparse_accept"
    cfg = sa.SAConfig(n_sweeps=35, n_replicas=r, record_interval=10,
                      enable_early_stop=False, seed=11)
    res = sa.anneal(problem, cfg)
    l0 = build.launch_snapshot()
    state, hist, engine = eager_anneal(problem, cfg)
    eager = build.launches_since(l0, [key])[key]
    if kind == "K4":
        per = len(engine.groups)
    elif kind == "K2":
        per = 1
    np.testing.assert_array_equal(res.energy_history, hist[:, 0])
    np.testing.assert_array_equal(res.mean_energy_history, hist[:, 1])
    np.testing.assert_array_equal(res.acceptance_history, hist[:, 3])
    np.testing.assert_array_equal(res.replica_best_energy,
                                  state.best_energy.cpu().numpy())
    assert res.metadata["kernel_launches"][key] == 35 * per
    assert res.metadata["kernel_launches"]["sa_track"] == 35
    assert eager == 35 * per
    hits = graphs.SA_CACHE.hits
    # the profiler misses the first events it sees: the second call counts
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            again = sa.anneal(problem, cfg)
            torch.cuda.synchronize()
            prof.step()
    assert graphs.SA_CACHE.hits == hits + 2
    np.testing.assert_array_equal(again.energy_history, res.energy_history)
    np.testing.assert_array_equal(again.best_spins, res.best_spins)
    assert again.metadata["kernel_launches"] == res.metadata["kernel_launches"]
    seen = {k: sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and any(sym in e.key for sym in KERNEL_SYMBOLS[k]))
            for k in (key, "sa_track")}
    assert seen == {key: 35 * per, "sa_track": 35}


@pytest.mark.gpu
def test_captured_pt_run_equals_eager_and_makes_no_sync(cuda):
    """pt.run (K4 at 16 replicas) against the eager super-step loop; and the
    replays of a captured super-step with their 4-byte reads run under
    set_sync_debug_mode('error')."""
    from spinglass_tpu_torch.anneal import graphs, pt

    ell = _pm_j_ell(2000, 8, cuda)
    cfg = pt.PTConfig(n_replicas=16, n_sweeps=40, exchange_interval=10,
                      seed=3)
    res = pt.run(ell, cfg)
    super_step, _, engine = pt.make_pt_step(ell, cfg)
    state = pt.init_state(ell, cfg, torch.Generator().manual_seed(3), engine)
    hist = []
    for _ in range(4):
        state, stats = super_step(state)
        hist.append(stats["best_energy"].clone())
    np.testing.assert_array_equal(res.energy_history,
                                  torch.stack(hist).cpu().numpy())
    np.testing.assert_array_equal(res.replica_best_energy,
                                  state.best_energy.cpu().numpy())
    assert res.metadata["kernel_launches"]["sparse_accept"] == \
        40 * len(engine.groups)
    def best_of(st):
        st, stats = super_step(st)
        return st, stats["best_energy"]

    step = pt.capture_super_step(best_of, pt.init_state(
        ell, cfg, torch.Generator().manual_seed(3), engine))
    read = graphs.HostRead()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [float(read([step.replay()])[0]) for _ in range(4)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got == [float(h) for h in hist]


@pytest.mark.gpu
def test_captured_ppo_update_equals_eager(cuda):
    """Two PPO updates through train (captured, capturable Adam) against the
    eager update_fn: parameters and metrics bit for bit, K1's launches
    counted through the replays."""
    from spinglass_tpu_torch.rl import env as E
    from spinglass_tpu_torch.rl import ppo

    problem = IsingProblem.from_dense(
        topology.fully_connected(256, dist="gaussian", scale=1 / 16, seed=4),
        device=cuda)
    env_cfg = E.EnvConfig(n_envs=64, sweeps_per_step=3, max_steps=6,
                          init_temp_range=(0.1, 10.0))
    cfg = ppo.PPOConfig(rollout_len=4, hidden_sizes=(32, 32), n_updates=2,
                        seed=5)
    out = ppo.train(problem, env_cfg, cfg)
    init_fn, update_fn, _ = ppo.make_ppo(problem, env_cfg, cfg)
    state = init_fn()
    assert state.opt.defaults["capturable"]
    hist = []
    for _ in range(2):
        state, metrics = update_fn(state)
        hist.append({k: float(metrics[k]) for k in ppo.METRIC_KEYS})
    assert out["history"] == hist
    for name, p in state.params.items():
        assert torch.equal(out["params"][name], p), name
    assert out["kernel_launches"][MC.KERNEL_NAME] == 2 * 4 * 3


# ---- the problem path: encoders -> make_engine -> K1 / K2 / K4 ------------

@pytest.mark.gpu
@pytest.mark.parametrize("n_cities,n_pad", [(10, 128), (15, 256), (19, 384)])
@pytest.mark.parametrize("r", [1, 32, 37])
def test_kernel_matches_twin_on_encoded_tsp(cuda, n_cities, n_pad, r):
    """K1 at the encoders' small padded sizes (one row block spread over a
    cluster at Np=128): host-uniform and Philox sweeps bit for bit."""
    _, p = grid_tsp(n_cities, device=cuda)
    assert p.n_padded == n_pad
    fused = MC.FusedSweep(p, block_size=128)
    rng = np.random.default_rng(r)
    s = torch.as_tensor(np.where(rng.random((n_pad, r)) < 0.5, -1.0, 1.0),
                        dtype=torch.float32, device=cuda)
    s[p.n_spins:] = 1.0
    beta = torch.as_tensor(rng.uniform(0.005, 0.2, r), dtype=torch.float32,
                           device=cuda)
    flips = 0
    l0 = build.launch_snapshot()
    for k in range(4):
        s_ref = s.clone()
        if k < 2:
            u = torch.rand(n_pad, r, device=cuda)
            _, de, cnt = fused.sweep_with_uniforms(s, beta, u)
        else:
            _, de, cnt = fused(s, beta, 31 + k)
            u = MC.philox_uniforms(31 + k, n_pad, r, device=cuda)
        _, de_p, cnt_p = MC.fused_sweep_reference(
            p.j, p.h, p.active_mask, s_ref, beta, u, "metropolis", 128)
        torch.cuda.synchronize()
        assert torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
        assert torch.equal(de, de_p)
        flips += int(cnt.sum())
    assert build.launches_since(l0, [MC.KERNEL_NAME]) == {
        MC.KERNEL_NAME: 4} and flips > 0


@pytest.mark.gpu
def test_encoded_problems_reach_k1_once_per_sweep(cuda):
    """TSP-64 (Np=4096) takes K1 through make_engine's "auto"; a bipartite
    MaxCut takes the coloured engine under "auto" (2 colours) and K1 under
    "blocked", and reaches the full cut."""
    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.anneal.engines import ColoredEngine
    from spinglass_tpu_torch.problems import MaxCutProblem, TSPProblem

    tsp = TSPProblem(device=cuda)
    tsp.generate_random_instance(n_cities=64, seed=7)
    sol = tsp.solve(sa.SAConfig(n_sweeps=100, n_replicas=64,
                                record_interval=50))
    meta = sol.metadata["anneal"]
    assert tsp.problem.n_padded == 4096
    assert meta["engine"] == "cuda_fused" and meta["device"] == "cuda"
    assert meta["kernel_launches"] == {MC.KERNEL_NAME: meta["n_sweeps"],
                                       "sa_track": meta["n_sweeps"]}
    assert tsp.validate_tour(sol.variables["tour"])
    w = bipartite_weights(300, 150 * 150 // 2, 1)
    mc = MaxCutProblem(weights=w, device=cuda)
    assert isinstance(sa.make_sweep_engine(mc.encode_to_ising(),
                                           sa.SAConfig()), ColoredEngine)
    sol = mc.solve(sa.SAConfig(n_sweeps=300, n_replicas=64,
                               sweep_method="blocked"))
    meta = sol.metadata["anneal"]
    assert meta["engine"] == "cuda_fused"
    assert meta["kernel_launches"] == {MC.KERNEL_NAME: meta["n_sweeps"],
                                       "sa_track": meta["n_sweeps"]}
    assert sol.variables["cut_value"] == 0.5 * w.sum()


@pytest.mark.gpu
@pytest.mark.parametrize("r,kernel", [(32, "sparse_accept"),
                                      (128, "sparse_sweep")])
def test_sparse_maxcut_reaches_k4_and_k2(cuda, r, kernel):
    """A sparse bipartite MaxCut of 3000 nodes (density below 0.05) takes
    the transposed sparse engine: K4 once per colour and sweep at R=32, K2
    once per sweep at R=128; best_energy is the energy of best_spins."""
    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.core.energy import energy
    from spinglass_tpu_torch.problems import MaxCutProblem

    w = bipartite_weights(3000, 6000, 2)
    mc = MaxCutProblem(weights=w, device=cuda)
    cfg = sa.SAConfig(n_sweeps=200, n_replicas=r, record_interval=50)
    engine = sa.make_sweep_engine(mc.encode_to_ising(), cfg)
    assert engine.name == "sparse_sorted_t"
    sol = mc.solve(cfg)
    meta = sol.metadata["anneal"]
    per = len(engine.groups) if kernel == "sparse_accept" else 1
    assert meta["kernel_launches"][kernel] == meta["n_sweeps"] * per
    assert meta["kernel_launches"]["sa_track"] == meta["n_sweeps"]
    assert sum(meta["kernel_launches"].values()) == \
        meta["n_sweeps"] * (per + 1)
    s = torch.ones(mc.problem.n_padded, device=cuda)
    s[:3000] = torch.as_tensor(np.where(sol.variables["partition"] > 0,
                                        1.0, -1.0))
    e = float(energy(mc.problem, s))
    assert abs(e - sol.energy) <= 1e-4 * abs(e)
    assert sol.variables["cut_value"] >= 0.99 * 0.5 * w.sum()


@pytest.mark.gpu
def test_benchmark_trials_equal_fresh_calls_on_the_card(cuda):
    """The seed is out of the captured drivers' cache key: five trials make
    one capture, and each equals a fresh call with its seed bit for bit."""
    import dataclasses

    from spinglass_tpu_torch.anneal import graphs, sa

    graphs.clear_caches()
    tsp, p = grid_tsp(8, seed=3, device=cuda)
    cfg = sa.SAConfig(n_sweeps=100, n_replicas=32, record_interval=25,
                      seed=4)
    tsp.benchmark_instance(cfg, n_trials=5)
    assert len(graphs.SA_CACHE) == 1 and graphs.SA_CACHE.misses >= 1
    trials = [sa.anneal(p, dataclasses.replace(cfg, seed=4 + t))
              for t in range(5)]
    assert len(graphs.SA_CACHE) == 1
    for t, res in enumerate(trials):
        graphs.clear_caches()
        fresh = sa.anneal(p, dataclasses.replace(cfg, seed=4 + t))
        np.testing.assert_array_equal(res.best_spins, fresh.best_spins)
        np.testing.assert_array_equal(res.energy_history,
                                      fresh.energy_history)
        np.testing.assert_array_equal(res.replica_best_energy,
                                      fresh.replica_best_energy)
        assert res.metadata["kernel_launches"] == \
            fresh.metadata["kernel_launches"] == {MC.KERNEL_NAME: 100,
                                                  "sa_track": 100}


def _sw_bond_sets(ell, r, cuda, case):
    """(idx, bond, init) of one SW sweep's labelling on ``ell`` at ``r``
    replicas (C2 in Philox mode on random spins), or an adversarial bond set
    at the same shape."""
    from spinglass_tpu_torch.core.cluster import SwendsenWang
    from spinglass_tpu_torch.kernels import cluster_cuda as CC

    sw = SwendsenWang(ell)
    gen = torch.Generator().manual_seed(r)
    s = torch.where(torch.rand(r, ell.n_padded, generator=gen) < 0.5, -1.0,
                    1.0).to(cuda)
    masks, init = sw.bonds(s, torch.linspace(0.2, 1.5, r, device=cuda),
                           seed=r)
    idx, bond = sw._idx, CC.unpack_masks(masks, sw._idx.shape[1])
    if case == "all":
        bond = ell.val[None].expand_as(bond) != 0
    elif case == "none":
        bond = torch.zeros_like(bond)
    elif case == "path":   # one long path through shuffled indices
        n = ell.n_spins
        order = torch.randperm(n, generator=gen)
        idx = torch.arange(ell.n_padded, dtype=torch.int32)[:, None].repeat(
            1, idx.shape[1])
        bond = torch.zeros(bond.shape, dtype=torch.bool)
        for a, b in zip(order[:-1].tolist(), order[1:].tolist()):
            idx[a, 0], bond[:, a, 0] = b, True
            idx[b, 1], bond[:, b, 1] = a, True
        idx, bond = idx.to(cuda), bond.to(cuda)
        init = torch.where(ell.active_mask[None] > 0,
                           torch.arange(ell.n_padded, dtype=torch.int32,
                                        device=cuda)[None],
                           ell.n_padded).to(torch.int32).expand(r, -1)
    return idx.contiguous(), bond.contiguous(), init.contiguous()


def _c1_labels(c1, idx, bond, init):
    """C1's labels and rounds of bool bonds [R, Np, K], through its one
    entry on the card (labels and flip, here of all-up spins)."""
    from spinglass_tpu_torch.kernels import cluster_cuda as CC

    spins = torch.ones(init.shape, device=init.device)
    _, _, labels, rounds = c1.flip(idx, CC.pack_bonds(bond), init, spins,
                                   seed=0)
    return labels, rounds


@pytest.mark.gpu
@pytest.mark.parametrize("r,case", [(16, "sweep"), (128, "sweep"),
                                    (16, "all"), (16, "none"), (2, "path")])
def test_sw_labels_kernel_matches_plain_labels(cuda, r, case):
    """C1 against the JAX loop in PyTorch (on CPU copies of the same
    inputs): labels bit for bit, its rounds within the cap."""
    from spinglass_tpu_torch.kernels import cluster_cuda as CC

    ell = _pm_j_ell(3000, 5, cuda)
    idx, bond, init = _sw_bond_sets(ell, r, cuda, case)
    c1 = CC.ClusterLabels()
    l0 = build.launch_snapshot()
    labels, rounds = _c1_labels(c1, idx, bond, init)
    torch.cuda.synchronize()
    want, plain_rounds = CC.labels_reference(idx.cpu(), bond.cpu(), init.cpu())
    assert torch.equal(labels.cpu(), want)
    assert build.launches_since(l0, [CC.KERNEL_NAME]) == {CC.KERNEL_NAME: 1}
    assert (rounds.cpu() >= 1).all() and (rounds.cpu() <= ell.n_padded).all()
    assert int(rounds.max()) <= plain_rounds


def _sw_inputs(problem, r, cuda, seed):
    """(SwendsenWang, spins [R, Np], beta [R]) on the card."""
    from spinglass_tpu_torch.core.cluster import SwendsenWang

    sw = SwendsenWang(problem)
    gen = torch.Generator().manual_seed(seed)
    s = torch.where(torch.rand(r, sw.ell.n_padded, generator=gen) < 0.5,
                    -1.0, 1.0)
    s = torch.where(sw.ell.active_mask.cpu()[None] > 0, s, 1.0).to(cuda)
    return sw, s.contiguous(), torch.linspace(0.2, 1.6, r, device=cuda)


def _sw_kernels_vs_plain(sw, s, beta, seed, blocks=None):
    """C2 and C1 in both draw modes against their plain versions on the
    same inputs on the card, bit for bit (masks, start labels, new spins,
    labels, cluster counts); returns C1's plan."""
    from spinglass_tpu_torch.kernels import cluster_cuda as CC

    r, n = s.shape
    k = sw._idx.shape[1]
    b = sw.bonds
    c1 = CC.ClusterLabels(blocks)
    l0 = build.launch_snapshot()
    draws = MC.sw_philox_draws(seed, r, n, k, device=s.device)
    for mode in ({"seed": seed}, {"u_dir": draws[0], "u_ghost": draws[1]}):
        masks, init = b(s, beta, **mode)
        want_m, want_i = CC.bonds_reference(b.idx, b.val, b.h, b.active,
                                            b.rev_i, b.rev_k, s, beta, **mode)
        torch.cuda.synchronize()
        assert torch.equal(masks, want_m) and torch.equal(init, want_i)
        flip = {"seed": seed} if "seed" in mode else {"coins": draws[2]}
        new, n_cl, labels, rounds = c1.flip(sw._idx, masks, init, s, **flip)
        torch.cuda.synchronize()
        want_l, _ = CC.labels_reference(sw._idx, CC.unpack_masks(masks, k),
                                        init)
        want_s, want_n = CC.flip_reference(s, want_l, init, **flip)
        assert torch.equal(labels, want_l) and torch.equal(new, want_s)
        assert torch.equal(n_cl, want_n) and (rounds == 1).all()
    assert build.launches_since(l0, [CC.BONDS_KERNEL, CC.KERNEL_NAME]) == {
        CC.BONDS_KERNEL: 2, CC.KERNEL_NAME: 2}
    return CC.labels_plan(n, r, torch.cuda.get_device_properties(
        s.device).multi_processor_count, blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("r,plan", [(128, (0, 1, 0)), (16, (1, 8, 9)),
                                    (5, (1, 8, 9))])
def test_sw_kernels_match_plain_versions(cuda, r, plan):
    """C2 == its plain version and C1 == labels_reference + flip_reference,
    bit for bit, Philox and given modes, at 128 replicas (one block each)
    and 16 and 5 (a cluster of 8 blocks per replica)."""
    ell = _pm_j_ell(3000, 6, cuda)
    sw, s, beta = _sw_inputs(ell, r, cuda, r)
    assert _sw_kernels_vs_plain(sw, s, beta, 1000 + r) == plan


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [1, 2, 4, 8, 0])
def test_sw_labels_every_table_placement(cuda, blocks):
    """C1 with its parent table forced into one block, clusters of 2, 4 and
    8 blocks, and device memory: the same labels and flips as the plain
    versions on the sweep's bonds and on the adversarial sets."""
    from spinglass_tpu_torch.kernels import cluster_cuda as CC

    ell = _pm_j_ell(3000, 7, cuda)
    sw, s, beta = _sw_inputs(ell, 12, cuda, 3)
    _sw_kernels_vs_plain(sw, s, beta, 77, blocks)
    for r, case in ((4, "all"), (4, "none"), (2, "path")):
        idx, bond, init = _sw_bond_sets(ell, r, cuda, case)
        labels, _ = _c1_labels(CC.ClusterLabels(blocks), idx, bond, init)
        want, _ = CC.labels_reference(idx, bond, init)
        torch.cuda.synchronize()
        assert torch.equal(labels, want), case


@pytest.mark.gpu
def test_sw_kernels_beyond_one_blocks_shared_memory(cuda):
    """Np beyond one block's table (58000 nodes): C1 takes a cluster of 2
    blocks at 128 replicas, device memory when asked; both equal the plain
    versions, as C2 does."""
    from spinglass_tpu_torch.kernels import cluster_cuda as CC

    ell = _pm_j_ell(60000, 8, cuda)
    sw, s, beta = _sw_inputs(ell, 128, cuda, 5)
    assert _sw_kernels_vs_plain(sw, s, beta, 5) == (1, 2, 15)
    sw, s, beta = _sw_inputs(ell, 8, cuda, 6)
    assert _sw_kernels_vs_plain(sw, s, beta, 6, blocks=0) == (2, 1, 0)
    assert CC.labels_plan(300000, 4) == (2, 1, 0)


@pytest.mark.gpu
def test_sw_kernels_beyond_the_staged_signs(cuda):
    """210000 sites, beyond the 200k whose sign bytes C2 stages in shared
    memory: C2 gathers the neighbours' spins from device memory, C1 takes a
    cluster of 8 blocks; both equal their plain versions."""
    ell = _pm_j_ell(210000, 10, cuda)
    sw, s, beta = _sw_inputs(ell, 4, cuda, 10)
    assert _sw_kernels_vs_plain(sw, s, beta, 10) == (1, 8, 15)


@pytest.mark.gpu
def test_sw_kernels_with_several_mask_words(cuda):
    """A dense 100-spin problem in ELL form (K = 99, four mask words): C2
    and C1 equal their plain versions, and one sweep through SwendsenWang
    keeps the energy identity."""
    from spinglass_tpu_torch.kernels.sparse import sparse_energy

    rng = np.random.default_rng(9)
    j = topology.fully_connected(100, dist="binary", seed=9)
    p = IsingProblem.from_dense(j, rng.integers(-4, 5, 100) / 4.0,
                                device=cuda)
    sw, s, beta = _sw_inputs(p, 24, cuda, 9)
    assert sw._idx.shape[1] == 99
    _sw_kernels_vs_plain(sw, s, beta, 9)
    new, de, n_cl = sw.sweep(s, beta, torch.Generator().manual_seed(2))
    torch.testing.assert_close(sparse_energy(sw.ell, s) + de,
                               sparse_energy(sw.ell, new), rtol=0, atol=1e-3)
    assert ((n_cl >= 0) & (n_cl <= 100)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["K1", "K4", "K2"])
def test_resumed_run_on_the_card_equals_uninterrupted(cuda, kind, tmp_path):
    """SA through K1 and PT through K4 (16 replicas) and K2 (128), each
    checkpointed, cut back to its first checkpoint and resumed: every
    result array equals the uninterrupted run's bit for bit, and the
    kernel's launches of the two calls add up to the uninterrupted ones."""
    import os

    from spinglass_tpu_torch.anneal import pt, sa

    d = str(tmp_path / "ck")
    if kind == "K1":
        p = IsingProblem.from_dense(
            topology.fully_connected(600, dist="binary", seed=2), device=cuda)
        cfg = sa.SAConfig(n_sweeps=95, n_replicas=64, record_interval=10,
                          enable_early_stop=False, seed=3)
        run = lambda **kw: sa.anneal(p, cfg, **kw)  # noqa: E731
        key, every = MC.KERNEL_NAME, 2
    else:
        p = _pm_j_ell(2000, 8, cuda)
        cfg = pt.PTConfig(n_replicas=16 if kind == "K4" else 128,
                          n_sweeps=200, exchange_interval=10, seed=3)
        run = lambda **kw: pt.run(p, cfg, **kw)  # noqa: E731
        key = "sparse_accept" if kind == "K4" else "sparse_sweep"
        every = 4
    ref = run()
    full = run(checkpoint_dir=d, checkpoint_every=every)
    steps = sorted(int(f[5:-3]) for f in os.listdir(d) if f.startswith("ckpt_"))
    for s in steps[1:]:
        os.remove(os.path.join(d, f"ckpt_{s}.pt"))
    res = run(checkpoint_dir=d, checkpoint_every=every, resume=True)
    for r in (full, res):
        for name in ("best_spins", "replica_best_energy", "energy_history",
                     "mean_energy_history", "acceptance_history"):
            np.testing.assert_array_equal(getattr(r, name), getattr(ref, name))
    assert full.metadata["kernel_launches"] == ref.metadata["kernel_launches"]
    saved = torch.load(os.path.join(d, f"ckpt_{steps[0]}.pt"),
                       weights_only=True)
    done = (int(saved["/sweeps_done"]) if kind == "K1"
            else int(saved["/done_super"]) * cfg.exchange_interval)
    assert 0 < done < ref.n_sweeps
    per_sweep = ref.metadata["kernel_launches"][key] // ref.n_sweeps
    assert res.metadata["kernel_launches"][key] == \
        (ref.n_sweeps - done) * per_sweep


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [16, 128])
def test_captured_cluster_move_super_step_equals_eager(cuda, replicas):
    """pt.run with cluster_moves=1 (K4 or K2, and C1 once per super-step)
    against the eager super-step loop under one seed, bit for bit; the
    replays make no host sync."""
    from spinglass_tpu_torch.anneal import graphs, pt

    ell = _pm_j_ell(2000, 8, cuda)
    cfg = pt.PTConfig(n_replicas=replicas, n_sweeps=60, exchange_interval=10,
                      cluster_moves=1, seed=5)
    res = pt.run(ell, cfg)
    assert res.metadata["kernel_launches"]["sw_labels"] == 6
    assert res.metadata["kernel_launches"]["sw_bonds"] == 6
    super_step, _, engine = pt.make_pt_step(ell, cfg)
    state = pt.init_state(ell, cfg, torch.Generator().manual_seed(5), engine)
    hist = []
    for _ in range(6):
        state, stats = super_step(state)
        hist.append(stats["best_energy"].clone())
    np.testing.assert_array_equal(res.energy_history,
                                  torch.stack(hist).cpu().numpy())
    np.testing.assert_array_equal(res.replica_best_energy,
                                  state.best_energy.cpu().numpy())
    step = graphs.PT_CACHE.get(ell, ("run", graphs.config_key(cfg)))[2]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            step.replay(torch.Generator().manual_seed(1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [16, 128])
def test_resumed_cluster_move_run_equals_uninterrupted(cuda, replicas,
                                                       tmp_path):
    """pt.run with cluster_moves=1 (C2 and C1 once per super-step),
    checkpointed, cut back to its first checkpoint and resumed: every result
    array equals the uninterrupted run's bit for bit, and the SW launches of
    the resumed call are those of the super-steps left."""
    import os

    from spinglass_tpu_torch.anneal import pt

    ell = _pm_j_ell(2000, 8, cuda)
    cfg = pt.PTConfig(n_replicas=replicas, n_sweeps=120, exchange_interval=10,
                      cluster_moves=1, seed=7)
    d = str(tmp_path / "ck")
    ref = pt.run(ell, cfg)
    full = pt.run(ell, cfg, checkpoint_dir=d, checkpoint_every=4)
    steps = sorted(int(f[5:-3]) for f in os.listdir(d) if f.startswith("ckpt_"))
    for st in steps[1:]:
        os.remove(os.path.join(d, f"ckpt_{st}.pt"))
    res = pt.run(ell, cfg, checkpoint_dir=d, checkpoint_every=4, resume=True)
    for r in (full, res):
        for name in ("best_spins", "replica_best_energy", "energy_history",
                     "mean_energy_history", "acceptance_history"):
            np.testing.assert_array_equal(getattr(r, name), getattr(ref, name))
    kl = ref.metadata["kernel_launches"]
    assert kl["sw_bonds"] == kl["sw_labels"] == 12
    assert full.metadata["kernel_launches"] == kl
    assert res.metadata["kernel_launches"]["sw_labels"] == 12 - steps[0]
    assert res.metadata["kernel_launches"]["sw_bonds"] == 12 - steps[0]


# ---- the RL training path: the hybrid DQN, the pipeline, the gym adapter --

def _dqn_diff(a, b) -> list:
    """The fields of two DQN states (Adam's moments and steps too) that are
    not equal bit for bit."""
    import dataclasses

    from spinglass_tpu_torch.anneal.graphs import leaves

    bad = [f.name for f in dataclasses.fields(a) if f.name != "opt"
           and not all(torch.equal(x, y) for x, y in zip(
               leaves(getattr(a, f.name)), leaves(getattr(b, f.name))))]
    for p, q in zip(a.params.values(), b.params.values()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            if not torch.equal(a.opt.state[p][key], b.opt.state[q][key]):
                bad.append(f"adam {key}")
    return bad


def _dqn_problem(kind, cuda):
    if kind == "K1":
        rng = np.random.default_rng(5)
        return IsingProblem.from_dense(
            topology.fully_connected(300, dist="binary", seed=5),
            rng.integers(-8, 9, 300) / 4.0, device=cuda)
    return _pm_j_ell(1500, 7, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n_envs", [("K1", 40), ("K2", 128), ("K4", 48)])
@pytest.mark.parametrize("per", [False, True])
def test_dqn_steps_through_kernels_equal_twins(cuda, kind, n_envs, per):
    """Three act_and_learn steps through default_engine's engine against the
    same steps through the kernels' twins under one seed: the whole DQN
    state (env, buffer, priorities, parameters, target network, Adam,
    counters) bit for bit, 10 launches of the kernel per env step (K4: per
    colour)."""
    from spinglass_tpu_torch.anneal.twins import (TwinFusedEngine,
                                                  TwinSparseTEngine)
    from spinglass_tpu_torch.rl import dqn
    from spinglass_tpu_torch.rl import env as E

    problem = _dqn_problem(kind, cuda)
    env_cfg = E.EnvConfig(n_envs=n_envs, sweeps_per_step=10, max_steps=2,
                          init_temp_range=(0.1, 20.0))
    cfg = dqn.DQNConfig(hidden_sizes=(32, 32), buffer_size=256,
                        batch_size=64, prioritized_replay=per,
                        epsilon_decay_steps=4)
    engine = E.default_engine(problem, env_cfg)
    twin = (TwinFusedEngine(problem, block_size=128) if kind == "K1"
            else TwinSparseTEngine(problem))
    key = {"K1": MC.KERNEL_NAME, "K2": "sparse_sweep",
           "K4": "sparse_accept"}[kind]
    states, launched = [], []
    for eng in (engine, twin):
        l0 = build.launch_snapshot()
        init_fn, step_fn, _ = dqn.make_dqn(problem, env_cfg, cfg, engine=eng)
        st = init_fn(torch.Generator().manual_seed(4))
        for _ in range(3):
            st, _ = step_fn(st)
        states.append(st)
        launched.append(build.launches_since(l0, [key])[key])
    torch.cuda.synchronize()
    assert _dqn_diff(*states) == []
    per_sweep = len(engine.groups) if kind == "K4" else 1
    assert launched == [3 * 10 * per_sweep, 0]   # the engine's, the twin's


@pytest.mark.gpu
@pytest.mark.parametrize("per", [False, True])
def test_captured_dqn_steps_equal_eager_on_the_card(cuda, per):
    """CapturedSteps (k=4, 8 steps, capturable Adam) against the eager loop
    under one seed: metrics and the whole state bit for bit; the replays and
    their reads make no host sync; K1 10 times per env step."""
    from spinglass_tpu_torch.rl import dqn
    from spinglass_tpu_torch.rl import env as E

    problem = _dqn_problem("K1", cuda)
    env_cfg = E.EnvConfig(n_envs=40, sweeps_per_step=10, max_steps=3,
                          init_temp_range=(0.1, 20.0))
    cfg = dqn.DQNConfig(hidden_sizes=(32, 32), buffer_size=256,
                        batch_size=64, prioritized_replay=per)
    init_fn, step_fn, _ = dqn.make_dqn(problem, env_cfg, cfg)
    l0 = build.launch_snapshot()
    cap = dqn.CapturedSteps(step_fn, init_fn(torch.Generator().manual_seed(6)),
                            4)
    assert cap.state.opt.defaults["capturable"]
    rows = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            for _ in range(4):
                cap.replay()
            rows += cap.read(4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert build.launches_since(l0, [MC.KERNEL_NAME]) == {
        MC.KERNEL_NAME: 8 * 10}
    init_e, step_e, _ = dqn.make_dqn(problem, env_cfg, cfg)
    st = init_e(torch.Generator().manual_seed(6))
    want = []
    for _ in range(8):
        st, m = step_e(st)
        want.append({k: float(m[k]) for k in dqn.METRIC_KEYS})
    assert rows == want
    assert _dqn_diff(cap.state, st) == []


@pytest.mark.gpu
def test_gym_episode_runs_k1_at_one_replica(cuda):
    """The gym adapter on a dense problem on the card takes K1 at R=1 (the
    kernel masks the columns beyond R): an episode equals the same episode
    through K1's twin bit for bit, one launch per sweep. Through
    SpinGlassGymEnv where gymnasium is installed, else through its episode
    core SpinGlassEpisode."""
    from spinglass_tpu_torch.anneal.engines import CudaFusedEngine
    from spinglass_tpu_torch.anneal.twins import TwinFusedEngine
    from spinglass_tpu_torch.rl import gym_adapter as G
    from spinglass_tpu_torch.rl.env import EnvConfig

    adapter = G.SpinGlassGymEnv if G.gymnasium else G.SpinGlassEpisode
    problem = _dqn_problem("K1", cuda)
    cfg = EnvConfig(n_envs=1, sweeps_per_step=5, max_steps=8)
    env = adapter(problem, cfg)
    assert type(env._engine) is CudaFusedEngine
    twin = adapter(problem, cfg,
                   engine=TwinFusedEngine(problem, block_size=128))
    runs, launched = [], []
    for e in (env, twin):
        l0 = build.launch_snapshot()
        rows = [e.reset(seed=3)[0].tolist()]
        for t in range(8):
            obs, r, term, trunc, info = e.step((3 * t) % 10)
            rows.append((obs.tolist(), r, term, trunc, info))
        runs.append(rows)
        launched.append(build.launches_since(l0, [MC.KERNEL_NAME]))
    assert runs[0] == runs[1] and runs[0][-1][3]
    assert launched[0] == {MC.KERNEL_NAME: 8 * 5}


@pytest.mark.gpu
@pytest.mark.parametrize("agent", ["ppo", "dqn"])
def test_pipeline_on_the_card(cuda, agent, tmp_path):
    """RLTrainingPipeline with the curriculum (32, 64, 128) on problems
    built on the card; PPO resumed from a checkpoint equals the
    uninterrupted run bit for bit."""
    from spinglass_tpu_torch.rl import dqn
    from spinglass_tpu_torch.rl import ppo
    from spinglass_tpu_torch.rl import train as T
    from spinglass_tpu_torch.rl.env import EnvConfig

    env_cfg = EnvConfig(n_envs=32, sweeps_per_step=4, max_steps=6)
    ppo_cfg = ppo.PPOConfig(rollout_len=4, hidden_sizes=(32,))
    dqn_cfg = dqn.DQNConfig(hidden_sizes=(32,), batch_size=32,
                            buffer_size=128, steps_per_dispatch=2)
    cur = T.RLTrainingPipeline(
        T.TrainingConfig(agent=agent, n_updates=6, curriculum=True),
        env_cfg, ppo_cfg, dqn_cfg).train()
    assert [m["stage"] for m in cur["metrics"]] == [0, 0, 1, 1, 2, 2]
    assert all(p.is_cuda for p in cur["params"].values())
    if agent == "dqn":
        return

    def cfg(d, n, resume=False):
        return T.TrainingConfig(n_updates=n, checkpoint_interval=2,
                                checkpoint_dir=d, seed=2, resume=resume)

    p = T.default_problem(64)
    full = T.RLTrainingPipeline(cfg(str(tmp_path / "a"), 4), env_cfg,
                                ppo_cfg, problem=p).train()
    d = str(tmp_path / "b")
    T.RLTrainingPipeline(cfg(d, 2), env_cfg, ppo_cfg, problem=p).train()
    res = T.RLTrainingPipeline(cfg(d, 4, True), env_cfg, ppo_cfg,
                               problem=p).train()
    assert res["metrics"] == full["metrics"][2:]
    for k, v in full["params"].items():
        assert torch.equal(res["params"][k], v), k


@pytest.mark.gpu
def test_captured_evaluation_equals_eager_on_the_card(cuda):
    """evaluate_controllers' captured episodes against the eager loop of
    their step (headline.eager_rollout) for each seed, bit for bit."""
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.rl import env as E
    from spinglass_tpu_torch.rl import evaluate as V

    problem = _dqn_problem("K1", cuda)
    cfg = E.EnvConfig(n_envs=40, sweeps_per_step=3, max_steps=6,
                      init_temp_range=(0.1, 20.0))
    eng = E.default_engine(problem, cfg)
    policies = {"geometric": V.make_geometric_policy(cfg),
                "random": V.make_random_policy()}
    _, results = V.evaluate_controllers(problem, cfg, policies, n_seeds=2,
                                        engine=eng)
    for name, fn in policies.items():
        eager = [float(torch.mean(headline.eager_rollout(
            problem, cfg, fn, V.seed_generator(name, 0, s), eng)))
            for s in range(2)]
        assert results[name].tolist() == eager


@pytest.mark.gpu
def test_capture_survives_dead_captured_steps_in_cycles(cuda):
    """Captured steps dropped inside reference cycles, with the collector
    made to run at every allocation: a later capture must not destroy their
    graphs while it captures (the driver refuses that and the capture
    fails), and each step replays what its eager loop computes."""
    import gc

    from spinglass_tpu_torch.anneal import graphs

    def step(st):
        return {"x": st["x"] * 2.0 + 1.0}, None

    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for i in range(4):
            cap = graphs.CapturedStep(
                step, {"x": torch.full((64,), float(i), device=cuda)},
                torch.Generator())
            cap.cycle = cap            # dead once the next one replaces it
            for _ in range(3):
                cap.replay()
            assert float(cap.state["x"][0]) == ((i * 2 + 1) * 2 + 1) * 2 + 1
    finally:
        gc.set_threshold(*old)


def _stacked_pm_j(n_problems, n, device, seed=0):
    """P +-J problems with h on a quarter grid (exact fields), stacked."""
    from spinglass_tpu_torch.anneal import batch

    rng = np.random.default_rng(seed)
    ps = [IsingProblem.from_dense(
        topology.fully_connected(n, dist="binary", seed=seed + p),
        rng.integers(-8, 9, n) / 4.0, device=device)
        for p in range(n_problems)]
    return ps, batch.stack_problems(ps)


@pytest.mark.gpu
@pytest.mark.parametrize("n_problems,n,r,rule", [
    (1, 500, 16, "metropolis"), (3, 500, 37, "glauber"),
    (16, 500, 16, "metropolis"), (3, 2000, 1, "metropolis"),
    (2, 9000, 5, "glauber")])
def test_stacked_k1_equals_single_launches_and_twin(cuda, n_problems, n, r,
                                                    rule):
    """K1 over P stacked problems in one launch equals P one-problem
    launches under the per-problem seeds, and the stacked twin, bit for bit
    (spins, dE, counts), in the Philox and host-uniform modes; n = 9000
    pads beyond the cluster kernel's limit, so the one-block kernel runs."""
    ps, st = _stacked_pm_j(n_problems, n, cuda)
    n_pad = st.n_padded
    sw = MC.StackedFusedSweep(st.j, st.h, st.active_mask, block_size=128,
                              rule=rule)
    assert sw.tile == MC.dense_tile(n_pad, 128)
    rng = np.random.default_rng(n_problems + r)
    s = torch.as_tensor(np.where(rng.random((n_problems, n_pad, r)) < 0.5,
                                 -1.0, 1.0), dtype=torch.float32, device=cuda)
    s[:, n:] = 1.0
    beta = torch.as_tensor(rng.uniform(0.1, 2.0, (n_problems, r)),
                           dtype=torch.float32, device=cuda)
    seeds = torch.as_tensor(rng.integers(0, 2 ** 62, n_problems),
                            dtype=torch.int64, device=cuda)
    stacked = 0   # the stacked sweep's launches (the single ones not counted)
    for k in range(2):
        singles = s.clone()
        twin = s.clone()
        l0 = build.launch_snapshot()
        if k == 0:
            _, de, cnt = sw(s, beta, seeds)
            u = torch.stack([MC.philox_uniforms(seeds[p], n_pad, r, cuda)
                             for p in range(n_problems)])
        else:
            u = torch.rand(n_problems, n_pad, r, device=cuda)
            _, de, cnt = sw.sweep_with_uniforms(s, beta, u)
        stacked += build.launches_since(l0, [MC.KERNEL_NAME])[MC.KERNEL_NAME]
        for p, prob in enumerate(ps):
            one = MC.FusedSweep(prob, block_size=128, rule=rule)
            if k == 0:
                _, de1, cnt1 = one(singles[p], beta[p], seeds[p:p + 1])
            else:
                _, de1, cnt1 = one.sweep_with_uniforms(singles[p], beta[p],
                                                       u[p].contiguous())
            assert torch.equal(de[p], de1) and torch.equal(cnt[p], cnt1)
        _, de_t, cnt_t = sw.reference(twin, beta, u)
        torch.cuda.synchronize()
        assert torch.equal(s, singles) and torch.equal(s, twin)
        assert torch.equal(de, de_t) and torch.equal(cnt, cnt_t)
    assert stacked == 2


@pytest.mark.gpu
def test_batch_captured_run_equals_eager_loop(cuda):
    """A batch's captured stacked run (one replay) equals its eager loop
    bit for bit under one seed, with exactly n_sweeps K1 launches."""
    from spinglass_tpu_torch.anneal import batch
    from spinglass_tpu_torch.anneal.sa import SAConfig

    cfg = SAConfig(n_sweeps=40, n_replicas=16)
    ps, st = _stacked_pm_j(4, 300, cuda, seed=5)
    batch.clear_runs()
    l0 = build.launch_snapshot()
    run = batch.stacked_run(st, cfg)
    got = run.run(st, torch.Generator().manual_seed(9))
    assert build.launches_since(l0, [MC.KERNEL_NAME]) == {MC.KERNEL_NAME: 40}
    (be, bs, rep), n = batch.eager_stacked(st, cfg,
                                           torch.Generator().manual_seed(9))
    assert n == 40
    for a, b in zip(got, (be, bs, rep)):
        assert np.array_equal(a, b.cpu().numpy())
    res = batch.BatchProcessor(cfg).process(ps)
    assert all(r.algorithm == "sa/batched" for r in res)
    from spinglass_tpu_torch.core import energy as E

    for p, r in zip(ps, res):
        s_pad = np.concatenate([r.best_spins, np.ones(p.n_padded - 300)])
        e = float(E.energy(p, torch.as_tensor(s_pad, dtype=torch.float32,
                                              device=cuda)))
        assert e == r.best_energy


@pytest.mark.gpu
@pytest.mark.parametrize("kind,r", [("dense", 32), ("ell", 32),
                                    ("ell", 128)])
def test_adaptive_anneal_on_the_card(cuda, kind, r):
    """adaptive_anneal through K1, K4 (R=32) and K2 (R=128): interventions
    fire on a stagnating run, the best energy is the best spins' energy,
    and the kernel launches are the sweeps done."""
    from spinglass_tpu_torch.anneal.adaptive import (AdaptiveSAConfig,
                                                     adaptive_anneal)
    from spinglass_tpu_torch.anneal.sa import SAConfig
    from spinglass_tpu_torch.anneal.schedules import ScheduleConfig
    from spinglass_tpu_torch.core import energy as E

    sched = ScheduleConfig(initial_temp=3.0, final_temp=0.05)
    cfg = AdaptiveSAConfig(base=SAConfig(n_sweeps=400, n_replicas=r,
                                         record_interval=20, schedule=sched),
                           stagnation_chunks=3)
    if kind == "dense":
        p = IsingProblem.from_dense(
            topology.fully_connected(300, dist="binary", seed=1), device=cuda)
    else:
        p = _pm_j_ell(2000, 4, cuda)
    res = adaptive_anneal(p, cfg)
    assert res.metadata["interventions"] >= 1
    launches = res.metadata["kernel_launches"]
    if kind == "dense":
        assert launches == {MC.KERNEL_NAME: 400, "sa_track": 400}
        e = E.energy(p, torch.as_tensor(
            np.concatenate([res.best_spins, np.ones(p.n_padded - 300)]),
            dtype=torch.float32, device=cuda))
    else:
        key = "sparse_sweep" if r % 128 == 0 else "sparse_accept"
        assert launches[key] > 0
        e = S.sparse_energy(p, torch.as_tensor(
            np.concatenate([res.best_spins,
                            np.ones(p.n_padded - p.n_spins)]),
            dtype=torch.float32, device=cuda)[None])[0]
    assert float(e) == pytest.approx(res.best_energy, rel=1e-4)


def _trotter_case(cuda, n=128, p=4, seed=5):
    """A +-J glass with quarter-grid fields and the fields (beta 2) that put
    J_perp at 0.25 and 0.5: every Trotter field is exact."""
    import math

    j = topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    gammas = [p / 2.0 * math.atanh(math.exp(-4.0 * jp)) for jp in (0.25, 0.5)]
    return IsingProblem.from_dense(j, h, device=cuda), gammas


@pytest.mark.gpu
def test_sqa_stage_through_k1_equals_twin(cuda):
    """One SQA stage (100 sweeps at T = 1/beta, R=16) on the Trotter problem
    through K1 and through its twin on one generator seed: the state bit for
    bit; K1 runs three planes though J_perp = 0.25 is exact in bf16."""
    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.anneal.twins import TwinFusedEngine
    from spinglass_tpu_torch.research import quantum as Q

    base, gammas = _trotter_case(cuda)
    tp = Q.trotterize(base, 4, 2.0, gammas[0])
    cfg = Q.stage_config(Q.SQAConfig(n_trotter=4, n_replicas=16), 100, 0)
    eng = sa.make_sweep_engine(tp, cfg)
    assert eng.name == "cuda_fused" and eng.fused.planes == 3
    out, launched = [], []
    for e in (eng, TwinFusedEngine(tp, block_size=cfg.block_size)):
        l0 = build.launch_snapshot()
        st = sa.init_state(tp, cfg, e, torch.Generator().manual_seed(3))
        out.append(sa.run_chunk(tp, cfg, e, st, 100)[0])
        launched.append(build.launches_since(l0, [MC.KERNEL_NAME]))
    torch.cuda.synchronize()
    for k in ("spins", "energy", "best_energy", "best_spins", "acc_rate"):
        assert torch.equal(getattr(out[0], k), getattr(out[1], k)), k
    assert launched[0] == {MC.KERNEL_NAME: 100}


@pytest.mark.gpu
def test_sqa_on_the_card_equals_per_stage_rebuild(cuda):
    """SQA through K1 on its cached Trotter problem (J_perp rewritten in
    place, one captured chunk for every stage) against a fresh Trotter
    problem and capture per stage, on one generator seed: bit for bit; the
    first call captures once, a repeat call not at all; K1 launched once
    per sweep."""
    from spinglass_tpu_torch.anneal import graphs, sa
    from spinglass_tpu_torch.kernels import track_cuda as TC
    from spinglass_tpu_torch.research import quantum as Q

    base, (g0, g1) = _trotter_case(cuda, n=200, seed=2)
    cfg = Q.SQAConfig(n_trotter=4, gamma_start=g0, gamma_end=g1, n_stages=3,
                      sweeps_per_stage=50, n_replicas=16)
    graphs.clear_caches()
    l0 = build.launch_snapshot()
    got = Q.simulated_quantum_annealing(
        base, cfg, generator=torch.Generator().manual_seed(8))
    assert got.metadata["captures"] == 1
    assert build.launches_since(l0) == {MC.KERNEL_NAME: 150, TC.KERNEL: 150}
    gen = torch.Generator().manual_seed(8)
    best, spins = np.inf, None
    for stage, gamma in enumerate(np.geomspace(g0, g1, 3)):
        res = sa.anneal(Q.trotterize(base, 4, 2.0, float(gamma)),
                        Q.stage_config(cfg, 50, stage), generator=gen)
        slices, e = Q.slice_energies(base, res.best_spins, 4)
        k = int(np.argmin(e))
        if e[k] < best:
            best, spins = float(e[k]), slices[k]
    assert got.best_energy == best
    np.testing.assert_array_equal(got.best_spins, spins)
    again = Q.simulated_quantum_annealing(
        base, cfg, generator=torch.Generator().manual_seed(8))
    assert again.metadata["captures"] == 0 and again.best_energy == best


@pytest.mark.gpu
def test_aqia_captured_equals_eager_on_the_card(cuda):
    """AQIA's captured iteration replayed against the eager loop of
    ``aqia_step`` on one generator seed: history and replica bests bit for
    bit."""
    from spinglass_tpu_torch.research import novel as N

    p = IsingProblem.from_dense(topology.fully_connected(
        300, dist="binary", seed=4), device=cuda)
    cfg = N.AQIAConfig(n_iterations=40, n_replicas=32)
    got = N.adaptive_quantum_inspired_annealing(
        p, cfg, generator=torch.Generator().manual_seed(6))
    st = N.aqia_init(p, cfg, torch.Generator().manual_seed(6))
    hist = []
    for _ in range(40):
        st, out = N.aqia_step(p, cfg, st)
        hist.append(out)
    np.testing.assert_array_equal(got.energy_history,
                                  torch.stack(hist).cpu().numpy())
    np.testing.assert_array_equal(got.replica_best_energy,
                                  st.best_e.cpu().numpy())


@pytest.mark.gpu
def test_research_paths_launch_k1_on_the_card(cuda):
    """QEC, MSHO, PIMC and a meta-RL solve on the card launch K1 once per
    sweep (the launch ledger over each call); LESD and a meta-network fit run
    with capturable Adam there."""
    from spinglass_tpu_torch.research import meta_rl, novel, quantum

    p = IsingProblem.from_dense(topology.fully_connected(
        100, dist="gaussian", scale=0.1, seed=3), device=cuda)
    for fn, want in (
            (lambda: novel.quantum_error_corrected_annealing(
                p, novel.QECConfig(n_sweeps=50)), 50),
            (lambda: quantum.path_integral_monte_carlo(
                p, quantum.PIMCConfig(n_sweeps=30)), 30),
            (lambda: meta_rl.AdaptiveMetaRLAgent(meta_rl.MetaRLConfig(
                n_sweeps=20), device=cuda).solve(p)[0], 20)):
        l0 = build.launch_snapshot()
        res = fn()
        assert build.launches_since(l0, [MC.KERNEL_NAME]) == {
            MC.KERNEL_NAME: want} and np.isfinite(res.best_energy)
    l0 = build.launch_snapshot()
    res = novel.multi_scale_optimization(p, novel.MSHOConfig(
        coarse_sweeps=30, refine_sweeps=20))
    assert build.launches_since(l0, [MC.KERNEL_NAME]) == {
        MC.KERNEL_NAME: 30 + 20 * (res.metadata["n_levels"] - 1)}
    res = novel.learning_enhanced_dynamics(p, novel.LESDConfig(
        n_iterations=20))
    assert np.isfinite(res.metadata["final_loss"])
    assert res.metadata["params"]["dense.0.weight"].is_cuda
    x = np.random.default_rng(0).normal(size=(16, meta_rl.EMBED_DIM))
    params, loss = meta_rl.fit_meta_network(
        meta_rl.MetaLearningNetwork((16,)), x, x[:, :3], np.ones(16),
        n_steps=20, device=cuda)
    assert np.isfinite(loss) and params["dense.0.weight"].is_cuda


@pytest.mark.gpu
def test_lesd_captured_equals_eager_on_the_card(cuda):
    """LESD's captured iteration (forward, backward and capturable Adam in
    one graph) replayed against the eager loop of ``lesd_step`` on one
    generator seed: losses, replica bests and the scorer's parameters bit
    for bit."""
    from spinglass_tpu_torch.core import energy as E
    from spinglass_tpu_torch.core import rng
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.research import novel as N
    from spinglass_tpu_torch.rl.ppo import init_params

    p = IsingProblem.from_dense(topology.fully_connected(
        300, dist="binary", seed=2), device=cuda)
    cfg = N.LESDConfig(n_iterations=30, n_replicas=16)
    got = N.learning_enhanced_dynamics(
        p, cfg, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    model = N.SpinScorer().to(cuda)
    params = init_params(model, gen, cuda)
    opt = torch.optim.Adam(list(params.values()), lr=cfg.lr, eps=1e-8,
                           capturable=True)
    spins = random_spins(rng.device_generator(gen, cuda), (16, p.n_padded),
                         p.active_mask)
    e = E.energy(p, spins)
    best_e, best_s, losses = e, spins, []
    for _ in range(30):
        spins, e, best_e, best_s, loss = N.lesd_step(
            p, cfg, model, params, opt, spins, e, best_e, best_s, gen)
        losses.append(loss)
    np.testing.assert_array_equal(got.energy_history,
                                  torch.stack(losses).cpu().numpy())
    np.testing.assert_array_equal(got.replica_best_energy,
                                  best_e.cpu().numpy())
    for k, v in params.items():
        assert torch.equal(got.metadata["params"][k], v.detach()), k


# -- the distributed layer on a one-rank NCCL group ----------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL group and its replica mesh, taken down after the
    module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the kernels run there")
    from spinglass_tpu_torch.distributed import multihost, pt_sharded

    info = multihost.initialize(device="cuda")
    assert info["backend"] == "nccl"
    yield pt_sharded.make_mesh()
    multihost.shutdown()


def _pt_results_equal(a, b):
    keys = ("energy_history", "mean_energy_history", "acceptance_history")
    return (a.best_energy == b.best_energy
            and np.array_equal(a.best_spins, b.best_spins)
            and np.array_equal(a.replica_best_energy, b.replica_best_energy)
            and all(np.array_equal(getattr(a, k), getattr(b, k)) for k in keys)
            and np.array_equal(a.metadata["slot_trajectory"],
                               b.metadata["slot_trajectory"])
            and a.metadata["exchange_rates"] == b.metadata["exchange_rates"])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,r,kernel", [("dense", 64, "metropolis_sweep"),
                                           ("sparse", 128, "sparse_sweep"),
                                           ("sparse", 16, "sparse_accept")])
def test_sharded_pt_one_rank_equals_pt_run(cuda, nccl_mesh, kind, r, kernel):
    """``pt_sharded.run`` on a one-rank NCCL group (the super-step captured
    with its all-gather inside) launches K1, K2 or K4 and equals ``pt.run``
    on the same seed bit for bit."""
    from spinglass_tpu_torch.anneal import pt
    from spinglass_tpu_torch.distributed import pt_sharded

    if kind == "dense":
        j = topology.fully_connected(500, dist="binary", seed=5)
        p = IsingProblem.from_dense(
            j, np.random.default_rng(5).integers(-8, 9, 500) / 4.0,
            device=cuda)
        kw = dict(sweep_method="blocked")
    else:
        coo = topology.sparse_random_graph_coo(2000, avg_degree=6.0,
                                               dist="binary", seed=5)
        p = S.EllProblem.from_coo(2000, *coo, device=cuda)
        kw = {}
    cfg = pt.PTConfig(n_replicas=r, n_sweeps=40, exchange_interval=5,
                      min_temp=0.2, max_temp=3.0, seed=9, **kw)
    got = pt_sharded.run(p, cfg, nccl_mesh)
    ref = pt.run(p, cfg)
    assert got.metadata["kernel_launches"][kernel] > 0
    assert got.metadata["kernel_launches"] == ref.metadata["kernel_launches"]
    assert got.algorithm.endswith("x1") and got.metadata["n_devices"] == 1
    assert _pt_results_equal(got, ref)
    assert _pt_results_equal(pt_sharded.run(p, cfg, nccl_mesh), ref)


@pytest.mark.gpu
def test_threaded_anneals_through_k1_equal_sequential_calls(cuda):
    """Eight threads anneal one problem through K1 at once (one cached
    captured chunk): each result equals its seed's call made alone."""
    import threading

    from spinglass_tpu_torch.anneal.sa import SAConfig, anneal

    p = IsingProblem.from_dense(topology.fully_connected(
        256, dist="binary", seed=8), device=cuda)

    def cfg(s):
        return SAConfig(n_sweeps=200, n_replicas=32, seed=s)

    seq = {s: anneal(p, cfg(s)) for s in range(8)}
    out, errors = {}, []

    def work(s):
        try:
            out[s] = anneal(p, cfg(s))
        except Exception as exc:  # recorded: asserted empty below
            errors.append(repr(exc))

    threads = [threading.Thread(target=work, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for s in range(8):
        assert out[s].metadata["engine"] == "cuda_fused"
        assert out[s].best_energy == seq[s].best_energy
        assert np.array_equal(out[s].best_spins, seq[s].best_spins)
        assert np.array_equal(out[s].energy_history, seq[s].energy_history)


@pytest.mark.gpu
def test_sa_start_is_drawn_on_the_card(cuda, tmp_path):
    """At the sparse SA cell's shape (1024 replicas of a 10,000-spin graph
    of degree 6, K2's engine) ``sa.init_state`` draws its start spins on the
    card: no host-to-device copy over 1 MB, the spins on the card, and
    under 20 ms a call (the median of three) after a warm-up call."""
    import json
    import time

    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.utils.profiling import device_trace

    p = _pm_j_ell(10000, 4, cuda)
    cfg = sa.SAConfig(n_sweeps=1000, n_replicas=1024, enable_early_stop=False)
    eng = sa.make_sweep_engine(p, cfg)
    assert eng.name == "sparse_sorted_t"
    sa.init_state(p, cfg, eng, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    with device_trace(str(tmp_path)):
        state = sa.init_state(p, cfg, eng, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in ev)   # the card was traced
    copies = [e for e in ev if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    assert all(e["args"]["bytes"] <= 1 << 20 for e in copies), copies
    assert state.spins.is_cuda and state.best_spins.is_cuda
    assert eng.from_layout(state.spins).shape == (1024, p.n_padded)
    times = []
    for s in range(3, 6):
        t0 = time.perf_counter()
        sa.init_state(p, cfg, eng, torch.Generator().manual_seed(s))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    assert sorted(times)[1] < 0.020, times


@pytest.mark.gpu
@pytest.mark.parametrize("ns,n_chains,t,dtype", [
    (32768, 4, 34, torch.int8), (32768, 4, 34, torch.float32),
    (5000, 2, 300, torch.int8), (5000, 3, 34, torch.int8),
    (5000, 8, 17, torch.float32)])
def test_overlap_kernel_matches_twin_at_l32(cuda, ns, n_chains, t, dtype):
    """The overlap kernel at the 3-D glass's shape, [32768, 136] (4 chains
    of 34 slots), and at other chain counts (a bound of the kernel's loops,
    not a template: two chains over two slot blocks of 300 slots, three,
    the most) equals its plain twin bit for bit, with every row real and
    with padding rows; one launch a call, and its scratch is left zeroed
    (a second call gives the same)."""
    from spinglass_tpu_torch.kernels import overlap_cuda as OC

    g = torch.Generator(device=cuda).manual_seed(3)
    s = (2 * torch.randint(0, 2, (ns, n_chains * t), generator=g,
                           device=cuda) - 1).to(dtype)
    slot = torch.cat([torch.randperm(t, generator=g, device=cuda)
                      for _ in range(n_chains)]).to(torch.int32)
    for n_pad in (0, 1000):
        mask = torch.zeros(ns, device=cuda)
        mask[ns - n_pad:] = -torch.inf
        op = OC.ReplicaOverlap(mask, n_chains, ns - n_pad)
        l0 = build.launch_snapshot()
        got = op(s, slot)
        again = op(s, slot)
        want = OC.overlap_reference(s.cpu(), mask.cpu(), slot.cpu(),
                                    n_chains, ns - n_pad)
        torch.cuda.synchronize()
        assert got.shape == (t, n_chains * (n_chains - 1) // 2)
        assert build.launches_since(l0, [OC.KERNEL]) == {OC.KERNEL: 2}
        assert torch.equal(got.cpu(), want) and torch.equal(again, got)


@pytest.mark.gpu
def test_make_engine_on_the_l32_lattice_takes_k4_with_two_colours(cuda):
    """The 3-D +-J lattice at L=32 with 4 chains of 34 replicas (R=136, no
    multiple of 128): the transposed sparse engine on K4, two colours of
    16,384 rows, two K4 launches a sweep."""
    from spinglass_tpu_torch.anneal.engines import make_engine
    from spinglass_tpu_torch.core.topology import lattice_coo

    p = S.EllProblem.from_coo(*lattice_coo(32, seed=1), device=cuda)
    eng = make_engine(p, update_rule="heat_bath", r_hint=136)
    assert eng.name == "sparse_sorted_t" and eng.n_colors == 2
    assert eng.n_sorted == 32768 and eng.state_dtype(136) == torch.int8
    assert [size for _, size, _ in eng.groups] == [16384, 16384]
    s = eng.to_layout(torch.ones(136, p.n_padded, device=cuda))
    beta = torch.full((136,), 1.0, device=cuda)
    l0 = build.launch_snapshot()
    eng.sweep(s, beta, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert build.launches_since(l0, eng.kernel_names) == {
        "sparse_sweep": 0, "sparse_thresholds": 0, "sparse_accept": 2}


def _track_case(cuda, layout, dtype, rows, r, mask, seed):
    """A sweep's [R] state on the card with improved replicas as ``mask``
    says ("random": below, equal or above at random; "all"; "none"),
    random spins and int8 best spins in ``layout`` and the last 3% of rows
    padding (n_spins below rows)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = (rows, r) if layout == "nr" else (r, rows)
    spins, best = ((2 * torch.randint(0, 2, shape, generator=g, device=cuda)
                    - 1).to(t) for t in (dtype, torch.int8))
    energy = torch.randn(r, generator=g, device=cuda) * 1e4
    de = torch.randn(r, generator=g, device=cuda) * 30
    e = energy + de
    if mask == "random":
        step = torch.randint(-1, 2, (r,), generator=g, device=cuda) * 0.5
        best_e = e + step.float()
    else:
        best_e = torch.full_like(e, torch.inf if mask == "all" else -torch.inf)
    cnt = torch.randint(0, rows, (r,), generator=g, device=cuda,
                        dtype=torch.int32)
    return energy, de, best_e, cnt, spins, best, layout, rows - rows // 33


@pytest.mark.gpu
@pytest.mark.parametrize("mask", ["random", "all", "none"])
@pytest.mark.parametrize("layout,dtype,rows,r", [
    ("nr", torch.float32, 10240, 1024), ("nr", torch.float32, 4096, 1024),
    ("nr", torch.int8, 32768, 136), ("nr", torch.float32, 700, 37),
    ("rn", torch.float32, 4096, 64), ("rn", torch.int8, 10001, 24)],
    ids=["planted10k", "sk4096", "int8-136", "f32-37", "rn", "rn-int8-odd"])
def test_sa_track_kernel_matches_twin(cuda, layout, dtype, rows, r, mask):
    """The best-tracking kernel against its twin on the same card tensors,
    bit for bit: energies, best energies, acceptance rates (the float32
    reciprocal's product), best spins (int8, updated in place; the twin's
    in the spins' type; every vector width: 16-byte rows, 8 spins at R=136
    int8, 1 at R=37 and at an odd int8 row) and the copy counts; one
    launch each."""
    from spinglass_tpu_torch.kernels import track_cuda as TC

    args = _track_case(cuda, layout, dtype, rows, r, mask, rows + r)
    want = TC.track_reference(*args)
    track = TC.BestTrack()
    best_in = args[5]
    l0 = build.launch_snapshot()
    got = track(*args)
    torch.cuda.synchronize()
    assert got[2] is best_in
    assert build.launches_since(l0, [TC.KERNEL]) == {TC.KERNEL: 1}
    assert got[2].dtype == torch.int8
    assert torch.equal(got[2], want[2].to(torch.int8))
    for i in (0, 1, 3):
        assert got[i].dtype == want[i].dtype and torch.equal(got[i], want[i])
    assert torch.equal(track.copies, want[4].to(torch.int32))
    n_imp = int(want[4].sum())
    assert n_imp == {"all": r, "none": 0}.get(mask, n_imp)
    if mask == "random":
        assert 0 < n_imp < r


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["planted10k", "sk4096"])
def test_captured_anneal_equals_the_twin_stream(cuda, monkeypatch, kind):
    """A captured ``sa.anneal`` through the best-tracking kernel equals the
    same run with the twin (the six ops the driver ran before the kernel)
    forced on the card's tensors, bit for bit: best energy and spins, every
    replica's best and the four histories; the kernel launched once a
    sweep, and best_copy_share equal."""
    from spinglass_tpu_torch.anneal import graphs, sa
    from spinglass_tpu_torch.kernels import track_cuda as TC

    if kind == "sk4096":
        p = IsingProblem.from_dense(topology.fully_connected(
            4096, dist="gaussian", scale=1.0 / 64, seed=42), device=cuda)
    else:
        coo = topology.sparse_random_graph_coo(10000, avg_degree=6.0,
                                               dist="gaussian", seed=42)
        p = S.EllProblem.from_coo(10000, *coo, device=cuda)
    cfg = sa.SAConfig(n_sweeps=150, n_replicas=1024, record_interval=50,
                      enable_early_stop=False)
    graphs.clear_caches()
    res = sa.anneal(p, cfg, generator=torch.Generator().manual_seed(2 ** 33))

    def twin_launch(self, energy, de, best_energy, cnt, spins, best_spins,
                    layout, n_spins):
        *out, improved = TC.track_reference(energy, de, best_energy, cnt,
                                            spins, best_spins, layout,
                                            n_spins)
        self.copies += improved.to(torch.int32)
        return tuple(out)

    monkeypatch.setattr(TC.BestTrack, "_launch", twin_launch)
    graphs.clear_caches()
    ref = sa.anneal(p, cfg, generator=torch.Generator().manual_seed(2 ** 33))
    graphs.clear_caches()
    assert res.metadata["engine"] == ("cuda_fused" if kind == "sk4096"
                                      else "sparse_sorted_t")
    assert res.metadata["kernel_launches"]["sa_track"] == 150
    assert ref.metadata["kernel_launches"]["sa_track"] == 0
    assert res.best_energy == ref.best_energy
    for name in ("best_spins", "replica_best_energy", "energy_history",
                 "mean_energy_history", "temperature_history",
                 "acceptance_history"):
        np.testing.assert_array_equal(getattr(res, name), getattr(ref, name))
    assert res.metadata["best_copy_share"] == ref.metadata["best_copy_share"]
    assert 0.0 < res.metadata["best_copy_share"] < 1.0


def _pt_leaves(cuda, seed, rows=10240, r=128):
    """The nine tensors of a PT state at [rows, R] float32 spins, in the
    order of its leaves; the energies a view at a 4-byte offset, so that
    the kernel's byte-wise path copies them (and the [R - 1] counters)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    spins = (2 * torch.randint(0, 2, (rows, r), generator=g, device=cuda)
             - 1).float()
    energy = torch.randn(r + 1, generator=g, device=cuda)[1:]
    return [spins, torch.randperm(r, generator=g, device=cuda).int(), energy,
            torch.randn(r, generator=g, device=cuda) * 1e4,
            (2 * torch.randint(0, 2, (rows, r), generator=g, device=cuda)
             - 1).float(),
            torch.tensor(10 * seed, dtype=torch.int64, device=cuda),
            torch.randint(0, 99, (r - 1,), generator=g, device=cuda,
                          dtype=torch.int32),
            torch.randint(0, 99, (r - 1,), generator=g, device=cuda,
                          dtype=torch.int32),
            torch.rand(r, generator=g, device=cuda)]


@pytest.mark.gpu
def test_latch_kernel_matches_twin(cuda):
    """The time-to-target latch against its twin on the same card tensors
    at [10240, 128] float32, bit for bit, over a solve's three kinds of
    super-step: above the threshold (no copy), the hit (every leaf copied,
    the flag set), and one after the hit (no copy); one launch each."""
    from spinglass_tpu_torch.kernels import latch_cuda as LC

    first, later = _pt_leaves(cuda, 1), _pt_leaves(cuda, 2)
    kernel, twin = LC.Latch(first), LC.Latch(first)
    l0 = build.launch_snapshot()
    for latch in (kernel, twin):
        latch.arm(-1000.0)
    for best, src, flag in ((-999.5, first, 0), (-1000.0, first, 1),
                            (-2000.0, later, 1)):
        b = torch.tensor(best, dtype=torch.float32, device=cuda)
        kernel(b, src)
        LC.latch_reference(b, twin.threshold, twin.flag, src, twin.snapshot)
        torch.cuda.synchronize()
        assert kernel.flag.tolist() == twin.flag.tolist() == [flag, 0]
        for got, want in zip(kernel.snapshot, twin.snapshot):
            assert torch.equal(got, want)
    for got, want in zip(kernel.snapshot, first):
        assert torch.equal(got, want)
    assert build.launches_since(l0, [LC.KERNEL]) == {LC.KERNEL: 3}


@pytest.mark.gpu
def test_time_to_target_equals_serial_replay_loop(cuda):
    """``time_to_target`` (replays queued ahead of the read, the latch)
    against a plain serial loop of replays and 4-byte reads of the same
    captured super-step under the same seeds, on a small planted instance
    at 128 replicas (K2): sweeps, best energy, every leaf of the captured
    state and the generator, bit for bit; one replay discarded a hit."""
    from spinglass_tpu_torch.anneal import graphs, pt
    from spinglass_tpu_torch.benchmarks import planted

    inst = planted.planted_gauge_coo(2000, 6.0, seed=4, frustration=0.3)
    ell = S.EllProblem.from_coo(2000, inst.rows, inst.cols, inst.vals,
                                device=cuda)
    cfg = pt.PTConfig(n_replicas=128, exchange_interval=10, min_temp=0.05,
                      max_temp=3.0)
    graphs.clear_caches()
    miss = planted.time_to_target(ell, -1e12, cfg, rel_gap=0.0,
                                  max_sweeps=300, seeds=[11])
    assert miss["per_seed"][0]["launched"] == 30
    assert miss["per_seed"][0]["discarded"] == 0 and not miss["hit"]
    engine, captured = graphs.PT_CACHE.get(
        ell, ("time_to_target", graphs.config_key(cfg)))
    assert engine.name == "sparse_sorted_t"
    read = graphs.HostRead()

    def serial(seed, threshold, max_super):
        gen = torch.Generator().manual_seed(seed)
        captured.load(graphs.device_counter(pt.init_state(ell, cfg, gen,
                                                          engine)))
        n, best, bests = 0, float("inf"), []
        while best > threshold and n < max_super:
            out = captured.replay(gen)
            n += 1
            best = min(best, float(read([out])[0]))
            bests.append(best)
        return n, best, bests, [t.clone() for t in
                                graphs.leaves(captured.state)], gen

    for seed in (11, 12, 13):
        bests = serial(seed, -float("inf"), 30)[2]
        steps = [k + 1 for k in range(1, 30) if bests[k] < bests[k - 1]]
        k = steps[len(steps) // 2]
        threshold = bests[k - 1]
        gen = torch.Generator().manual_seed(seed)
        out = planted.time_to_target(ell, threshold, cfg, rel_gap=0.0,
                                     max_sweeps=300, generator=gen)
        got = [t.clone() for t in graphs.leaves(captured.state)]
        n, best, _, want, gen_serial = serial(seed, threshold, 30)
        assert n == k and out["sweeps"] == 10 * k and out["hit"]
        assert out["best_energy"] == best
        assert out["launched"] == k + 1 and out["discarded"] == 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(gen.get_state(), gen_serial.get_state())
    graphs.clear_caches()


@pytest.mark.gpu
def test_latch_costs_at_most_5_us_a_super_step(cuda):
    """The latch where it copies nothing (every super-step but the hit) at
    [10240, 128] float32, 100 launches as one graph, by CUDA events: at
    most 5 us each. The hit's copy is timed too (the flag cleared before
    each launch inside the graph) and printed."""
    from spinglass_tpu_torch.kernels import latch_cuda as LC

    src = _pt_leaves(cuda, 3)
    latch = LC.Latch(src)
    best = torch.tensor(-1.0, dtype=torch.float32, device=cuda)
    times = {}
    for kind in ("no_op", "hit"):
        latch.arm(0.0 if kind == "hit" else -10.0)

        def launches():
            for _ in range(100):
                if kind == "hit":
                    latch.flag.zero_()
                latch(best, src)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            launches()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            launches()
        graph.replay()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            graph.replay()
        stop.record()
        stop.synchronize()
        times[kind] = start.elapsed_time(stop) * 1e3 / 1000
    print(f"pt_latch at [10240, 128] float32, as a graph: no copy "
          f"{times['no_op']:.3f} us, hit (with a flag reset) "
          f"{times['hit']:.3f} us a launch")
    assert times["no_op"] <= 5.0
    for got, want in zip(latch.snapshot, src):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_sparse_sqa_takes_k2_and_decodes_as_the_reference(cuda, monkeypatch):
    """SQA of an 8 x 8 glass at P=4, R=128 with the state carried: K2
    takes every sweep, one launch a sweep by the launch ledger; every
    replica's slice energies, least slice energy and action at the last
    Gamma match the plain reference's float64 values on the card (2e-6
    relative: float32 sums over couplings rounded once to float32); and
    J_perp is written with no synchronise."""
    import importlib.util
    import pathlib

    from spinglass_tpu_torch.research import quantum as Q

    spec = importlib.util.spec_from_file_location(
        "torch_reference_sqa2d",
        pathlib.Path(__file__).parent / "torch_reference" / "sqa2d.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ref.exact()
    L, p, r = 8, 4, 128
    ell = S.EllProblem.from_coo(*topology.lattice_coo(
        L, dims=2, dist="uniform", scale=2.0, seed=3), device=cuda)
    cfg = Q.SQAConfig(n_trotter=p, beta=4.0, n_stages=4, sweeps_per_stage=25,
                      n_replicas=r, carry_state=True, gamma_schedule="linear")
    finals = []
    drawn = Q.anneal_drawn

    def spy(*args, final_spins=None, **kw):
        res = drawn(*args, final_spins=final_spins, **kw)
        finals.append(final_spins.clone())
        return res

    monkeypatch.setattr(Q, "anneal_drawn", spy)
    l0 = build.launch_snapshot()
    res = Q.simulated_quantum_annealing(ell, cfg)
    torch.cuda.synchronize()
    assert build.launches_since(l0, [SC.SWEEP_KERNEL, SC.THRESHOLD_KERNEL,
                                     SC.ACCEPT_KERNEL]) == {
        SC.SWEEP_KERNEL: 100, SC.THRESHOLD_KERNEL: 0, SC.ACCEPT_KERNEL: 0}
    assert res.metadata["kernel_launches"][SC.SWEEP_KERNEL] == 100
    j = ref.couplings(L, 3, device=cuda)
    final = ref.lattice(finals[-1][:, : p * L * L], L, p)
    e, least = ref.decode(j, final)
    np.testing.assert_allclose(res.metadata["slice_energies"],
                               e.cpu().numpy(), rtol=2e-6)
    np.testing.assert_allclose(res.replica_best_energy, least.cpu().numpy(),
                               rtol=2e-6)
    jp = ref.j_perp(cfg.beta, res.metadata["gammas"][-1], p)
    np.testing.assert_allclose(res.metadata["final_action"],
                               ref.action(j, final, jp).cpu().numpy(),
                               rtol=2e-6)
    spins = torch.as_tensor(res.metadata["replica_spins"], device=cuda)
    np.testing.assert_allclose(
        ref.energies(j, ref.lattice(spins, L)).cpu().numpy(),
        res.replica_best_energy, rtol=2e-6)
    tp = Q.TROTTER_CACHE.get(ell, ("trotter", p))
    torch.cuda.set_sync_debug_mode("error")
    try:
        tp.set_field(cfg.beta, 1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert float(tp.field) == float(np.float32(Q.j_perp(cfg.beta, 1.0, p)))
    # the engine that the stages replay holds the new J_perp in every table
    from spinglass_tpu_torch.anneal import graphs

    engine, = graphs.sa_engines_of(tp)
    fresh = S.SortedSparseTEngine(Q.trotterize(ell, p, cfg.beta, 1.0))

    def tables(eng):
        return ([b.val for _, _, bs in eng.groups for b in bs]
                + [eng.kernels.tables["val"], eng.kernels._val_t,
                   eng._coupling.values()])

    for x, y in zip(tables(engine), tables(fresh)):
        assert torch.equal(x, y)
