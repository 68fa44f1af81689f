"""K1-K7 against their plain twins on a CUDA device (the smoke script's
parity phase at a small size). Needs a GPU and nvcc; skips elsewhere.

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest  # on the GPU
"""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
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
    assert fused.launches == 3


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
    assert eng.launches == {"sparse_sweep": 3, "sparse_thresholds": 1,
                            "sparse_accept": 0}


@pytest.mark.gpu
def test_sparse_engine_dispatch_on_cuda(cuda):
    """make_engine takes the transposed engine for r_hint >= 128 on the
    card; R=128 runs K2, R=4096 at a layout too large for the budget runs
    K3 and the plain per-colour sweep."""
    from spinglass_tpu_torch.anneal.engines import make_engine

    ell = _pm_j_ell(500, 4, cuda)
    eng = make_engine(ell, r_hint=128)
    assert eng.name == "sparse_sorted_t" and eng.spin_dtype == torch.float32
    assert make_engine(ell, r_hint=16).name == "sparse_sorted"
    gen = torch.Generator().manual_seed(0)
    s = eng.to_layout(torch.ones(128, ell.n_padded, device=cuda))
    eng.sweep(s, torch.full((128,), 0.5, device=cuda), gen)
    eng.SINGLE_VMEM_SPIN_BYTES = eng.n_sorted * 128 * 4  # R=256 no longer fits
    s = eng.to_layout(torch.ones(256, ell.n_padded, device=cuda))
    eng.sweep(s, torch.full((256,), 0.5, device=cuda), gen)
    torch.cuda.synchronize()
    assert eng.launches == {"sparse_sweep": 1, "sparse_thresholds": 1,
                            "sparse_accept": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("flags,r,rule,block", [
    (flags, r, rule, block)
    for flags in (dict(pipelined=True), dict(interleave=2),
                  dict(interleave=4), dict(folded=True))
    for r, rule, block in ((1, "metropolis", 128), (37, "glauber", 256),
                           (256, "metropolis", 256), (256, "glauber", 128))])
def test_dense_variants_match_twins_and_k1_bitwise(cuda, flags, r, rule, block):
    """K5, K6 and K7 equal their own twins and K1 on +-J, in both
    random-number modes: spins, dE and counts bit for bit."""
    rng = np.random.default_rng(r)
    j = topology.fully_connected(500, dist="binary", seed=3)
    p = IsingProblem.from_dense(j, rng.integers(-8, 9, 500) / 4.0, device=cuda)
    fused = MC.FusedSweep(p, block_size=block, rule=rule, **flags)
    flat = MC.FusedSweep(p, block_size=block, rule=rule)
    s = torch.as_tensor(np.where(rng.random((512, r)) < 0.5, -1.0, 1.0),
                        dtype=torch.float32, device=cuda)
    s[500:] = 1.0
    beta = torch.as_tensor(rng.uniform(0.1, 2.0, r), dtype=torch.float32,
                           device=cuda)
    for k in range(3):
        s_ref, s_k1 = s.clone(), s.clone()
        if k < 2:
            u = torch.rand(512, r, device=cuda)
            _, de, cnt = fused.sweep_with_uniforms(s, beta, u)
        else:
            _, de, cnt = fused(s, beta, 77 + k)
            u = MC.philox_uniforms(77 + k, 512, r, device=cuda)
        _, de_p, cnt_p = fused.reference(s_ref, beta, u)
        _, de_1, cnt_1 = flat.sweep_with_uniforms(s_k1, beta, u)
        torch.cuda.synchronize()
        assert torch.equal(s, s_ref) and torch.equal(cnt, cnt_p)
        assert torch.equal(de, de_p)
        assert torch.equal(s, s_k1) and torch.equal(cnt, cnt_1)
        assert torch.equal(de, de_1)
    assert fused.launches == 3


@pytest.mark.gpu
@pytest.mark.parametrize("spin_dtype,r", [(torch.int8, 128),
                                          (torch.float32, 256)])
def test_fused_accept_matches_twin_and_threshold_path(cuda, spin_dtype, r):
    """K4 on one colour equals its twin; a whole K4-path sweep equals the
    per-colour sweep on K3's thresholds for the same seed, bit for bit."""
    ell = _pm_j_ell(500, 5, cuda)
    eng = S.SortedSparseTEngine(ell, accept_kernel="fused",
                                spin_dtype=spin_dtype)
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
    assert eng.launches["sparse_accept"] == 1 + len(eng.groups)
