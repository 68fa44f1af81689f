"""The Hopper redesign of K1 and K2, as far as the CPU can hold it: the exact
bf16 split of J and the plane-summed field twin, the ``j_dtype="bfloat16"``
mode against the JAX package, the two tile rules with their shared-memory
envelopes, K2's slot-ordered twin, the wrappers' argument checks and the
default device of the public constructors.

Same numpy inputs to both packages; +-J couplings with h on a quarter grid
make flips compare bit for bit. The CUDA kernels themselves run only on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

from spinglass_tpu.core import topology as jax_topology  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.kernels import metropolis_pallas as JMP  # noqa: E402
from spinglass_tpu.kernels import sweeps as JK  # noqa: E402
from spinglass_tpu_torch.anneal import engines, pt, sa  # noqa: E402
from spinglass_tpu_torch.core import convert, topology  # noqa: E402
from spinglass_tpu_torch.core.convert import problem_from_numpy  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.core.problem import (  # noqa: E402
    IsingProblem, resolve_device)
from spinglass_tpu_torch.kernels import metropolis_cuda as MC  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402
from spinglass_tpu_torch.kernels import sparse_cuda as SC  # noqa: E402

N = 200  # Np = 256


def _couplings(kind: str, n: int = N, seed: int = 1) -> np.ndarray:
    if kind == "pm_j":
        return jax_topology.fully_connected(n, dist="binary", seed=seed)
    j = jax_topology.fully_connected(n, dist="gaussian", scale=0.07, seed=seed)
    if kind == "dyadic":  # multiples of 1/8 up to +-2: exact in bfloat16
        j = np.round(np.clip(j * 30, -2, 2) * 8) / 8
    return j


def _pair(kind: str, n: int = N, seed: int = 1):
    """The same instance in both packages; h on a quarter grid."""
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    ref = JaxProblem.from_dense(_couplings(kind, n, seed), h)
    ours = problem_from_numpy(np.asarray(ref.j), np.asarray(ref.h),
                              np.asarray(ref.active_mask), ref.n_spins,
                              device="cpu")
    return ref, ours


def _rounded(ref: JaxProblem) -> JaxProblem:
    """The JAX problem on J rounded once to bfloat16, as FusedSweep's
    ``problem.j.astype(bfloat16)`` sees it."""
    return dataclasses.replace(
        ref, j=ref.j.astype(jnp.bfloat16).astype(jnp.float32))


def _state(n_pad: int, n: int, r: int, seed: int):
    rng = np.random.default_rng(seed + 100)
    s = np.where(rng.random((r, n_pad)) < 0.5, -1.0, 1.0)
    s[:, n:] = 1.0
    u = rng.uniform(0.0, 0.999999, (r, n_pad))
    beta = rng.uniform(0.1, 2.0, r)
    return s.astype(np.float32), u.astype(np.float32), beta.astype(np.float32)


# ---- the exact split of J and the plane-summed fields ----------------------

@pytest.mark.parametrize("kind,planes", [("gaussian", 3), ("pm_j", 1),
                                         ("dyadic", 1)])
def test_bf16_planes_add_back_bit_for_bit(kind, planes):
    _, ours = _pair(kind)
    hi, mid, lo = MC.bf16_planes(ours.j)
    assert torch.equal(hi + mid + lo, ours.j)
    for plane in (hi, mid, lo):  # each plane is a bfloat16 value
        assert torch.equal(plane.bfloat16().float(), plane)
    assert MC.planes_needed(ours.j) == planes
    zero_rest = bool((mid == 0).all() and (lo == 0).all())
    assert zero_rest == (planes == 1)
    # J rounded to bfloat16 needs one plane, whatever it was
    assert MC.planes_needed(ours.j.bfloat16().float()) == 1


@pytest.mark.parametrize("kind", ["gaussian", "pm_j", "dyadic"])
def test_plane_fields_match_matmul(kind):
    _, ours = _pair(kind, seed=3)
    s, _, _ = _state(ours.n_padded, N, 16, 3)
    s_t = torch.as_tensor(s.T.copy())
    want = torch.matmul(ours.j, s_t)
    got = MC.plane_fields(ours.j, s_t)
    if kind == "gaussian":  # only the order of the float32 sums differs
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-6 * scale
    else:
        assert torch.equal(got, want)
        assert torch.equal(MC.plane_fields(ours.j, s_t, planes=1), want)
    one = MC.plane_fields(ours.j, s_t, planes=1)
    assert torch.equal(one, torch.matmul(ours.j.bfloat16().float(), s_t))


# ---- j_dtype="bfloat16" against the JAX package ----------------------------

@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("block", [128, 256])
def test_bf16_fused_sweep_matches_jax_blocked_sweep_pm_j(rule, block):
    """+-J is exact in bfloat16: the bf16 mode's twin makes the decisions of
    the JAX blocked sweep on the rounded J, bit for bit."""
    ref, ours = _pair("pm_j", seed=2)
    s, u, beta = _state(ref.n_padded, N, 6, 2)
    theirs = JK.blocked_sweep(_rounded(ref), jnp.asarray(s), jnp.asarray(beta),
                              jnp.asarray(u), block_size=128, rule=rule)
    fused = MC.FusedSweep(ours, block_size=block, rule=rule,
                          j_dtype="bfloat16")
    assert fused.planes == 1 and torch.equal(fused.j, ours.j)
    s_t = torch.as_tensor(s.T.copy())
    before = build.launch_snapshot()
    out = fused.sweep_with_uniforms(s_t, torch.as_tensor(beta),
                                    torch.as_tensor(u.T.copy()))
    assert out[0] is s_t and build.launches_since(before) == {}
    np.testing.assert_array_equal(out[0].t().numpy(), np.asarray(theirs[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(theirs[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(theirs[2]))


def test_bf16_fused_sweep_matches_jax_on_gaussian():
    """Gaussian J really is rounded: against the JAX blocked sweep on the
    rounded J the counts agree within 0.5% and E0 + dE == E1 on the rounded
    couplings within 1e-4 relative (only the order of float32 sums differs);
    against the float32 sweep the decisions differ."""
    ref, ours = _pair("gaussian", seed=4)
    r = 32
    s, u, beta = _state(ref.n_padded, N, r, 4)
    rref = _rounded(ref)
    theirs = JK.blocked_sweep(rref, jnp.asarray(s), jnp.asarray(beta),
                              jnp.asarray(u), block_size=128, rule="metropolis")
    fused = MC.FusedSweep(ours, block_size=128, j_dtype="bfloat16")
    assert not torch.equal(fused.j, ours.j)
    np.testing.assert_array_equal(fused.j.numpy(), np.asarray(rref.j))
    s_t = torch.as_tensor(s.T.copy())
    _, de, cnt = fused.sweep_with_uniforms(s_t, torch.as_tensor(beta),
                                           torch.as_tensor(u.T.copy()))
    total, want = int(cnt.sum()), int(np.asarray(theirs[2]).sum())
    assert abs(total - want) <= 0.005 * want
    jr, hd = fused.j.double(), ours.h.double()

    def energy(x):  # [Np, R] on the rounded couplings
        x = x.double()
        return -0.5 * (x * (jr @ x)).sum(0) - (hd[:, None] * x).sum(0)

    e0, e1 = energy(torch.as_tensor(s.T.copy())), energy(s_t)
    rel = ((e0 + de.double() - e1).abs() / e1.abs().clamp(min=1.0)).max()
    assert float(rel) <= 1e-4
    plain = MC.FusedSweep(ours, block_size=128)
    s_f = torch.as_tensor(s.T.copy())
    plain.sweep_with_uniforms(s_f, torch.as_tensor(beta),
                              torch.as_tensor(u.T.copy()))
    assert not torch.equal(s_f, s_t)


def test_bf16_fused_sweep_matches_jax_pallas_interpret():
    """One small case through the JAX kernel itself in interpret mode,
    ``FusedSweep(j_dtype=bfloat16)``: bitwise on +-J."""
    ref, ours = _pair("pm_j", n=100, seed=5)   # Np = 128
    s, u, beta = _state(ref.n_padded, 100, 8, 5)
    jfused = JMP.FusedSweep(ref, block_size=128, interpret=True,
                            j_dtype=jnp.bfloat16)
    theirs = jfused.sweep_with_uniforms(jnp.asarray(s.T.copy()),
                                        jnp.asarray(beta),
                                        jnp.asarray(u.T.copy()))
    fused = MC.FusedSweep(ours, block_size=128, j_dtype="bfloat16")
    s_t = torch.as_tensor(s.T.copy())
    out = fused.sweep_with_uniforms(s_t, torch.as_tensor(beta),
                                    torch.as_tensor(u.T.copy()))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(theirs[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(theirs[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(theirs[2]))


@pytest.mark.parametrize("kind", ["pm_j", "gaussian"])
def test_bf16_engine_in_sa_run_chunk(kind):
    """``SAConfig(j_dtype="bfloat16")`` reaches the fused engine through
    ``make_engine``; on +-J the annealing state equals the float32 run's bit
    for bit (the rounding is the identity), on Gaussian J it sweeps on the
    rounded couplings and resyncs the energy on the true ones."""
    _, ours = _pair(kind, seed=6)
    out = {}
    for jd in ("float32", "bfloat16"):
        cfg = sa.SAConfig(n_sweeps=4, n_replicas=8, j_dtype=jd, seed=3,
                          use_kernel="never")
        eng = engines.CudaFusedEngine(ours, block_size=cfg.block_size,
                                      rule=cfg.update_rule, j_dtype=jd)
        assert eng.fused.j_dtype == jd
        before = build.launch_snapshot()
        state = sa.init_state(ours, cfg, eng)
        state, _ = sa.run_chunk(ours, cfg, eng, state, 4)
        out[jd] = state
        assert build.launches_since(before, eng.kernel_names) == {
            MC.KERNEL_NAME: 0}
    same = torch.equal(out["float32"].spins, out["bfloat16"].spins)
    assert same == (kind == "pm_j")
    assert bool(torch.isfinite(out["bfloat16"].energy).all())
    # the resynced energy is the true problem's, not the rounded one's
    from spinglass_tpu_torch.core.energy import energy_t
    assert torch.equal(out["bfloat16"].energy,
                       energy_t(ours, out["bfloat16"].spins))


def test_bf16_through_configs_and_make_engine():
    _, ours = _pair("gaussian", n=60, seed=7)
    res = sa.anneal(ours, sa.SAConfig(n_sweeps=6, n_replicas=4,
                                      j_dtype="bfloat16"))
    assert res.n_sweeps == 6 and np.isfinite(res.best_energy)
    res = pt.run(ours, pt.PTConfig(n_replicas=4, n_sweeps=10,
                                   j_dtype="bfloat16"))
    assert res.n_sweeps == 10 and np.isfinite(res.best_energy)
    # on the CPU make_engine keeps the plain blocked sweep, in float32, as
    # the JAX package's BlockedXLAEngine ignores j_dtype
    eng = engines.make_engine(ours, sweep_method="blocked",
                              j_dtype="bfloat16")
    assert isinstance(eng, engines.BlockedEngine)
    for bad in (lambda: sa.SAConfig(j_dtype="float16"),
                lambda: pt.PTConfig(j_dtype="float64"),
                lambda: engines.make_engine(ours, j_dtype="bf16"),
                lambda: MC.FusedSweep(ours, j_dtype="half")):
        with pytest.raises(ValueError, match="j_dtype"):
            bad()


# ---- the tile rules and their shared-memory envelopes -----------------------

@pytest.mark.parametrize("n_pad,block,want", [
    (128, 128, MC.CLUSTER_TILE), (512, 256, MC.CLUSTER_TILE),
    (4096, 128, MC.CLUSTER_TILE), (4096, 256, MC.CLUSTER_TILE),
    (8320, 128, MC.CLUSTER_TILE), (8448, 128, MC.BLOCK_TILE),
    (4224, 256, MC.CLUSTER_TILE), (4352, 256, MC.BLOCK_TILE),
    (16384, 128, MC.BLOCK_TILE),
])
def test_dense_tile_rule(n_pad, block, want):
    assert MC.dense_tile(n_pad, block) == want
    fits = MC.cluster_smem_bytes(n_pad, block) <= MC.SMEM_PER_BLOCK
    assert fits == (want == MC.CLUSTER_TILE)
    if n_pad % block == 0:
        p = IsingProblem(j=torch.zeros(n_pad, 1), h=torch.zeros(n_pad),
                         active_mask=torch.ones(n_pad), n_spins=n_pad)
        # FusedSweep reads only the shape here: J's last dimension
        p = dataclasses.replace(p, j=torch.zeros(1, n_pad))
        assert MC.FusedSweep(p, block_size=block).tile == want


def test_cluster_smem_layout():
    """The bytes ``csrc/metropolis_sweep.cu`` lays out at the main shape:
    72 columns x (256 + 8) words of bf16 spins, 72 x B partial fields, two
    buffers of 32 J rows, B x 9 fields."""
    assert MC.CLUSTER_TILE == (72, 8) and MC.BLOCK_TILE == (8, 1)
    assert MC.cluster_smem_bytes(4096, 128) == (
        72 * 264 * 4 + 72 * 128 * 4 + 2 * 32 * 128 * 4 + 128 * 9 * 4)
    assert MC.cluster_smem_bytes(4096, 256) == 224512
    # the column stride is 8 mod 32 words at every n_pad
    for n_pad in range(128, 8448, 128):
        words = n_pad // 16
        stride = words + (40 - words % 32) % 32
        assert stride % 32 == 8 and 0 <= stride - words < 32


@pytest.mark.parametrize("r,ns,want", [
    (128, 10240, 1), (256, 10240, 2), (1024, 10240, 8), (4096, 10240, 8),
    (37, 256, 1),
    (1024, 28672, 8), (1024, 28928, 4),
    (1024, 114688, 2), (1024, 114944, 1),
    (128, 229376, 1), (128, 229632, None), (1024, 229632, None),
])
def test_sparse_default_tile_rule(r, ns, want):
    """The tile's int8 spins fit the block's shared memory, or the rule
    raises: nothing gathers from device memory."""
    if want is None:
        assert ns > SC.TILE_SMEM_BYTES
        with pytest.raises(ValueError, match="shared memory"):
            SC.default_tile(r, ns)
        return
    tile = SC.default_tile(r, ns)
    assert tile == want and tile in (1, 2, 4, 8)
    assert ns * tile <= SC.TILE_SMEM_BYTES
    # the sparse engine's 80 MiB rule keeps every K2 shape inside the envelope
    assert (S.SortedSparseTEngine.SINGLE_VMEM_SPIN_BYTES // (128 * 4)
            <= SC.TILE_SMEM_BYTES)


# ---- K2's slot-ordered twin ------------------------------------------------

@pytest.mark.parametrize("dist", ["binary", "gaussian"])
def test_single_sweep_ordered_matches_reference(dist):
    coo = topology.sparse_random_graph_coo(300, avg_degree=5.0, dist=dist,
                                           seed=8)
    h = np.random.default_rng(8).integers(-8, 9, 300) / 4.0
    ell = S.EllProblem.from_coo(300, *coo, h=h, device="cpu")
    eng = S.SortedSparseTEngine(ell, accept_kernel="single")
    r = 16
    s, _, beta = _state(ell.n_padded, 300, r, 8)
    s0 = eng.to_layout(torch.as_tensor(s))
    th = SC.thresholds_reference(eng.mask_col, torch.as_tensor(beta), 11, r,
                                 "metropolis")
    a, de_a, c_a = SC.single_sweep_reference(eng.groups, s0.clone(), th)
    k = eng.kernels
    b, de_b, c_b = SC.single_sweep_ordered(k.tables, k.span_list, s0.clone(),
                                           th)
    assert k.span_list[0] == 0 and k.span_list[-1] <= eng.n_sorted
    assert int(c_a.sum()) > 0
    if dist == "binary":   # exact fields: any order gives the same bits
        assert torch.equal(a, b) and torch.equal(de_a, de_b)
        assert torch.equal(c_a, c_b)
    else:                  # the order of a row's sum may move the last bit
        assert float((a != b).float().mean()) <= 1e-3
        assert abs(int(c_a.sum()) - int(c_b.sum())) <= 0.005 * int(c_a.sum())


def test_sparse_kernels_argument_checks():
    coo = topology.sparse_random_graph_coo(100, seed=9)
    ell = S.EllProblem.from_coo(100, *coo, device="cpu")
    before = build.launch_snapshot()
    eng = S.SortedSparseTEngine(ell, accept_kernel="single")
    k = eng.kernels
    assert build.launches_since(before, [SC.SWEEP_KERNEL]) == {
        SC.SWEEP_KERNEL: 0}
    assert k._idx_t.shape == k.tables["idx"].t().shape
    assert k._idx_t.is_contiguous() and k._val_t.is_contiguous()
    assert torch.equal(k._val_t.t(), k.tables["val"])
    s = torch.ones(eng.n_sorted, 4)
    with pytest.raises(ValueError, match="exactly one"):
        k.single_sweep(s, 1.0)
    with pytest.raises(ValueError, match="exactly one"):
        k.single_sweep(s, 1.0, seed=1, th=torch.zeros_like(s))
    bare = SC.SparseKernels(eng.mask_col, "metropolis")
    with pytest.raises(ValueError, match="tables"):
        bare.single_sweep(s, 1.0, seed=1)
    gapped = [eng.groups[0], (eng.groups[-1][0] + 8,) + eng.groups[-1][1:]]
    with pytest.raises(ValueError, match="contiguous"):
        SC.SparseKernels(eng.mask_col, "metropolis", gapped, k.tables)


# ---- the card is the default device ----------------------------------------

def test_default_device_is_the_card_and_cpu_must_be_asked_for():
    """Here there is no card: the default raises, naming device="cpu", and
    device="cpu" builds on the CPU. Nothing carries on on the CPU by itself."""
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda")
        return
    j = topology.fully_connected(12, dist="binary", seed=1)
    coo = topology.sparse_random_graph_coo(60, seed=2)
    terms = dataclasses.make_dataclass("T", ["quad_i", "quad_j", "quad_v",
                                             "lin_i", "lin_v"])(
        [0, 1], [1, 2], [1.0, -1.0], [0], [0.5])
    constructors = (
        lambda **kw: IsingProblem.from_dense(j, **kw),
        lambda **kw: IsingProblem.from_terms(3, [0, 1], [1, 2], [1.0, -1.0],
                                             **kw),
        lambda **kw: IsingProblem.from_dict({"j": j, "h": np.zeros(12)}, **kw),
        lambda **kw: S.EllProblem.from_coo(60, *coo, **kw),
        lambda **kw: S.ell_from_terms(3, terms, **kw),
        lambda **kw: convert.problem_from_numpy(j, np.zeros(12), np.ones(12),
                                                12, **kw),
        lambda **kw: convert.ell_from_numpy([[1], [0]], [[1.0], [1.0]],
                                            [0, 0], [1, 1], 2, **kw),
    )
    for make in constructors:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
        assert make(device="cpu").device == torch.device("cpu")
    e, s_rn = np.zeros(2), np.ones((2, 12))
    states = (
        lambda **kw: convert.sa_state_from_numpy(s_rn, e, e, s_rn, 1.0, 0.4,
                                                 0, **kw),
        lambda **kw: convert.pt_state_from_numpy(s_rn, [0, 1], e, e, s_rn, 0,
                                                 [0], [0], **kw),
    )
    for make in states:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
        assert make(device="cpu").spins.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_load_takes_a_device(tmp_path):
    p = IsingProblem.from_dense(_couplings("pm_j", 10), device="cpu")
    p.save(str(tmp_path / "p.npz"))
    q = IsingProblem.load(str(tmp_path / "p.npz"), device="cpu")
    assert torch.equal(p.j, q.j) and q.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            IsingProblem.load(str(tmp_path / "p.npz"))


def test_kernel_turns_refuses_a_parent_outside_the_checkout(tmp_path, capsys):
    """The turns script builds the parent's kernels inside the parent's
    tree, so it takes only a parent unpacked inside this checkout."""
    from spinglass_tpu_torch.benchmarks import kernel_turns

    (tmp_path / "spinglass_tpu_torch").mkdir()
    assert kernel_turns.main([str(tmp_path)]) == 2
    assert "must lie inside" in capsys.readouterr().err
    assert kernel_turns.main([]) == 2


def test_kernel_turns_rounds_and_summary(tmp_path, capsys):
    """``--rounds N`` repeats parent, change, change, parent N times (a
    count below 1 is refused); the summary gives two turns as "a / b" and
    more as their median and quartiles."""
    from spinglass_tpu_torch.benchmarks import kernel_turns

    (tmp_path / "spinglass_tpu_torch").mkdir()
    assert kernel_turns.main([str(tmp_path), "--rounds", "0"]) == 2
    assert kernel_turns.main([str(tmp_path), "--rounds"]) == 2
    capsys.readouterr()
    assert kernel_turns._times([780.04, 790.0]) == "780.0 / 790.0"
    assert kernel_turns._times([1.0, 2.0, 3.0, 4.0, 5.0]) == (
        "median 3.0 (quartiles 1.5-4.5, 5 turns)")


_SASS = """
	code for sm_90a
		Function : _ZN52_GLOBAL__N__18b40ee5_19_metropolis_sweep_cu_7415b53920cluster_sweep_kernelILi128EEEvv
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                  /* 0x00000a0000017a02 */
                                                                           /* 0x000fe40000000f00 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
        /*0020*/                   EXIT ;                                  /* 0x000000000000794d */
		..........
		Function : _Z4tinyv
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
"""


def test_sass_diff_reads_functions_and_spills():
    """sass_diff.py parses cuobjdump's functions (addresses, encodings and
    the anonymous namespace's per-file tag removed) and ptxas's spill
    bytes, and counts the lines one side lacks."""
    from spinglass_tpu_torch.benchmarks import sass_diff as SD

    fns = SD.sass_functions(_SASS)
    key = "_ZN52_GLOBAL__N_20cluster_sweep_kernelILi128EEEvv"
    assert list(fns) == [key, "_Z4tinyv"]
    assert fns[key] == ['.headerflags @"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"',
                        "MOV R1, c[0x0][0x28] ;", "S2R R0, SR_TID.X ;",
                        "EXIT ;", ".........."]
    other = SD.sass_functions(_SASS.replace("18b40ee5", "0badf00d")
                              .replace("7415b539", "01234567"))
    assert other == fns
    ptxas = ("ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__"
             "18b40ee5_19_metropolis_sweep_cu_7415b53920cluster_sweep_"
             "kernelILi128EEEvv' for 'sm_90a'\nptxas info    : Function "
             "properties for x\n    8 bytes stack frame, 4 bytes spill "
             "stores, 12 bytes spill loads\n")
    assert SD.ptxas_spills(ptxas) == {key: (4, 12)}
    assert SD.lacking(["a", "b", "b"], ["b", "c"]) == 2
    assert SD.lacking(["b"], ["b", "c"]) == 0


def test_sass_diff_refuses_a_parent_outside_the_checkout(tmp_path, capsys):
    """As kernel_turns.py: the parent's build stays inside this checkout."""
    from spinglass_tpu_torch.benchmarks import sass_diff as SD

    (tmp_path / "spinglass_tpu_torch").mkdir()
    assert SD.main([str(tmp_path)]) == 2
    assert "must lie inside" in capsys.readouterr().err
    assert SD.main([]) == 2
