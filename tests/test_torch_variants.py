"""Port parity for K1's variants K5 (pipelined), K6 (interleaved) and K7
(folded): the block operands, the plain twins and ``FusedSweep``'s variant
flags, against the JAX package's XLA blocked sweep, its float64 sequential
oracle and its ``FusedSweep`` validation, under shared uniforms.

+-J couplings with h on a quarter grid make every field exact in float32
whatever the summation order, so flip decisions and counts must be equal
bit for bit; dE is held to 1e-5 (the oracle sums in float64). Uniforms are
drawn below 0.999999, where the twins' Glauber clamp and the unclamped JAX
threshold agree. The JAX side runs its XLA reference, not Pallas interpret
mode.
"""

import contextlib
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.core import topology as jax_topology  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.kernels import metropolis_pallas as JMP  # noqa: E402
from spinglass_tpu.kernels import sweeps as JK  # noqa: E402
from spinglass_tpu_torch.anneal import sa  # noqa: E402
from spinglass_tpu_torch.anneal.engines import CudaFusedEngine  # noqa: E402
from spinglass_tpu_torch.benchmarks import variant_parts as VP  # noqa: E402
from spinglass_tpu_torch.core.convert import problem_from_numpy  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.kernels import metropolis_cuda as MC  # noqa: E402

U_MAX = 0.999999
N = 200
# variant -> (twin, keyword arguments, FusedSweep flags, kernel name)
VARIANTS = {
    "pipelined": (MC.pipelined_sweep_reference, {}, dict(pipelined=True),
                  MC.PIPELINED_KERNEL),
    "interleave2": (MC.interleaved_sweep_reference, dict(nchains=2),
                    dict(interleave=2), MC.INTERLEAVED_KERNEL),
    "interleave4": (MC.interleaved_sweep_reference, dict(nchains=4),
                    dict(interleave=4), MC.INTERLEAVED_KERNEL),
    "folded_micro8": (MC.folded_sweep_reference, dict(micro=8),
                      dict(folded=True, micro=8), MC.FOLDED_KERNEL),
    "folded_micro32": (MC.folded_sweep_reference, dict(micro=32),
                       dict(folded=True), MC.FOLDED_KERNEL),
}


def _pm_j(n=N, seed=1):
    j = jax_topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    ref = JaxProblem.from_dense(j, h)
    ours = problem_from_numpy(np.asarray(ref.j), np.asarray(ref.h),
                              np.asarray(ref.active_mask), ref.n_spins,
                              device="cpu")
    return ref, ours


def _state(ref, r, seed):
    rng = np.random.default_rng(seed + 100)
    s = np.where(rng.random((r, ref.n_padded)) < 0.5, -1.0, 1.0)
    s[:, ref.n_spins:] = 1.0
    u = rng.uniform(0.0, U_MAX, (r, ref.n_padded))
    beta = rng.uniform(0.1, 2.0, r)
    return s.astype(np.float32), u.astype(np.float32), beta.astype(np.float32)


def _run_twin(variant, ours, s, u, beta, rule, block):
    twin, kw, _, _ = VARIANTS[variant]
    s_t = torch.as_tensor(s.T.copy())
    out = twin(ours.j, ours.h, ours.active_mask, s_t, torch.as_tensor(beta),
               torch.as_tensor(u.T.copy()), rule, block, **kw)
    assert out[0] is s_t  # updated in place, like the kernels
    return out[0].t(), out[1], out[2]


@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("micro", [8, 32])
def test_block_operands_match_jax(block, micro):
    ref, ours = _pm_j(seed=3)
    jbb = JMP._diag_blocks(ref.j, block)
    np.testing.assert_array_equal(MC.diag_blocks(ours.j, block).numpy(),
                                  np.asarray(jbb))
    np.testing.assert_array_equal(MC.sub_diag_blocks(ours.j, block).numpy(),
                                  np.asarray(JMP._sub_diag_blocks(ref.j, block)))
    np.testing.assert_array_equal(
        MC.zero_micro_diag(MC.diag_blocks(ours.j, block), block, micro).numpy(),
        np.asarray(JMP._zero_micro_diag(jbb, block, micro)))
    assert not MC.sub_diag_blocks(ours.j, block)[:block].any()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("block", [32, 64])
def test_variant_twin_matches_jax_blocked_sweep(variant, rule, block):
    """Each variant's twin makes the JAX blocked sweep's decisions, with
    per-replica beta and padding rows (N=200 pads to 256)."""
    ref, ours = _pm_j()
    s, u, beta = _state(ref, 7, 2)
    theirs = JK.blocked_sweep(ref, jnp.asarray(s), jnp.asarray(beta),
                              jnp.asarray(u), block_size=128, rule=rule)
    mine = _run_twin(variant, ours, s, u, beta, rule, block)
    np.testing.assert_array_equal(mine[0].numpy(), np.asarray(theirs[0]))
    np.testing.assert_array_equal(mine[2].numpy(), np.asarray(theirs[2]))
    np.testing.assert_allclose(mine[1].numpy(), np.asarray(theirs[1]),
                               rtol=1e-5, atol=1e-5)
    assert bool((mine[0][:, N:] == 1.0).all()) and int(mine[2].sum()) > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_twin_matches_sequential_oracle(variant):
    """Each replica equals the float64 one-spin-at-a-time sweep."""
    ref, ours = _pm_j(seed=4)
    s, u, beta = _state(ref, 3, 4)
    rule = "glauber" if variant.startswith("interleave") else "metropolis"
    out, de, cnt = _run_twin(variant, ours, s, u, beta, rule, 64)
    jn, hn = np.asarray(ref.j), np.asarray(ref.h)
    for r in range(3):
        uu = np.where(np.asarray(ref.active_mask) > 0, u[r], 2.0)
        s_ref, de_ref, cnt_ref = JK.sequential_sweep_oracle(
            jn, hn, s[r], float(beta[r]), uu, rule)
        np.testing.assert_array_equal(out[r].numpy(), s_ref)
        assert int(cnt[r]) == cnt_ref
        assert float(de[r]) == pytest.approx(de_ref, rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_sweep_variant_on_cpu_runs_its_twin(variant, monkeypatch):
    """FusedSweep with a variant flag, on CPU tensors: the variant's twin on
    the kernels' Philox stream, no compiler, no launch; its decisions are
    K1's."""
    monkeypatch.setattr(build, "build_many", lambda *a, **k: pytest.fail(
        "a CPU sweep must not build a kernel"))
    twin, kw, flags, name = VARIANTS[variant]
    ref, ours = _pm_j(seed=5)
    s0 = torch.as_tensor(_state(ref, 9, 5)[0].T.copy())
    beta = torch.linspace(0.2, 2.0, 9)
    fused = MC.FusedSweep(ours, block_size=128, **flags)
    assert fused.kernel_name == name
    s1, s2, s3 = s0.clone(), s0.clone(), s0.clone()
    _, de1, c1 = fused(s1, beta, 2 ** 41 + 3)
    u = MC.philox_uniforms(2 ** 41 + 3, ours.n_padded, 9)
    _, de2, c2 = twin(ours.j, ours.h, ours.active_mask, s2, beta, u,
                      "metropolis", 128, **kw)
    _, de3, c3 = MC.FusedSweep(ours, block_size=128)(s3, beta, 2 ** 41 + 3)
    assert torch.equal(s1, s2) and torch.equal(c1, c2) and torch.equal(de1, de2)
    assert torch.equal(s1, s3) and torch.equal(c1, c3)
    assert fused.launches == 0 and fused._lib is None and int(c1.sum()) > 0


def test_variant_validation_matches_jax():
    """Combinations that cannot go together raise as in the JAX package;
    flags the kernels cannot honour raise and never run K1."""
    ref, ours = _pm_j(n=48, seed=6)
    for kw, words in ((dict(interleave=2, folded=True), "combine"),
                      (dict(interleave=4, pipelined=True), "combine"),
                      (dict(pipelined=True, folded=True), "combine")):
        with pytest.raises(ValueError, match=words):
            JMP.FusedSweep(ref, **kw)
        with pytest.raises(ValueError, match=words):
            MC.FusedSweep(ours, **kw)
    with pytest.raises(ValueError, match="interleave"):
        MC.FusedSweep(ours, interleave=3)
    with pytest.raises(ValueError, match="micro"):
        MC.FusedSweep(ours, folded=True, micro=48)
    for interleave in (0, 1):  # the flat kernel, as in the JAX package
        assert MC.FusedSweep(ours, interleave=interleave).kernel_name == \
            MC.KERNEL_NAME
    # the folded CUDA kernel is built for micro=32: any other micro raises
    # before a build, never running another kernel
    fused = MC.FusedSweep(ours, folded=True, micro=16)
    s = torch.ones(ours.n_padded, 4)
    with pytest.raises(ValueError, match="micro=32"):
        fused._launch(s, torch.ones(4), None, 1)
    assert fused._lib is None and fused.launches == 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_engine_in_sa_driver_matches_flat(variant):
    """The slice on the CPU: sa.run_chunk through CudaFusedEngine with a
    variant equals the same driver through the flat engine, bit for bit
    (the seeds per sweep are the driver's); each engine reports its own
    kernel name."""
    _, ours = _pm_j(seed=7)
    flags = VARIANTS[variant][2]
    cfg = sa.SAConfig(n_sweeps=6, n_replicas=8, block_size=128)
    states = []
    for eng in (CudaFusedEngine(ours, block_size=128, **flags),
                CudaFusedEngine(ours, block_size=128)):
        st = sa.init_state(ours, cfg, eng)
        st, _ = sa.run_chunk(ours, cfg, eng, st, 3)
        states.append(st)
        assert eng.launches == {eng.fused.kernel_name: 0}
    a, b = states
    for k in ("spins", "energy", "best_energy", "best_spins", "acc_rate"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a.sched.temp, b.sched.temp)


# ---- the cluster kernels of K5 and K7: shape rule, launch arguments, bound --

# kernel -> (tile rule, shared-memory function, one-block tile)
CLUSTER_VARIANTS = {
    MC.KERNEL_NAME: (MC.dense_tile, MC.cluster_smem_bytes, MC.BLOCK_TILE),
    MC.PIPELINED_KERNEL: (MC.pipelined_tile, MC.pipelined_smem_bytes,
                          MC.PIPELINED_BLOCK_TILE),
    MC.FOLDED_KERNEL: (MC.folded_tile, MC.folded_smem_bytes,
                       MC.FOLDED_BLOCK_TILE),
}


def _spin_bytes(n_pad):
    """72 columns of n_pad / 8 bf16 spins, each padded to 8 mod 32 words."""
    words = n_pad // 16
    return 72 * (words + (40 - words % 32) % 32) * 4


@pytest.mark.parametrize("block", [128, 256])
def test_variant_smem_layouts(block):
    """The bytes each cluster kernel lays out (csrc/metropolis_*.cu): K1's
    spins, partials, two buffers of 32 J rows and the fields; K5's J rows
    (32 a stage at 128, 16 at 256) and the repair's ds operand (16 columns
    of block / 2 words, padded to 8 mod 32); K7's diagonal micro-blocks,
    fields, spins and thresholds, and its ds operand (16 x 20 words)."""
    for n_pad in (512, 4096, 6784):
        spins, part = _spin_bytes(n_pad), 72 * block * 4
        assert MC.cluster_smem_bytes(n_pad, block) == (
            spins + part + 2 * 32 * block * 4 + block * 9 * 4)
        # J rows B wide, 32 a stage at 128 and 16 at 256, and the ds
        # operand: 16 columns of 64 + 8 words at 128, 128 + 8 at 256
        rows, ds_words = (32, 72) if block == 128 else (16, 136)
        assert MC.pipelined_smem_bytes(n_pad, block) == (
            spins + part + block * 9 * 4 + 2 * rows * block * 4
            + 16 * ds_words * 4)
        assert MC.folded_smem_bytes(n_pad, block) == (
            spins + part + 32 * block * 4 + 3 * block * 9 * 4 + 16 * 20 * 4)
    # K5 needs K1's bytes and the ds operand at block 128, less at 256
    # (16 J rows a stage); K7 less than K1 at both
    assert (MC.pipelined_smem_bytes(4096, 128)
            == MC.cluster_smem_bytes(4096, 128) + 16 * 72 * 4)
    assert MC.pipelined_smem_bytes(4096, 256) < MC.cluster_smem_bytes(4096,
                                                                      256)
    assert MC.folded_smem_bytes(4096, block) < MC.cluster_smem_bytes(4096,
                                                                     block)


@pytest.mark.parametrize("kernel,block,edge", [
    (MC.KERNEL_NAME, 128, 8320), (MC.KERNEL_NAME, 256, 4096),
    (MC.PIPELINED_KERNEL, 128, 8320), (MC.PIPELINED_KERNEL, 256, 5632),
    (MC.FOLDED_KERNEL, 128, 8832), (MC.FOLDED_KERNEL, 256, 5120)])
def test_variant_envelope(kernel, block, edge):
    """Each kernel's shape rule: the cluster kernel up to the envelope edge
    (a multiple of the block), the one-block float32 kernel one block
    beyond it and at every larger n_pad; the rule is the shared-memory
    arithmetic against a thread block's 232448 bytes, and K1's is
    dense_tile."""
    rule, smem, one_block = CLUSTER_VARIANTS[kernel]
    assert MC.TILE_RULES[kernel] is rule
    assert MC.cluster_envelope(kernel, block) == edge
    assert rule(edge, block) == MC.CLUSTER_TILE
    for n_pad in (edge + block, edge + 4 * block, 16384):
        assert rule(n_pad, block) == one_block
    for n_pad in range(block, edge + 8 * block, block):
        fits = smem(n_pad, block) <= MC.SMEM_PER_BLOCK
        assert (rule(n_pad, block) == MC.CLUSTER_TILE) == fits, n_pad
    if kernel == MC.KERNEL_NAME:
        for n_pad in range(block, edge + 8 * block, block):
            assert rule(n_pad, block) == MC.dense_tile(n_pad, block)


class _FakeLib:
    """A stand-in for a built kernel library: records each entry point's
    arguments and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("sgt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def _shape_problem(n_pad):
    """A problem of n_pad spins whose J is [1, n_pad] zeros: the wrapper
    reads only its shape and its pointer (one bf16 plane)."""
    return IsingProblem(j=torch.zeros(1, n_pad), h=torch.zeros(n_pad),
                        active_mask=torch.ones(n_pad), n_spins=n_pad)


@pytest.mark.parametrize("flags,n_pad,block,want_extra", [
    ({}, 512, 128, [1, 8]),
    ({}, 8448, 128, [1, 1]),
    (dict(pipelined=True), 512, 256, [1, 8]),
    (dict(pipelined=True), 8320, 128, [1, 8]),
    (dict(pipelined=True), 8448, 128, [1, 1]),
    (dict(pipelined=True), 5888, 256, [1, 1]),
    (dict(folded=True), 512, 128, [32, 1, 8]),
    (dict(folded=True), 8832, 128, [32, 1, 8]),
    (dict(folded=True), 8960, 128, [32, 1, 1]),
    (dict(folded=True), 5376, 256, [32, 1, 1]),
    (dict(interleave=4), 512, 128, [4]),
])
def test_launch_arguments_per_variant(monkeypatch, flags, n_pad, block,
                                      want_extra):
    """What the wrapper hands each kernel's entry point, through a stand-in
    for the built library: the shape, the block and the rule, then K1's
    and K5's planes of J and cluster size (8 inside the envelope, 1 beyond
    it), K7's micro, planes and cluster size, K6's chains; one launch
    counted."""
    fake = _FakeLib()
    monkeypatch.setattr(MC, "load_kernel", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    fused = MC.FusedSweep(_shape_problem(n_pad), block_size=block, **flags)
    r = 5
    fused._launch(torch.ones(n_pad, r), torch.ones(r), None, 2 ** 40 + 9)
    (name, args), = fake.calls
    assert name == f"sgt_{fused.kernel_name}"
    # J, h, mask, spins, beta, u, seed, seed_ptr, dE, counts, n_pad, R,
    # block, rule, *extra, stream
    assert args[5] is None and args[6] == 2 ** 40 + 9 and args[7] is None
    assert list(args[10:14]) == [n_pad, r, block, 0]
    assert list(args[14:-1]) == want_extra and args[-1] == 0
    assert fused.launches == 1


@pytest.mark.parametrize("flags", [dict(pipelined=True), dict(folded=True),
                                   {}])
def test_launch_passes_three_planes_for_gaussian_couplings(monkeypatch, flags):
    """J that bf16 cannot hold exactly (a Gaussian glass) goes to every
    cluster kernel as three planes; the bfloat16 mode as one."""
    fake = _FakeLib()
    monkeypatch.setattr(MC, "load_kernel", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    j = np.random.default_rng(3).normal(size=(200, 200)) / 16.0
    ours = IsingProblem.from_dense((j + j.T) / 2, device="cpu")
    for j_dtype, planes in (("float32", 3), ("bfloat16", 1)):
        fused = MC.FusedSweep(ours, block_size=128, j_dtype=j_dtype, **flags)
        fused._launch(torch.ones(ours.n_padded, 3), torch.ones(3), None, 1)
        assert fake.calls[-1][1][-3:-1] == (planes, 8)


@pytest.mark.parametrize("n_pad,r,planes", [(4096, 1024, 3), (4096, 1024, 1),
                                            (512, 256, 3), (8192, 16, 3)])
def test_dense_kernels_share_one_bound(n_pad, r, planes):
    """K1, K5, K6 and K7 compute one function, so one helper gives all four
    the same bound: J once, the spins read and written, and planes x 2
    n_pad^2 r operations on the bf16 tensor cores."""
    bounds = {k: MC.dense_sweep_bound(k, n_pad, r, planes)
              for k in MC.DENSE_KERNELS}
    assert len(set(bounds.values())) == 1
    ms, by = bounds[MC.KERNEL_NAME]
    nbytes = 4 * n_pad ** 2 + 8 * n_pad * r + 8 * n_pad + 12 * r
    ops = planes * 2.0 * n_pad ** 2 * r
    assert ms == pytest.approx(1e3 * max(nbytes / 3.35e12, ops / 989e12))
    assert by == ("operations" if ops / 989e12 > nbytes / 3.35e12
                  else "bytes")
    if (n_pad, r, planes) == (4096, 1024, 3):
        assert 1e3 * ms == pytest.approx(104.2, abs=0.05) and by == "operations"
    with pytest.raises(ValueError, match="dense sweep"):
        MC.dense_sweep_bound("sparse_sweep", n_pad, r, planes)


def _toy_csrc(tmp_path, monkeypatch):
    """A csrc/ of one kernel source and one header, and an empty build
    directory, in place of the package's."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "toy.cu").write_text('#include "toy.cuh"\nint a = 1; int b = 2;'
                                 '\nint c = 2;\n')
    (csrc / "toy.cuh").write_text("int d = 4;\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    return csrc


@pytest.mark.parametrize("edits,want", [
    ([], '#include "toy.cuh"\nint a = 1; int b = 2;\nint c = 2;\n'),
    ([("a = 1", "a = 5")], '#include "toy.cuh"\nint a = 5; int b = 2;'
                           '\nint c = 2;\n'),
    ([("a = 1", "a = 5"), ("int c = 2;\n", "")],
     '#include "toy.cuh"\nint a = 5; int b = 2;\n'),
    ([("= 2", "= 3")], ValueError),  # twice
    ([("e = 5", "e = 6")], ValueError),  # nowhere
    ([("a = 1", "a = 5"), ("a = 1", "a = 6")], ValueError),  # gone
])
def test_variant_parts_edit_the_sources_once(tmp_path, monkeypatch, edits,
                                             want):
    """benchmarks/variant_parts.py applies each part's edits to the kernel's
    source, each matching exactly once (else it stops), copies the rest of
    csrc/ unchanged, and builds into a path under the build directory that
    names the kernel and the part."""
    csrc = _toy_csrc(tmp_path, monkeypatch)
    if want is ValueError:
        with pytest.raises(ValueError, match="toy.cu once"):
            VP.part_source("toy", "a part", edits)
        return
    src, lib = VP.part_source("toy", "a part", edits)
    with open(src) as f:
        assert f.read() == want
    with open(os.path.join(os.path.dirname(src), "toy.cuh")) as f:
        assert f.read() == (csrc / "toy.cuh").read_text()
    assert lib.startswith(str(tmp_path / "build" / "parts" / "toy-a_part-"))
    assert lib.endswith("toy.so")


def test_variant_parts_library_path_follows_the_sources(tmp_path,
                                                        monkeypatch):
    """A part's library path changes with the edited source, with any csrc/
    header and with the nvcc flags, so that a rerun after an edit never
    times a stale build; it stays the same when nothing changed."""
    csrc = _toy_csrc(tmp_path, monkeypatch)
    first = VP.part_source("toy", "p", [("a = 1", "a = 5")])[1]
    assert VP.part_source("toy", "p", [("a = 1", "a = 5")])[1] == first
    assert VP.part_source("toy", "p", [("a = 1", "a = 7")])[1] != first
    (csrc / "toy.cuh").write_text("int d = 5;\n")
    second = VP.part_source("toy", "p", [("a = 1", "a = 5")])[1]
    assert second != first
    monkeypatch.setattr(build, "NVCC_FLAGS", [*build.NVCC_FLAGS, "-G"])
    assert VP.part_source("toy", "p", [("a = 1", "a = 5")])[1] != second


def test_variant_parts_stop_before_building(tmp_path, monkeypatch):
    """An edit that misses stops build_parts before any nvcc starts."""
    _toy_csrc(tmp_path, monkeypatch)
    started = []
    monkeypatch.setattr(VP.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    with pytest.raises(ValueError, match="nowhere"):
        VP.build_parts({"toy": {"fine": [("a = 1", "a = 5")],
                                "nowhere": [("e = 5", "e = 6")]}})
    assert started == []
