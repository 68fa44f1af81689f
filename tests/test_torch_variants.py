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
from spinglass_tpu_torch.core.convert import problem_from_numpy  # noqa: E402
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
