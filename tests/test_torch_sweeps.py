"""Port parity: sweeps and the fused kernel's CPU twin against the JAX
package's XLA sweeps and the float64 sequential oracle, under shared
uniforms.

+-J couplings with h on a quarter grid make every field exact in float32
whatever the summation order, so flip decisions, counts and dE must be
equal exactly. Uniforms are drawn below 0.999999, where the twin's Glauber
clamp and the unclamped JAX threshold agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.core import topology as jax_topology  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.kernels import sweeps as JK  # noqa: E402
from spinglass_tpu_torch.core.convert import problem_from_numpy  # noqa: E402
from spinglass_tpu_torch.kernels import metropolis_cuda as MC  # noqa: E402
from spinglass_tpu_torch.kernels import sweeps as K  # noqa: E402

U_MAX = 0.999999


def _pm_j(n, seed, topo="full"):
    rng = np.random.default_rng(seed)
    if topo == "full":
        j = jax_topology.fully_connected(n, dist="binary", seed=seed)
    else:
        side = int(round(np.sqrt(n)))
        j = jax_topology.grid_2d(side, side, dist="binary", seed=seed)
        n = side * side
    h = rng.integers(-8, 9, n) / 4.0
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


def _assert_same(ours, theirs):
    (s1, de1, c1), (s2, de2, c2) = ours, theirs
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s2))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c2))
    np.testing.assert_array_equal(de1.numpy(), np.asarray(de2))


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_accept_threshold_matches_jax(rule):
    rng = np.random.default_rng(0)
    u = rng.uniform(0, U_MAX, (4, 64)).astype(np.float32)
    u[0, :3] = [0.0, 1.0, 2.0]
    beta = rng.uniform(0.1, 3.0, (4, 1)).astype(np.float32)
    ours = K.accept_threshold(torch.as_tensor(u), torch.as_tensor(beta), rule)
    theirs = np.asarray(JK.accept_threshold(u, beta, rule))
    # the two libraries' float32 log/log1p may differ in the last ulp; near
    # u = 1/2 the Glauber difference ln u - ln(1-u) cancels, hence the atol
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=1e-6)
    assert ours[0, 1] == -np.inf and ours[0, 2] == -np.inf
    # the kernel's threshold equals the JAX one below the clamp
    tw = MC.kernel_threshold(torch.as_tensor(u), torch.as_tensor(beta), rule)
    np.testing.assert_array_equal(tw.numpy(), ours.numpy())


def test_accept_prob_and_rules():
    de = np.linspace(-3, 3, 13).astype(np.float32)
    for rule in ("metropolis", "glauber", "heat_bath"):
        np.testing.assert_allclose(
            K.accept_prob(torch.as_tensor(de), 0.7, rule).numpy(),
            np.asarray(JK.accept_prob(de, 0.7, rule)), rtol=1e-6)
    assert K.canonical_rule("heat_bath") == "glauber"
    with pytest.raises(ValueError):
        K.canonical_rule("nope")


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("block_size", [64, 128])
def test_blocked_sweep_matches_jax(rule, block_size):
    ref, ours = _pm_j(100, 1)
    s, u, beta = _state(ref, 5, 1)
    theirs = JK.blocked_sweep(ref, jnp.asarray(s), jnp.asarray(beta),
                              jnp.asarray(u), block_size=block_size, rule=rule)
    mine = K.blocked_sweep(ours, torch.as_tensor(s), torch.as_tensor(beta),
                           torch.as_tensor(u), block_size=block_size, rule=rule)
    _assert_same(mine, theirs)
    assert bool((mine[0][:, 100:] == 1.0).all())  # padding never flips


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("block_size", [128, 256])
def test_fused_twin_matches_jax_blocked_sweep(rule, block_size):
    """The kernel's twin in [Np, R] layout (per-replica beta, padding rows)
    makes the JAX blocked sweep's decisions."""
    ref, ours = _pm_j(200, 2)   # Np = 256
    s, u, beta = _state(ref, 6, 2)
    theirs = JK.blocked_sweep(ref, jnp.asarray(s), jnp.asarray(beta),
                              jnp.asarray(u), block_size=128, rule=rule)
    s_t = torch.as_tensor(s.T.copy())
    out = MC.fused_sweep_reference(ours.j, ours.h, ours.active_mask, s_t,
                                   torch.as_tensor(beta),
                                   torch.as_tensor(u.T.copy()), rule,
                                   block_size)
    assert out[0] is s_t  # updated in place, like the kernel
    _assert_same((out[0].t(), out[1], out[2]), theirs)
    assert bool((out[0][200:] == 1.0).all())


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_blocked_sweep_cuda_wrapper_on_cpu_matches_oracle(rule, monkeypatch):
    """[R, Np] wrapper on CPU tensors runs the twin; each replica equals the
    float64 sequential oracle (fields exact, so no guided tolerance)."""
    ref, ours = _pm_j(60, 3)
    s, u, beta = _state(ref, 4, 3)

    def no_launch(*a, **k):
        raise AssertionError("a CPU sweep must not launch the kernel")

    monkeypatch.setattr(MC.FusedSweep, "_launch", no_launch)
    out, de, cnt = MC.blocked_sweep_cuda(ours, torch.as_tensor(s),
                                         torch.as_tensor(beta),
                                         torch.as_tensor(u), rule=rule)
    jn, hn = np.asarray(ref.j), np.asarray(ref.h)
    for r in range(4):
        uu = np.where(np.asarray(ref.active_mask) > 0, u[r], 2.0)
        s_ref, de_ref, cnt_ref = K.sequential_sweep_oracle(
            jn, hn, s[r], float(beta[r]), uu, rule)
        js_ref, jde_ref, jcnt_ref = JK.sequential_sweep_oracle(
            jn, hn, s[r], float(beta[r]), uu, rule)
        np.testing.assert_array_equal(s_ref, js_ref)
        assert (de_ref, cnt_ref) == (jde_ref, jcnt_ref)
        np.testing.assert_array_equal(out[r].numpy(), s_ref)
        assert int(cnt[r]) == cnt_ref and float(de[r]) == de_ref
    # one replica: [1, Np].t() is already contiguous, yet the input must
    # not be swept in place
    one = torch.as_tensor(s[:1].copy())
    out1, _, cnt1 = MC.blocked_sweep_cuda(ours, one, torch.as_tensor(beta[:1]),
                                          torch.as_tensor(u[:1]), rule=rule)
    np.testing.assert_array_equal(one.numpy(), s[:1])
    np.testing.assert_array_equal(out1.numpy(), out[:1].numpy())


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_colored_sweep_matches_jax_on_grid(rule):
    ref, ours = _pm_j(64, 4, topo="grid")   # 8x8 grid, 2 colours
    colors = jax_topology.greedy_coloring(np.asarray(ref.j)[:64, :64])
    s, u, beta = _state(ref, 5, 4)
    theirs = JK.colored_sweep(ref, JK.color_masks_from_colors(colors, 128),
                              jnp.asarray(s), jnp.asarray(beta),
                              jnp.asarray(u), rule=rule)
    masks = K.color_masks_from_colors(colors, 128)
    np.testing.assert_array_equal(
        masks.numpy(), np.asarray(JK.color_masks_from_colors(colors, 128)))
    mine = K.colored_sweep(ours, masks, torch.as_tensor(s),
                           torch.as_tensor(beta), torch.as_tensor(u), rule=rule)
    _assert_same(mine, theirs)


def test_fused_sweep_cpu_philox_path_is_the_twin():
    """FusedSweep.__call__ on CPU tensors runs the twin on the kernel's
    Philox stream: no launch, same result as the twin fed philox_uniforms."""
    ref, ours = _pm_j(100, 5)
    s, _, beta = _state(ref, 16, 5)
    fused = MC.FusedSweep(ours, rule="metropolis")
    s1 = torch.as_tensor(s.T.copy())
    s2 = s1.clone()
    _, de1, c1 = fused(s1, torch.as_tensor(beta), 2 ** 40 + 17)
    u = MC.philox_uniforms(2 ** 40 + 17, 128, 16)
    _, de2, c2 = MC.fused_sweep_reference(ours.j, ours.h, ours.active_mask,
                                          s2, torch.as_tensor(beta), u)
    assert torch.equal(s1, s2) and torch.equal(c1, c2) and torch.equal(de1, de2)
    assert fused.launches == 0 and int(c1.sum()) > 0


def test_philox_known_answers_and_uniform_range():
    """Philox4x32-10 known-answer vectors (Random123), and u strictly in
    (0, 1), exact in float32, independent per (spin, replica)."""
    m = 0xFFFFFFFF
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((m, m, m, m), (m, m),
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        assert tuple(int(x) for x in MC.philox4x32(ctr, key)) == want
    u = MC.philox_uniforms(12345, 256, 64)
    assert u.dtype == torch.float32 and 0.0 < float(u.min()) < float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert not torch.equal(u, MC.philox_uniforms(12346, 256, 64))
