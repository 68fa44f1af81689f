"""The port's quantum-inspired annealing (``spinglass_tpu_torch.research.
quantum``) on the CPU, against ``spinglass_tpu.research.quantum``: ``j_perp``;
the Trotter problem's J, h and mask; SQA and PIMC fed the JAX functions' own
draws (start spins and per-sweep uniforms reproduced from their key splits,
as ``tests/test_torch_batch.py`` reproduces the batch path's); the in-place
rewrite of the inter-slice couplings against a per-stage rebuild; the
captures per call; the JAX unit tests' behaviour.

Tolerances: ``j_perp`` exact. The Trotter problem exact: J/P and J_perp are
computed in float64 and cast once on both sides. SQA and PIMC bit for bit on
+-J problems whose Gamma puts J_perp on a dyadic float32 (0.25 or 0.5) with
P a power of two: every field and energy is then exact, so best energies,
best spins, slice energies and the stage history must be equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.core.problem import random_spins as jax_random_spins  # noqa: E402
from spinglass_tpu.research import quantum as JQ  # noqa: E402
from spinglass_tpu_torch.anneal import graphs  # noqa: E402
from spinglass_tpu_torch.anneal import sa  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.convert import problem_from_numpy  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.research import quantum as Q  # noqa: E402


def _pair(j, h=None):
    """The same problem in both packages (the port's from the JAX arrays)."""
    jp = JaxProblem.from_dense(j, h)
    tp = problem_from_numpy(np.asarray(jp.j), np.asarray(jp.h),
                            np.asarray(jp.active_mask), jp.n_spins,
                            device="cpu")
    return tp, jp


def _gamma_for(j_perp: float, beta: float, p: int) -> float:
    """The transverse field at which ``j_perp`` is the inter-slice
    coupling (float32 rounds the float64 round trip back onto it)."""
    return p / beta * math.atanh(math.exp(-2.0 * beta * j_perp))


@pytest.mark.parametrize("beta,gamma,p", [
    (2.0, 2.5, 8), (2.0, 0.01, 8), (1.0, 1.0, 4), (0.5, 3.0, 3),
    (2.0, 1e-14, 2), (5.0, 100.0, 1)])
def test_j_perp_equals_jax(beta, gamma, p):
    assert Q.j_perp(beta, gamma, p) == JQ.j_perp(beta, gamma, p)


@pytest.mark.parametrize("n,p", [(6, 1), (7, 2), (9, 3), (12, 4), (24, 8),
                                 (20, 3)])
def test_trotterize_equals_jax(n, p):
    """Gaussian J and h (every J/P and h/P rounds): J, h, mask and the
    padded size equal the JAX Trotter problem's exactly."""
    j = topology.fully_connected(n, dist="gaussian", seed=n)
    h = np.random.default_rng(n).normal(0.0, 0.5, n)
    tp, jp = _pair(j, h)
    want = JQ.trotterize(jp, p, beta=2.0, gamma=0.7)
    got = Q.trotterize(tp, p, beta=2.0, gamma=0.7)
    assert got.n_spins == want.n_spins == p * n
    assert got.n_padded == want.n_padded
    np.testing.assert_array_equal(got.j.numpy(), np.asarray(want.j))
    np.testing.assert_array_equal(got.h.numpy(), np.asarray(want.h))
    np.testing.assert_array_equal(got.active_mask.numpy(),
                                  np.asarray(want.active_mask))


@pytest.mark.parametrize("p", [1, 2, 3, 5])
def test_set_field_equals_a_fresh_build(p):
    """Rewriting the inter-slice couplings in place gives the Trotter
    problem a fresh build makes at the new field, and touches nothing
    else; P = 2 has one edge between its slices, P = 1 none."""
    tp, _ = _pair(topology.fully_connected(10, dist="gaussian", seed=1))
    trot = Q.trotterize(tp, p, beta=2.0, gamma=2.0)
    trot.set_field(2.0, 0.05)
    fresh = Q.trotterize(tp, p, beta=2.0, gamma=0.05)
    assert torch.equal(trot.j, fresh.j)
    edges = 0 if p == 1 else 1 if p == 2 else p
    assert trot.inter_slice_index().numel() == 2 * edges * 10
    assert Q.TrotterProblem.j_planes == 3


def _dyadic_case(n=12, p=4, seed=3):
    """A +-J glass with quarter-grid fields and (beta, Gamma start, Gamma
    end) putting J_perp at 0.25 then 0.5."""
    j = topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-4, 5, n) / 4.0
    beta = 2.0
    return j, h, beta, _gamma_for(0.25, beta, p), _gamma_for(0.5, beta, p)


def _anneal_draws(key, n_pad, mask, r, sweeps):
    """The draws of the JAX ``anneal`` under ``key`` (``sa.py``
    ``init_state`` and ``_one_sweep``): a split for the start spins, then
    one split per sweep for its [R, Np] uniforms."""
    key, sub = jax.random.split(key)
    s0 = np.asarray(jax_random_spins(sub, (r, n_pad), mask))
    us = []
    for _ in range(sweeps):
        key, ku = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(ku, (r, n_pad), jnp.float32)))
    return s0, np.stack(us)


def test_sqa_equals_jax_on_its_draws():
    """Two stages (``np.geomspace`` keeps both ends exact): the JAX SQA
    against the port fed the draws of each stage's key split."""
    j, h, beta, g0, g1 = _dyadic_case()
    tp, jp = _pair(j, h)
    jcfg = JQ.SQAConfig(n_trotter=4, beta=beta, gamma_start=g0, gamma_end=g1,
                        n_stages=2, sweeps_per_stage=60, n_replicas=4, seed=7)
    cfg = Q.SQAConfig(**jcfg.__dict__)
    for gamma in (g0, g1):
        assert float(np.float32(Q.j_perp(beta, gamma, 4))) in (0.25, 0.5)
    want = JQ.simulated_quantum_annealing(jp, jcfg)
    key = jax.random.key(jcfg.seed)
    draws = []
    for gamma in np.geomspace(g0, g1, 2):
        key, sub = jax.random.split(key)
        jt = JQ.trotterize(jp, 4, beta, float(gamma))
        draws.append(_anneal_draws(sub, jt.n_padded, jt.active_mask, 4, 60))
    got = Q.simulated_quantum_annealing(tp, cfg, draws=draws)
    assert got.best_energy == want.best_energy
    np.testing.assert_array_equal(got.best_spins, want.best_spins)
    np.testing.assert_array_equal(got.energy_history, want.energy_history)
    assert got.metadata["gammas"] == want.metadata["gammas"]
    assert got.metadata["captures"] == 0   # given draws run eagerly
    assert got.algorithm == "sqa" and got.n_sweeps == want.n_sweeps


def test_pimc_equals_jax_on_its_draws():
    """PIMC at a Gamma with J_perp = 0.5: the JAX function's anneal draws
    from key(seed); best energy, best slice and all slice energies equal."""
    j, h, beta, _, g1 = _dyadic_case(n=10, p=4, seed=5)
    tp, jp = _pair(j, h)
    jcfg = JQ.PIMCConfig(n_trotter=4, beta=beta, gamma=g1, n_sweeps=80,
                         n_replicas=4, seed=3)
    want = JQ.path_integral_monte_carlo(jp, jcfg)
    jt = JQ.trotterize(jp, 4, beta, g1)
    draws = _anneal_draws(jax.random.key(jcfg.seed), jt.n_padded,
                          jt.active_mask, 4, 80)
    got = Q.path_integral_monte_carlo(tp, Q.PIMCConfig(**jcfg.__dict__),
                                      draws=draws)
    assert got.best_energy == want.best_energy
    np.testing.assert_array_equal(got.best_spins, want.best_spins)
    assert got.metadata["slice_energies"] == want.metadata["slice_energies"]
    np.testing.assert_array_equal(got.replica_best_energy,
                                  want.replica_best_energy)
    assert got.algorithm == "pimc" and got.metadata["gamma"] == g1


def test_in_place_rewrite_equals_per_stage_rebuild():
    """SQA on its cached Trotter problem, rewritten in place per stage and
    annealed through one captured chunk, against a fresh Trotter problem
    per stage with a capture of its own, on one generator seed: bit for
    bit in the best energy, spins and stage history. A repeat call
    captures nothing."""
    j, h, beta, g0, g1 = _dyadic_case(n=12, p=4, seed=9)
    tp, _ = _pair(j, h)
    cfg = Q.SQAConfig(n_trotter=4, beta=beta, gamma_start=g0, gamma_end=g1,
                      n_stages=3, sweeps_per_stage=40, n_replicas=4, seed=1)
    graphs.clear_caches()
    assert len(Q.TROTTER_CACHE) == 0
    got = Q.simulated_quantum_annealing(
        tp, cfg, generator=torch.Generator().manual_seed(11))
    assert got.metadata["captures"] == 1
    gen = torch.Generator().manual_seed(11)
    best, spins, hist = np.inf, None, []
    for stage, gamma in enumerate(np.geomspace(g0, g1, 3)):
        fresh = Q.trotterize(tp, 4, beta, float(gamma))
        res = sa.anneal(fresh, Q.stage_config(cfg, 40, cfg.seed + stage),
                        generator=gen)
        slices, e = Q.slice_energies(tp, res.best_spins, 4)
        k = int(np.argmin(e))
        if e[k] < best:
            best, spins = float(e[k]), slices[k]
        hist.append(best)
    assert got.best_energy == best
    np.testing.assert_array_equal(got.best_spins, spins)
    np.testing.assert_array_equal(got.energy_history, hist)
    again = Q.simulated_quantum_annealing(
        tp, cfg, generator=torch.Generator().manual_seed(11))
    assert again.metadata["captures"] == 0
    assert again.best_energy == got.best_energy
    np.testing.assert_array_equal(again.best_spins, got.best_spins)


def test_clear_caches_drops_the_trotter_problems():
    """``graphs.clear_caches`` clears the Trotter cache with the step
    caches: no Trotter J (nor its base problem) outlives it."""
    j, h, beta, g0, _ = _dyadic_case(n=8, p=2, seed=3)
    base, _ = _pair(j, h)
    graphs.clear_caches()
    tp = Q.trotter_problem(base, 2, beta, g0)
    assert Q.trotter_problem(base, 2, beta, g0) is tp
    assert len(Q.TROTTER_CACHE) == 1
    graphs.clear_caches()
    assert len(Q.TROTTER_CACHE) == 0
    assert Q.trotter_problem(base, 2, beta, g0) is not tp


def _ferro(n=10):
    j = topology.fully_connected(n, dist="ferromagnetic", scale=1.0)
    return IsingProblem.from_dense(j, device="cpu"), -0.5 * n * (n - 1)


def test_j_perp_positive_and_monotone():
    vals = [Q.j_perp(2.0, g, 8) for g in (2.0, 1.0, 0.5, 0.1)]
    assert all(v > 0 for v in vals)
    assert all(b > a for a, b in zip(vals, vals[1:]))


def test_sqa_finds_ferro_ground_state():
    p, ground = _ferro(10)
    l0 = build.launch_snapshot()
    res = Q.simulated_quantum_annealing(p, Q.SQAConfig(
        n_trotter=4, n_stages=4, sweeps_per_stage=80, n_replicas=8))
    assert res.best_energy == pytest.approx(ground, rel=1e-5)
    assert res.algorithm == "sqa" and res.device == "cpu"
    assert build.launches_since(l0) == {}


def test_pimc_reports_the_classical_energy_of_its_slice():
    """The reported energy is the classical energy of the returned slice
    (the JAX unit test's check, to 1e-3)."""
    p = IsingProblem.from_dense(topology.fully_connected(
        8, dist="binary", seed=2), device="cpu")
    res = Q.path_integral_monte_carlo(p, Q.PIMCConfig(n_trotter=4,
                                                      n_sweeps=100,
                                                      n_replicas=8))
    assert len(res.best_spins) == 8 and np.all(np.abs(res.best_spins) == 1)
    s = torch.ones(p.n_padded)
    s[:8] = torch.as_tensor(res.best_spins)
    from spinglass_tpu_torch.core.energy import energy

    assert res.best_energy == pytest.approx(float(energy(p, s)), abs=1e-3)
