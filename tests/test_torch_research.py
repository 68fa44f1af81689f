"""The port's research layer (``spinglass_tpu_torch.research``) on the CPU,
against ``spinglass_tpu.research``: MSHO's coarsening, AQIA, LESD and the
QEC annealer fed the JAX functions' own draws (reproduced from their key
splits), the validation statistics, the Pareto archive, the meta-optimizer's
features and selector, federated aggregation, the unified analyzer, and the
behaviour the JAX unit tests hold (``tests/unit/test_research.py``,
``test_breakthrough.py``, ``test_security_deploy_meta.py``,
``test_scaling_infra.py``, ``test_parity_extras.py``) on the port. Quantum
annealing is in ``test_torch_quantum.py``, meta-RL in
``test_torch_meta_rl.py``.

Tolerances: on +-J couplings (h on a quarter grid) every field and energy is
exact, so decisions, energies, best spins and histories are equal bit for
bit. ``_coarsen`` is bit for bit on +-J and Gaussian couplings (the matching
visits the JAX order, the sums run in the JAX loop's order). LESD's scorer
and its Adam steps round differently from flax and optax: its losses agree
to 1e-4 relative and one Adam step's parameters to 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.core.problem import random_spins as jax_random_spins  # noqa: E402
from spinglass_tpu.research import breakthrough as JBT  # noqa: E402
from spinglass_tpu.research import federated as JF  # noqa: E402
from spinglass_tpu.research import meta as JM  # noqa: E402
from spinglass_tpu.research import novel as JN  # noqa: E402
from spinglass_tpu.research import pareto as JP  # noqa: E402
from spinglass_tpu.research import scaling as JS  # noqa: E402
from spinglass_tpu.research import unified as JU  # noqa: E402
from spinglass_tpu.research import validation as JV  # noqa: E402
from spinglass_tpu.core import energy as jax_energy  # noqa: E402
from spinglass_tpu_torch import research  # noqa: E402
from spinglass_tpu_torch.anneal.sa import SAConfig, anneal  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.convert import (  # noqa: E402
    problem_from_numpy, spin_scorer_from_flax)
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.research import breakthrough as BT  # noqa: E402
from spinglass_tpu_torch.research import federated as F  # noqa: E402
from spinglass_tpu_torch.research import meta as M  # noqa: E402
from spinglass_tpu_torch.research import novel as N  # noqa: E402
from spinglass_tpu_torch.research import pareto as P  # noqa: E402
from spinglass_tpu_torch.research import scaling as S  # noqa: E402
from spinglass_tpu_torch.research import unified as U  # noqa: E402
from spinglass_tpu_torch.research import validation as V  # noqa: E402


def _pair(j, h=None):
    """The same problem in both packages (the port's from the JAX arrays)."""
    jp = JaxProblem.from_dense(j, h)
    tp = problem_from_numpy(np.asarray(jp.j), np.asarray(jp.h),
                            np.asarray(jp.active_mask), jp.n_spins,
                            device="cpu")
    return tp, jp


def _pm_j(n, seed):
    """+-J couplings with h on a quarter grid."""
    return (topology.fully_connected(n, dist="binary", seed=seed),
            np.random.default_rng(seed).integers(-4, 5, n) / 4.0)


def _ferro(n):
    j = topology.fully_connected(n, dist="ferromagnetic", scale=1.0)
    return IsingProblem.from_dense(j, device="cpu"), -0.5 * n * (n - 1)


def _sk(n=16, seed=0):
    return IsingProblem.from_dense(
        topology.fully_connected(n, dist="binary", seed=seed), device="cpu")


def test_exports_match_the_jax_package():
    from spinglass_tpu import research as jr

    want = {k for k in vars(jr) if not k.startswith("_")}
    got = {k for k in vars(research) if not k.startswith("_")}
    assert want <= got, want - got


# ---------------------------------------------------------------------------
# MSHO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,dist,seed", [
    (20, "binary", 0), (33, "binary", 1), (64, "binary", 2),
    (20, "gaussian", 3), (41, "gaussian", 4), (64, "gaussian", 5)])
def test_coarsen_equals_jax(n, dist, seed):
    """+-J (every |J| ties, so the pairs follow numpy's argsort order) and
    Gaussian couplings with Gaussian fields: coarse J, h, the mapping and
    the signs bit for bit, also one level further down."""
    j = topology.fully_connected(n, dist=dist, seed=seed)
    h = np.random.default_rng(seed).normal(0.0, 0.5, n)
    for _ in range(2):
        want = JN._coarsen(j, h)
        got = N._coarsen(j, h)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        j, h = want[0], want[1]


def test_coarsen_keeps_unmatched_and_zero_couplings():
    """A chain with a zero coupling and an odd count: singletons follow the
    pairs in index order, as in the JAX loop."""
    j = topology.chain(7, dist="gaussian", seed=2)
    j[2, 3] = j[3, 2] = 0.0
    for a, b in zip(N._coarsen(j, np.zeros(7)), JN._coarsen(j, np.zeros(7))):
        np.testing.assert_array_equal(a, b)


def test_msho_solves_ferro_as_jax_does():
    p, ground = _ferro(24)
    cfg = dict(min_size=6, coarse_sweeps=150, refine_sweeps=100, n_replicas=8)
    got = N.multi_scale_optimization(p, N.MSHOConfig(**cfg))
    want = JN.multi_scale_optimization(
        JaxProblem.from_dense(topology.fully_connected(
            24, dist="ferromagnetic", scale=1.0)), JN.MSHOConfig(**cfg))
    assert got.best_energy == want.best_energy == pytest.approx(ground)
    assert got.metadata["n_levels"] == want.metadata["n_levels"] >= 2
    assert got.n_sweeps == want.n_sweeps and got.algorithm == "msho"
    assert got.metadata["captures"] <= got.metadata["n_levels"]


def test_coarsening_reduces_size():
    jc, hc, cidx, signs = N._coarsen(
        topology.fully_connected(20, dist="gaussian", seed=1), np.zeros(20))
    assert jc.shape[0] <= 12
    assert np.all(np.abs(signs) == 1.0)
    np.testing.assert_allclose(jc, jc.T)


# ---------------------------------------------------------------------------
# AQIA
# ---------------------------------------------------------------------------

def _aqia_draws(seed, r, n_pad, n_it):
    """The JAX function's draws: k0 for the start, then per iteration a
    3-way split (measure, tunnel)."""
    key = jax.random.key(seed)
    key, k0 = jax.random.split(key)
    u0 = np.asarray(jax.random.uniform(k0, (r, n_pad)))
    um, ut = [], []
    for _ in range(n_it):
        key, km, kt = jax.random.split(key, 3)
        um.append(np.asarray(jax.random.uniform(km, (r, n_pad))))
        ut.append(np.asarray(jax.random.uniform(kt, (r, n_pad))))
    return u0, np.stack(um), np.stack(ut)


@pytest.mark.parametrize("n,seed", [(12, 1), (40, 2)])
def test_aqia_equals_jax_on_its_draws(n, seed):
    """+-J glass: the best-energy history, the replica bests and the best
    spins of every iteration's decisions equal the JAX scan's."""
    tp, jp = _pair(*_pm_j(n, seed))
    cfg = dict(n_iterations=60, n_replicas=6, seed=seed)
    want = JN.adaptive_quantum_inspired_annealing(jp, JN.AQIAConfig(**cfg))
    draws = _aqia_draws(seed, 6, tp.n_padded, 60)
    got = N.adaptive_quantum_inspired_annealing(tp, N.AQIAConfig(**cfg),
                                                draws=draws)
    np.testing.assert_array_equal(got.energy_history, want.energy_history)
    np.testing.assert_array_equal(got.replica_best_energy,
                                  want.replica_best_energy)
    np.testing.assert_array_equal(got.best_spins, want.best_spins)
    assert got.best_energy == want.best_energy


def test_aqia_field_stays_float32():
    """The field decays in float32, as the JAX carry holds it (a Python
    float would decay in float64)."""
    tp, _ = _pair(*_pm_j(8, 0))
    cfg = N.AQIAConfig(n_iterations=5, n_replicas=2)
    st = N.aqia_init(tp, cfg, torch.Generator().manual_seed(0))
    for _ in range(5):
        st, _ = N.aqia_step(tp, cfg, st)
    want = np.float32(2.0)
    for _ in range(5):
        want = np.float32(want * np.float32(0.995))
    assert st.field.dtype == torch.float32 and float(st.field) == want


def test_aqia_captured_run_equals_its_eager_loop():
    """The captured iteration (on the CPU: replayed eagerly through its
    random tape) equals the eager loop of ``aqia_step`` on the same
    generator seed."""
    tp, _ = _pair(*_pm_j(20, 3))
    cfg = N.AQIAConfig(n_iterations=25, n_replicas=4)
    got = N.adaptive_quantum_inspired_annealing(
        tp, cfg, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    st = N.aqia_init(tp, cfg, gen)
    hist = []
    for _ in range(25):
        st, out = N.aqia_step(tp, cfg, st)
        hist.append(float(out))
    np.testing.assert_array_equal(got.energy_history, hist)
    np.testing.assert_array_equal(got.replica_best_energy, st.best_e.numpy())


def test_aqia_finds_ferro_ground_state():
    p, ground = _ferro(10)
    res = N.adaptive_quantum_inspired_annealing(
        p, N.AQIAConfig(n_iterations=300, n_replicas=16))
    assert res.best_energy == pytest.approx(ground, rel=1e-4)


# ---------------------------------------------------------------------------
# LESD
# ---------------------------------------------------------------------------

def _lesd_draws(seed, r, n_pad, n_spins, mask, n_it):
    """The JAX function's parameters and draws: a 3-way split (scorer
    init, start spins), then per iteration a 4-way split; k_exp feeds both
    the random pick and the explore uniforms."""
    key = jax.random.key(seed)
    key, kp, ks = jax.random.split(key, 3)
    params = JN.SpinScorer().init(kp, jnp.zeros((1, 3)))
    s0 = np.asarray(jax_random_spins(ks, (r, n_pad), mask))
    sel, acc, pick, exp = [], [], [], []
    for _ in range(n_it):
        key, k_sel, k_acc, k_exp = jax.random.split(key, 4)
        sel.append(np.asarray(jax.random.uniform(k_sel, (r, n_pad))))
        pick.append(np.asarray(jax.random.randint(k_exp, (r,), 0, n_spins)))
        exp.append(np.asarray(jax.random.uniform(k_exp, (r,))))
        acc.append(np.asarray(jax.random.uniform(k_acc, (r,))))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, tree, (s0, np.stack(sel), np.stack(acc), np.stack(pick),
                          np.stack(exp))


def _scorer_params(tree):
    model = spin_scorer_from_flax(tree, device="cpu")
    return {k: v.detach() for k, v in model.named_parameters()}


@pytest.mark.parametrize("n,seed", [(16, 3), (24, 4)])
def test_lesd_equals_jax_on_its_draws(n, seed):
    """+-J glass, the flax scorer's parameters carried across: the replica
    bests and best spins equal the JAX run's; the losses agree to 1e-4."""
    tp, jp = _pair(*_pm_j(n, seed))
    cfg = dict(n_iterations=40, n_replicas=8, seed=seed)
    want = JN.learning_enhanced_dynamics(jp, JN.LESDConfig(**cfg))
    _, tree, draws = _lesd_draws(seed, 8, tp.n_padded, n,
                                 jp.active_mask, 40)
    got = N.learning_enhanced_dynamics(tp, N.LESDConfig(**cfg),
                                       params=_scorer_params(tree),
                                       draws=draws)
    np.testing.assert_array_equal(got.replica_best_energy,
                                  want.replica_best_energy)
    np.testing.assert_array_equal(got.best_spins, want.best_spins)
    assert got.best_energy == want.best_energy
    np.testing.assert_allclose(got.energy_history, want.energy_history,
                               rtol=1e-4, atol=1e-6)


def test_lesd_step_adam_equals_optax():
    """One LESD step against the JAX step's arithmetic (flax scorer, optax
    Adam) on the same draws: the decisions equal, the loss to 1e-6
    relative, the updated parameters to 1e-6 absolute."""
    tp, jp = _pair(*_pm_j(20, 6))
    r, lr = 6, 1e-2
    params, tree, (s0, sel, acc, pick, exp) = _lesd_draws(
        6, r, tp.n_padded, 20, jp.active_mask, 1)
    model, tx = JN.SpinScorer(), optax.adam(lr)
    spins = jnp.asarray(s0)
    f = jax_energy.local_fields(jp, spins)
    feats = jnp.stack([spins, f, spins * f], axis=-1)
    scores = jnp.where(jp.active_mask[None, :] > 0, model.apply(params, feats),
                       -1e9)
    gumbel = -jnp.log(-jnp.log(jnp.asarray(sel[0]) + 1e-12) + 1e-12)
    jpick = jnp.where(jnp.asarray(exp[0]) < 0.1, jnp.asarray(pick[0]),
                      jnp.argmax(scores + gumbel, axis=-1))
    de = 2.0 * spins[jnp.arange(r), jpick] * f[jnp.arange(r), jpick]

    def loss_fn(p):
        pred = model.apply(p, feats[jnp.arange(r), jpick])
        return jnp.mean((pred - (-de)) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new = jax.tree_util.tree_map(np.asarray,
                                 optax.apply_updates(params, updates))

    cfg = N.LESDConfig(n_replicas=r, lr=lr)
    tparams = {k: v.clone().requires_grad_(True)
               for k, v in _scorer_params(tree).items()}
    opt = torch.optim.Adam(list(tparams.values()), lr=lr, eps=1e-8)
    st = torch.tensor(s0)
    e = torch.zeros(r)
    _, _, _, _, tloss = N.lesd_step(tp, cfg, N.SpinScorer(), tparams, opt,
                                    st, e, e, st, draws=(sel[0], acc[0],
                                                         pick[0], exp[0]))
    assert float(tloss) == pytest.approx(float(loss), rel=1e-6)
    got = _scorer_params(new)
    for k, v in tparams.items():
        np.testing.assert_allclose(v.detach().numpy(), got[k].numpy(),
                                   atol=1e-6, err_msg=k)


def test_lesd_captured_run_equals_its_eager_loop():
    """The captured iteration (on the CPU: replayed eagerly through its
    random tape, Adam included) equals the eager loop of ``lesd_step`` on
    the same generator seed: losses, replica bests and the scorer's
    parameters bit for bit."""
    from spinglass_tpu_torch.core import energy as E
    from spinglass_tpu_torch.core import rng
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.rl.ppo import init_params

    tp, _ = _pair(*_pm_j(20, 2))
    cfg = N.LESDConfig(n_iterations=15, n_replicas=4)
    got = N.learning_enhanced_dynamics(tp, cfg,
                                       generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    model = N.SpinScorer()
    params = init_params(model, gen, "cpu")
    opt = torch.optim.Adam(list(params.values()), lr=cfg.lr, eps=1e-8)
    spins = random_spins(rng.device_generator(gen, "cpu"), (4, tp.n_padded),
                         tp.active_mask)
    e = E.energy(tp, spins)
    best_e, best_s, losses = e, spins, []
    for _ in range(15):
        spins, e, best_e, best_s, loss = N.lesd_step(
            tp, cfg, model, params, opt, spins, e, best_e, best_s, gen)
        losses.append(float(loss))
    np.testing.assert_array_equal(got.energy_history,
                                  np.asarray(losses, np.float32))
    np.testing.assert_array_equal(got.replica_best_energy, best_e.numpy())
    for k, v in params.items():
        assert torch.equal(got.metadata["params"][k], v.detach()), k


def test_lesd_improves_energy():
    res = N.learning_enhanced_dynamics(_sk(16, 3),
                                       N.LESDConfig(n_iterations=200,
                                                    n_replicas=8))
    assert res.best_energy < 0
    assert np.isfinite(res.metadata["final_loss"])
    assert set(res.metadata["params"]) == {"dense.0.weight", "dense.0.bias",
                                           "dense.1.weight", "dense.1.bias"}


# ---------------------------------------------------------------------------
# QEC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep,n", [(1, 12), (2, 10), (2, 24)])
def test_qec_equals_jax_on_its_draws(rep, n):
    """Repetition 1 and 2 keep the encoded couplings (J / rep^2, the lock
    2.0) dyadic: the decoded spins, their energy and the code violations
    equal the JAX function's on its anneal's draws."""
    tp, jp = _pair(*_pm_j(n, rep + n))
    cfg = dict(repetition=rep, n_sweeps=60, n_replicas=4, seed=5)
    want = JN.quantum_error_corrected_annealing(jp, JN.QECConfig(**cfg))
    n_pad = -(-n * rep // 128) * 128
    mask = jnp.asarray(np.arange(n_pad) < n * rep, jnp.float32)
    key, sub = jax.random.split(jax.random.key(5))
    s0 = np.asarray(jax_random_spins(sub, (4, n_pad), mask))
    us = []
    for _ in range(60):
        key, ku = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(ku, (4, n_pad))))
    got = N.quantum_error_corrected_annealing(tp, N.QECConfig(**cfg),
                                              draws=(s0, np.stack(us)))
    assert got.best_energy == want.best_energy
    np.testing.assert_array_equal(got.best_spins, want.best_spins)
    assert got.metadata["code_violations"] == want.metadata["code_violations"]
    np.testing.assert_array_equal(got.replica_best_energy,
                                  want.replica_best_energy)


def test_qec_encoding_equals_the_jax_construction():
    """rep = 3 on Gaussian couplings: the encoded J and h of the JAX
    function's loop (kron of J / 9, the lock on each diagonal block, h / 3
    repeated), built here from its lines, equal the port's."""
    j = topology.fully_connected(9, dist="gaussian", seed=2)
    h = np.random.default_rng(2).normal(0, 1, 9)
    tp, jp = _pair(j, h)
    jj = np.asarray(jp.j, np.float64)[:9, :9]
    want = np.kron(jj / 9, np.ones((3, 3)))
    for i in range(9):
        want[3 * i:3 * i + 3, 3 * i:3 * i + 3] = 2.0 * (np.ones((3, 3))
                                                         - np.eye(3))
    big, hb = N.qec_encode(tp, 3, 2.0)
    np.testing.assert_array_equal(big, want)
    np.testing.assert_array_equal(hb, np.repeat(np.asarray(jp.h,
                                                           np.float64)[:9] / 3,
                                                3))


def test_majority_decode():
    phys = np.array([1, 1, -1, -1, -1, -1, 1, -1, 1, 1], np.float32)
    logical, bad = N.majority_decode(phys, 5, 2)
    np.testing.assert_array_equal(logical, [1, -1, -1, 1, 1])  # a tie is +1
    assert bad == 1


def test_qec_decodes_ground_state():
    p, ground = _ferro(10)
    res = N.quantum_error_corrected_annealing(
        p, N.QECConfig(n_sweeps=200, n_replicas=8))
    assert res.best_energy == pytest.approx(ground)
    assert res.algorithm == "qec_annealer" and len(res.best_spins) == 10


def test_compare_harness():
    out = N.compare_algorithms(_ferro(8)[0], algorithms=["aqia", "qec"])
    assert set(out) == {"aqia", "qec"}
    assert all(np.isfinite(v["best_energy"]) for v in out.values())
    assert set(N.ALGORITHM_REGISTRY) == set(JN.ALGORITHM_REGISTRY)


# ---------------------------------------------------------------------------
# validation, scaling
# ---------------------------------------------------------------------------

def test_statistics_equal_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(0.0, 1.0, 30), rng.normal(2.0, 1.0, 25)
    assert V.welch_t(a, b) == JV.welch_t(a, b)
    assert V.cohens_d(a, b) == JV.cohens_d(a, b)
    assert V.bootstrap_ci(a, seed=3) == JV.bootstrap_ci(a, seed=3)
    assert V.welch_t(a, b)["p_value"] < 0.01
    assert V.welch_t(a, a)["p_value"] > 0.9


class _Res:
    def __init__(self, e):
        self.best_energy = e


def test_experimental_validation_equals_jax():
    """Deterministic algorithms: the analysis equals the JAX one's, its
    runtimes aside."""
    algos = {"a": lambda p, s: _Res(-float(s % 3)),
             "b": lambda p, s: _Res(-float(s % 5) - 1.0)}
    got = V.ExperimentalValidation(n_trials=4).run(None, algos).analyze()
    want = JV.ExperimentalValidation(n_trials=4).run(None, algos).analyze()
    for rep in (got, want):
        for entry in rep["algorithms"].values():
            entry.pop("mean_runtime")
    assert got == want


def test_experiment_runner_on_anneals():
    p = _sk(12, seed=4)

    def strong(problem, seed):
        return anneal(problem, SAConfig(n_sweeps=60, n_replicas=8, seed=seed))

    def weak(problem, seed):
        return anneal(problem, SAConfig(n_sweeps=5, n_replicas=2, seed=seed))

    rep = V.ExperimentalValidation(n_trials=3).run(
        p, {"strong": strong, "weak": weak}).analyze(baseline="weak")
    assert (rep["algorithms"]["strong"]["mean_best_energy"]
            <= rep["algorithms"]["weak"]["mean_best_energy"])
    assert "vs_baseline" in rep["algorithms"]["strong"]


def test_scaling_fits_equal_jax():
    sizes = [16, 32, 64, 128, 256]
    values = [3.0 * n ** 1.7 for n in sizes]
    assert S.fit_power_law(sizes, values) == JS.fit_power_law(sizes, values)
    assert S.fit_exponential(sizes, values) == JS.fit_exponential(sizes,
                                                                  values)
    a, b, r2 = S.fit_power_law(sizes, values)
    assert b == pytest.approx(1.7) and r2 == pytest.approx(1.0)
    out = S.ScalingAnalyzer().measure(lambda n: _Res(-float(n)), [8, 16, 32],
                                      n_trials=2).analyze()
    assert out["best_fit"] in ("power", "exponential")
    assert len(out["points"]) == 3


# ---------------------------------------------------------------------------
# Pareto
# ---------------------------------------------------------------------------

def test_pareto_archive_equals_jax():
    rng = np.random.default_rng(1)
    pts = rng.integers(0, 6, (40, 2)).astype(float)
    got, want = P.ParetoArchive(), JP.ParetoArchive()
    for k, x in enumerate(pts):
        assert got.insert(x, np.full(3, k)) == want.insert(x, np.full(3, k))
    np.testing.assert_array_equal(got.front, want.front)
    assert got.hypervolume_2d([7.0, 7.0]) == want.hypervolume_2d([7.0, 7.0])
    for k in (2, 3):
        np.testing.assert_array_equal(P.weight_vectors(5, k, seed=2),
                                      JP.weight_vectors(5, k, seed=2))
    assert P.dominates(np.array([1.0, 1.0]), np.array([2.0, 2.0]))
    assert not P.dominates(np.array([1.0, 3.0]), np.array([2.0, 2.0]))


def test_pareto_combine_equals_jax():
    pairs = [_pair(topology.fully_connected(10, dist="gaussian", seed=s),
                   np.random.default_rng(s).normal(0, 1, 10)) for s in (1, 2)]
    w = np.array([0.3, 0.7])
    got = P.combine([t for t, _ in pairs], w)
    want = JP.combine([j for _, j in pairs], w)
    np.testing.assert_array_equal(got.j.numpy(), np.asarray(want.j))
    np.testing.assert_array_equal(got.h.numpy(), np.asarray(want.h))


def test_multiobjective_optimize():
    n = 8
    j1 = topology.fully_connected(n, dist="ferromagnetic", scale=1.0)
    arch = P.optimize([IsingProblem.from_dense(j1, device="cpu"),
                       IsingProblem.from_dense(-j1, device="cpu")],
                      P.MultiObjectiveConfig(n_weight_vectors=4, n_sweeps=100,
                                             n_replicas=8))
    assert len(arch.objectives) >= 2 and arch.front.shape[1] == 2


def test_archive_maintains_front():
    a = P.ParetoArchive()
    assert a.insert([2.0, 2.0], np.zeros(2))
    assert a.insert([1.0, 3.0], np.zeros(2))
    assert not a.insert([3.0, 3.0], np.zeros(2))
    assert a.insert([0.5, 0.5], np.zeros(2))
    assert len(a.objectives) == 1


# ---------------------------------------------------------------------------
# meta, unified
# ---------------------------------------------------------------------------

def _instances():
    return [topology.fully_connected(32, dist="binary", seed=0),
            topology.fully_connected(20, dist="gaussian", seed=1),
            topology.fully_connected(16, dist="ferromagnetic", seed=0),
            -topology.fully_connected(16, dist="ferromagnetic", seed=0),
            topology.random_graph(300, density=0.02, seed=3),
            topology.random_graph(2500, density=0.002, seed=1)]


@pytest.mark.parametrize("k", range(6))
def test_characterize_select_and_analyze_equal_jax(k):
    j = _instances()[k]
    h = np.random.default_rng(k).normal(0, 0.3 * (k == 1), j.shape[0])
    tp, jp = _pair(j, h)
    np.testing.assert_array_equal(M.characterize(tp), JM.characterize(jp))
    assert M.select_algorithm(tp) == JM.select_algorithm(jp)
    got, want = U.ProblemAnalyzer().analyze(tp), JU.ProblemAnalyzer().analyze(jp)
    assert got.to_dict() == want.to_dict()


def test_schedule_memory_equals_jax():
    rng = np.random.default_rng(4)
    got, want = M.ScheduleMemory(), JM.ScheduleMemory()
    for _ in range(12):
        e = rng.normal(size=8)
        params = {"initial_temp": float(rng.uniform(1, 9)),
                  "alpha": float(rng.uniform(0.9, 0.99))}
        score = float(rng.normal())
        got.record(e, params, score)
        want.record(e, params, score)
        q = rng.normal(size=8)
        assert got.suggest(q) == want.suggest(q)
    assert M.ScheduleMemory().suggest(np.zeros(8))["initial_temp"] == 5.0


def test_meta_solver_runs_every_algorithm():
    opt = M.MetaOptimizer(n_sweeps=80, n_replicas=8)
    for algo in ("sa", "pt", "adaptive_sa", "sqa"):
        res = opt.solve(_sk(16, 1), algorithm=algo)
        assert np.isfinite(res.best_energy)
    rep = opt.report()
    assert rep["n_solved"] == 4 and rep["memory_size"] == 4
    assert set(rep["algorithms_used"]) == {"sa", "pt", "adaptive_sa", "sqa"}


def test_meta_selected_solve_end_to_end():
    opt = M.MetaOptimizer(n_sweeps=80, n_replicas=8)
    for seed in range(2):
        assert np.isfinite(opt.solve(_sk(16, seed)).best_energy)
    assert opt.report()["n_solved"] == 2


def test_unified_framework():
    fw = U.UnifiedResearchFramework(n_sweeps=40, n_replicas=4)
    p = _sk(12)
    assert np.isfinite(float(fw.solve(p, algorithm="sa").best_energy))
    rep = fw.report()
    assert rep["n_solved"] == 1 and rep["problem_classes"]
    out = fw.compare(p, algorithms=("sa", "pt"), n_trials=2)
    assert out["winner"] in ("sa", "pt") and "p_value" in out
    sel = U.AlgorithmSelector(min_evidence=2)
    analysis = U.ProblemAnalyzer().analyze(p)
    for _ in range(3):
        sel.record(analysis.problem_class, "pt", 0.9)
        sel.record(analysis.problem_class, "sa", 0.1)
    assert sel.select(analysis) == "pt"


# ---------------------------------------------------------------------------
# federated, breakthrough
# ---------------------------------------------------------------------------

def test_federated_aggregate_equals_jax():
    reports = [F.ClientReport(i, -10.0 - i, 0.1 * i - 0.05,
                              {"initial_temp": 3.0 + i, "alpha": 0.95 + i / 100},
                              0.0) for i in range(4)]
    jreports = [JF.ClientReport(**r.__dict__) for r in reports]
    assert (F.FederatedAnnealingServer().aggregate(reports)
            == JF.FederatedAnnealingServer().aggregate(jreports))


def test_federated_round_keeps_privacy():
    server = F.FederatedAnnealingServer(F.FederatedConfig(
        n_rounds=2, local_sweeps=80, n_replicas=8))
    out = server.run([_sk(12, i) for i in range(3)])
    assert len(out["history"]) == 2 and len(out["final_best"]) == 3
    assert all(np.isfinite(e) for e in out["final_best"])
    assert set(out["global_params"]) == {"initial_temp", "alpha"}


def test_federated_quantum_runs_and_aggregates():
    opt = F.FederatedQuantumHybridOptimizer(
        F.FederatedConfig(n_rounds=2, local_sweeps=40, n_replicas=4),
        n_stages=2)
    out = opt.run([_sk(10, i) for i in range(2)])
    assert len(out["history"]) == 2 and out["global_gamma0"] > 0


BCFG = BT.BreakthroughConfig(n_sweeps=40, n_replicas=4)


@pytest.mark.parametrize("annealer", ["neural", "qec", "federated"])
def test_breakthrough_annealers(annealer):
    p = _sk(12, 7)
    if annealer == "neural":
        res = BT.AdaptiveNeuralAnnealer(BCFG).solve(p, seed=0)
    elif annealer == "qec":
        res = BT.QuantumErrorCorrectedAnnealer(BCFG).solve(p, seed=0)
    else:
        res = BT.FederatedOptimizationNetwork(BCFG, n_clients=2,
                                              n_rounds=2).solve(p, seed=0)
        assert len(res.detail["history"]) == 2
    assert np.isfinite(res.best_energy)


def test_breakthrough_validate_report(tmp_path):
    fw = BT.BreakthroughResearchFramework(BCFG, n_trials=2)
    report = fw.validate(_sk(12, 7))
    assert set(report["algorithms"]) == {"baseline", "adaptive_neural",
                                         "quantum_error_corrected",
                                         "federated"}
    for name, entry in report["algorithms"].items():
        assert np.isfinite(entry["mean_best_energy"])
        if name != "baseline":
            assert "p_value" in entry["welch_t"]
            assert isinstance(entry["significant_vs_baseline"], bool)
    out = tmp_path / "breakthrough.json"
    fw.save(str(out))
    import json

    assert json.loads(out.read_text())["baseline"] == "baseline"
    with pytest.raises(ValueError):
        BT.BreakthroughResearchFramework(BCFG).save(str(tmp_path / "x.json"))
    assert JBT.BreakthroughConfig().use_pallas == BT.BreakthroughConfig(
    ).use_kernel == "auto"
