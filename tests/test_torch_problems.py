"""Port parity: the problem path (``spinglass_tpu_torch.problems``) against
the JAX package's encoders, decoders and solver.

Each of the ten ``PROBLEM_REGISTRY`` entries is generated from one seed in
both packages and encoded: the padded J, h and mask must be equal element
for element. Decoding the same numpy spins must give the same solution. On
an integer-grid TSP (every J and h entry a multiple of 1/4, so every field is
exact in float32 whatever the summation order) the port's blocked sweep must
equal the JAX package's XLA ``blocked_sweep`` bit for bit under the same
uniforms. The known optima of ``tests/unit/test_problems.py`` are reached
through the port's ``solve`` on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import spinglass_tpu.problems as JP  # noqa: E402
from spinglass_tpu.kernels import sweeps as JK  # noqa: E402
import spinglass_tpu_torch.problems as PP  # noqa: E402
from spinglass_tpu_torch.anneal import graphs, pt  # noqa: E402
from spinglass_tpu_torch.anneal.engines import BlockedEngine  # noqa: E402
from spinglass_tpu_torch.anneal.sa import SAConfig, anneal  # noqa: E402
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig  # noqa: E402
from spinglass_tpu_torch.benchmarks.exact_instances import grid_tsp  # noqa: E402
from spinglass_tpu_torch.core.energy import energy  # noqa: E402

U_MAX = 0.999999
FAST = SAConfig(n_sweeps=400, n_replicas=32, use_kernel="never", seed=0,
                schedule=ScheduleConfig(initial_temp=5.0, final_temp=0.01,
                                        alpha=0.99))
# a small instance of every registry entry, generated from one seed
INSTANCES = {
    "maxcut": dict(n_nodes=12, density=0.5, seed=1),
    "tsp": dict(n_cities=5, seed=2),
    "vrp": dict(n_customers=4, n_vehicles=2, seed=3),
    "vrp_arc": dict(n_customers=3, n_vehicles=2, seed=4),
    "scheduling": dict(n_tasks=4, n_agents=2, seed=5, precedence_prob=0.5),
    "jobshop": dict(n_jobs=2, ops_per_job=2, n_agents=2, seed=6),
    "resource": dict(n_resources=3, n_demands=5, seed=7),
    "coordination": dict(n_agents=3, n_tasks=4, horizon=3, seed=8),
    "qap": dict(n=4, seed=9),
    "simple_scheduler": dict(n_tasks=5, n_agents=3, seed=10),
}


def _pair(name):
    """(port template on the CPU, JAX template), the same instance."""
    mine = PP.PROBLEM_REGISTRY[name](device="cpu")
    theirs = JP.PROBLEM_REGISTRY[name]()
    for t in (mine, theirs):
        t.generate_random_instance(**INSTANCES[name])
    if name == "scheduling":   # a due date, so the lateness fields show
        for t in (mine, theirs):
            t.tasks[0].due_date = 2
    return mine, theirs


def _same(a, b) -> bool:
    """Deep equality of decoded values (dicts, lists, arrays, scalars)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_registry_has_the_ten_entries_of_jax():
    assert sorted(PP.PROBLEM_REGISTRY) == sorted(JP.PROBLEM_REGISTRY)
    assert len(PP.PROBLEM_REGISTRY) == 10
    for name, cls in PP.PROBLEM_REGISTRY.items():
        assert cls.__name__ == JP.PROBLEM_REGISTRY[name].__name__


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_encoded_problem_equals_jax(name):
    """Padded J, h and mask equal the JAX encoder's exactly. (The JAX
    package accumulates J in its native scatter, the port with np.add.at:
    both add in term order, so no entry differs, not even by an ulp.)"""
    mine, theirs = _pair(name)
    p, q = mine.encode_to_ising(), theirs.encode_to_ising()
    assert p.device.type == "cpu" and p.n_spins == q.n_spins
    assert p.n_padded == q.n_padded
    np.testing.assert_array_equal(p.j.numpy(), np.asarray(q.j))
    np.testing.assert_array_equal(p.h.numpy(), np.asarray(q.h))
    np.testing.assert_array_equal(p.active_mask.numpy(),
                                  np.asarray(q.active_mask))
    t_mine, t_theirs = mine.compiler.compile(), theirs.compiler.compile()
    for f in ("lin_i", "lin_v", "quad_i", "quad_j", "quad_v"):
        assert np.array_equal(getattr(t_mine, f), getattr(t_theirs, f)), f
    assert t_mine.const == t_theirs.const


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_solution_equals_jax(name, seed):
    mine, theirs = _pair(name)
    n = mine.encode_to_ising().n_spins
    theirs.encode_to_ising()
    s = np.random.default_rng(seed).choice([-1.0, 1.0], n)
    a, b = mine.decode_solution(s), theirs.decode_solution(s)
    assert a.objective_value == b.objective_value
    assert _same(a.variables, b.variables)
    assert a.is_feasible == b.is_feasible
    assert _same(a.constraint_violations, b.constraint_violations)
    assert _same(a.metadata, b.metadata)
    assert a.to_json() == b.to_json()


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
@pytest.mark.parametrize("block_size", [64, 128])
def test_grid_tsp_blocked_sweep_equals_jax_bitwise(rule, block_size):
    _, p = grid_tsp(6, span=8, device="cpu")
    _, q = grid_tsp(6, span=8, template=JP.TSPProblem)
    j = p.j.numpy()
    assert np.array_equal(j * 4, np.round(j * 4)) and np.abs(j).max() > 8
    rng = np.random.default_rng(11)
    r = 8
    s = np.where(rng.random((r, p.n_padded)) < 0.5, -1.0, 1.0)
    s[:, p.n_spins:] = 1.0
    s = s.astype(np.float32)
    beta = rng.uniform(0.05, 1.0, r).astype(np.float32)
    eng = BlockedEngine(p, block_size=block_size, rule=rule)
    mine, theirs = torch.as_tensor(s), jnp.asarray(s)
    for _ in range(3):
        u = rng.uniform(0.0, U_MAX, (r, p.n_padded)).astype(np.float32)
        mine, de, cnt = eng.sweep_with_uniforms(mine, torch.as_tensor(beta),
                                                torch.as_tensor(u))
        theirs, de_j, cnt_j = JK.blocked_sweep(
            q, theirs, jnp.asarray(beta), jnp.asarray(u),
            block_size=block_size, rule=rule)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
        np.testing.assert_array_equal(de.numpy(), np.asarray(de_j))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert int(cnt.sum()) > 0


# ---- solving: the known optima of tests/unit/test_problems.py -------------

def test_four_city_square_reaches_tour_length_four():
    locs = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    p = PP.TSPProblem(locations=locs, device="cpu")
    sol = p.solve(FAST)
    assert p.validate_tour(sol.variables["tour"])
    assert sol.objective_value == pytest.approx(4.0, rel=1e-6)
    meta = sol.metadata["anneal"]
    assert meta["device"] == "cpu" and meta["engine"] is not None
    assert meta["kernel_launches"] == {"sa_track": 0}   # the CPU: no kernel


def test_maxcut_k33_reaches_the_full_cut():
    w = np.zeros((6, 6))
    w[:3, 3:] = 1.0
    w[3:, :3] = 1.0
    p = PP.MaxCutProblem(weights=w, device="cpu")
    sol = p.solve(FAST)
    assert sol.variables["cut_value"] == pytest.approx(9.0)
    assert sol.objective_value == pytest.approx(-9.0)


def test_maxcut_cut_identity():
    p = PP.MaxCutProblem(device="cpu")
    p.generate_random_instance(n_nodes=10, density=0.6, seed=1)
    prob = p.encode_to_ising()
    s = np.random.default_rng(0).choice([-1.0, 1.0], 10)
    sp = torch.ones(prob.n_padded)
    sp[:10] = torch.as_tensor(s)
    e = float(energy(prob, sp))
    assert p.cut_value(s) == pytest.approx(0.5 * (0.5 * p.weights.sum() - e),
                                           rel=1e-4)


def test_qap_identity_cost_and_solve_gives_a_permutation():
    p = PP.QuadraticAssignmentProblem(device="cpu")
    p.generate_random_instance(n=4, seed=0)
    assert p.assignment_cost(np.arange(4)) == pytest.approx(
        float((p.flows * p.distances).sum()))
    p = PP.QuadraticAssignmentProblem(device="cpu")
    p.generate_random_instance(n=4, seed=1)
    sol = p.solve(FAST)
    assert sorted(sol.variables["permutation"].tolist()) == [0, 1, 2, 3]


def test_scheduling_solve_is_feasible():
    p = PP.SchedulingProblem(device="cpu")
    p.generate_random_instance(n_tasks=4, n_agents=2, seed=1,
                               precedence_prob=0.0)
    sol = p.solve(FAST)
    assert len(sol.variables["assignments"]) == 4
    assert sol.is_feasible, sol.constraint_violations


def test_vrp_solve_serves_every_customer():
    p = PP.VRPProblem(device="cpu")
    p.generate_random_instance(n_customers=5, n_vehicles=2, seed=0)
    sol = p.solve(FAST)
    served = sorted(c for route in sol.variables["routes"].values()
                    for c in route)
    assert served == list(range(5))


def test_simple_scheduler_reaches_the_optimum():
    p = PP.SimpleScheduler(costs=np.array([[1.0, 10.0], [10.0, 1.0],
                                           [1.0, 10.0]]), device="cpu")
    sol = p.solve(FAST)
    assert sol.objective_value == pytest.approx(3.0)
    assert sol.variables["assignment"] == {0: 0, 1: 1, 2: 0}


def test_resource_solve_allocates_all_feasibly():
    p = PP.ResourceAllocationProblem(device="cpu")
    p.generate_random_instance(n_resources=3, n_demands=5, seed=0)
    sol = p.solve(FAST)
    assert len(sol.variables["allocation"]) == 5
    assert sol.is_feasible, sol.constraint_violations


def test_solve_through_pt_run_as_the_annealer():
    locs = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    p = PP.TSPProblem(locations=locs, device="cpu")
    cfg = pt.PTConfig(n_replicas=8, n_sweeps=300, use_kernel="never", seed=1)
    sol = p.solve(cfg, annealer=pt.run)
    assert sol.objective_value == pytest.approx(4.0, rel=1e-6)
    assert sol.metadata["anneal"]["algorithm"] == "pt/metropolis"
    e = float(energy(p.problem, torch.as_tensor(np.concatenate(
        [np.where(sol.variables["assignment"].ravel() > 0, 1.0, -1.0),
         np.ones(p.problem.n_padded - 16)]), dtype=torch.float32)))
    assert sol.energy == pytest.approx(e, rel=1e-5)


def test_templates_build_on_the_card_by_default(monkeypatch):
    """No device given: the encoder asks for the card, and without one the
    constructor raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = PP.TSPProblem()
    p.generate_random_instance(n_cities=4, seed=0)
    assert p.device is None
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        p.encode_to_ising()
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        PP.MaxCutProblem(weights=np.ones((3, 3))).encode_to_ising()


# ---- the captured drivers' cache: the seed is not part of the key ---------

def test_benchmark_instance_captures_once_and_trials_equal_fresh_calls():
    graphs.clear_caches()
    p = PP.TSPProblem(device="cpu")
    p.generate_random_instance(n_cities=5, seed=3)
    cfg = SAConfig(n_sweeps=100, n_replicas=8, use_kernel="never", seed=5,
                   record_interval=25)
    stats = p.benchmark_instance(cfg, n_trials=5)
    assert len(graphs.SA_CACHE) == 1
    assert stats["n_trials"] == 5 and stats["feasibility_rate"] == 1.0
    cached = [anneal(p.problem, dataclasses.replace(cfg, seed=cfg.seed + t))
              for t in range(5)]
    assert len(graphs.SA_CACHE) == 1
    objectives = []
    for t, res in enumerate(cached):
        graphs.clear_caches()
        fresh = anneal(p.problem, dataclasses.replace(cfg, seed=cfg.seed + t))
        assert res.seed == fresh.seed == cfg.seed + t
        np.testing.assert_array_equal(res.best_spins, fresh.best_spins)
        assert res.best_energy == fresh.best_energy
        np.testing.assert_array_equal(res.energy_history,
                                      fresh.energy_history)
        np.testing.assert_array_equal(res.replica_best_energy,
                                      fresh.replica_best_energy)
        objectives.append(p.decode_solution(fresh.best_spins).objective_value)
    assert stats["best_objective"] == min(objectives)
    assert len({r.best_energy for r in cached}) > 1   # the seeds differ


def test_pt_run_cache_ignores_the_seed():
    graphs.clear_caches()
    _, p = grid_tsp(4, span=8, device="cpu")
    cfg = pt.PTConfig(n_replicas=4, n_sweeps=20, exchange_interval=5,
                      use_kernel="never", seed=1)
    first = pt.run(p, cfg)
    kept = {k: np.copy(getattr(first, k)) for k in (
        "best_spins", "replica_best_energy", "energy_history")}
    runs = [first, pt.run(p, dataclasses.replace(cfg, seed=2))]
    assert len(graphs.PT_CACHE) == 1
    for k, v in kept.items():   # the second call left the first's arrays
        np.testing.assert_array_equal(getattr(first, k), v)
    graphs.clear_caches()
    fresh = pt.run(p, dataclasses.replace(cfg, seed=2))
    np.testing.assert_array_equal(runs[1].best_spins, fresh.best_spins)
    np.testing.assert_array_equal(runs[1].energy_history,
                                  fresh.energy_history)
    assert runs[1].seed == 2
