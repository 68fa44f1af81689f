"""The SQA cell (``ea2d-l80.sqa``) through the whole harness on the CPU at a
tiny size: a sound run is correct, the lower-precision reference is not,
and each fault fails a check: the state not carried (every stage from
fresh spins), J_perp never rewritten after stage 0, J_perp with its sign
turned, the space couplings not divided by P, a sweep that returns its
state unchanged, half the replicas left out. ``FAULTS`` plants them; the
runs on the card that set the cell's limits plant the same ones."""

import pytest

from portbench import harness
from portbench.tests.test_portbench_check import _faulty

TINY_EA2D = {"L": 8, "seed": 5}
TINY_PARAMS = {"n_trotter": 4, "beta": 4.0, "n_stages": 10,
               "sweeps_per_stage": 6, "n_replicas": 8}
TINY_CHECK = {"chains": 16, "block": 8}
# 60 sweeps on 64 spins end further above the ground state than the cell's
# 10,000 on 6400: the quality limit is the tiny run's, the others the cell's
TINY_LIMITS = {"quality_gap": 0.06}


@pytest.fixture(scope="module")
def tiny_ea2d():
    """The tiny lattice's configuration, its best-known energy the least
    of two deep runs of the program (as the cell's record is made)."""
    from spinglass_tpu_torch.anneal import pt
    from spinglass_tpu_torch.core.topology import lattice_coo
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    p = EllProblem.from_coo(*lattice_coo(TINY_EA2D["L"], dims=2,
                                         dist="uniform", scale=2.0,
                                         seed=TINY_EA2D["seed"]),
                            device="cpu")
    best = min(pt.run(p, pt.PTConfig(
        n_replicas=8, n_sweeps=3000, min_temp=0.05, max_temp=2.5,
        seed=s)).best_energy for s in (1, 2))
    return {"name": "ea2d-l80", "generator": "ea2d",
            "instance": dict(TINY_EA2D, dims=2, periodic=True,
                             dist="uniform", scale=2.0,
                             best_known_energy=best)}


def run_tiny(bench, cfg, control=None, seed=2 ** 31 + 5):
    wl = harness.cell("ea2d-l80.sqa", bench)
    wl = dict(wl, params=dict(wl["params"], **TINY_PARAMS),
              check=dict(wl["check"], **TINY_CHECK),
              limits=dict(wl["limits"], **TINY_LIMITS))
    return harness.run_cell(wl, cfg, bench, seed, 1.0, False, device="cpu",
                            control=control)


def fresh_stages(monkeypatch):
    """Every stage from fresh random spins (the JAX semantics), its final
    spins still decoded."""
    from spinglass_tpu_torch.research import quantum

    drawn = quantum.anneal_drawn

    def fresh(*args, init_spins=None, **kw):
        return drawn(*args, **kw)

    monkeypatch.setattr(quantum, "anneal_drawn", fresh)


def frozen_field(monkeypatch):
    """J_perp written for stage 0 and never again."""
    from spinglass_tpu_torch.research import quantum

    stage = quantum._stage

    def frozen(tp, cfg, k, gamma, generator, draws, carry=None):
        return stage(tp, cfg, 0, gamma, generator, draws, carry)

    monkeypatch.setattr(quantum, "_stage", frozen)


def sign_turned(monkeypatch):
    from spinglass_tpu_torch.research import quantum

    j_perp = quantum.j_perp
    monkeypatch.setattr(quantum, "j_perp", lambda b, g, p: -j_perp(b, g, p))


def undivided(monkeypatch):
    """The space couplings (and the field) of every slice at J, not J/P."""
    import dataclasses

    from spinglass_tpu_torch.research import quantum

    build = quantum._trotterize_ell

    def whole(problem, p, beta, gamma):
        return build(dataclasses.replace(problem, val=problem.val * p,
                                         h=problem.h * p), p, beta, gamma)

    monkeypatch.setattr(quantum, "_trotterize_ell", whole)


def _sweep_fault(kind):
    def plant(monkeypatch):
        from spinglass_tpu_torch.anneal import sa

        monkeypatch.setattr(sa, "make_engine", _faulty(kind))
    return plant


FAULTS = {"fresh_stages": fresh_stages, "frozen_field": frozen_field,
          "sign_turned": sign_turned, "undivided": undivided,
          "unchanged": _sweep_fault("unchanged"),
          "half": _sweep_fault("half")}


def test_a_sound_sqa_run_is_correct(bench, tiny_ea2d):
    from spinglass_tpu_torch.anneal import graphs

    graphs.clear_caches()
    out = run_tiny(bench, tiny_ea2d)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"flips_per_s", "setup_s"}
    assert set(out["checks"]) == {"energy_gap", "action_gap", "quality_gap",
                                  "schedule_gap", "best_not_min", "unmoved"}


def test_the_bf16_reference_is_not_correct(bench, tiny_ea2d):
    out = run_tiny(bench, tiny_ea2d, control="reference_bf16")
    for name in ("energy_gap", "action_gap"):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_sqa_faults_are_not_correct(bench, fault, tiny_ea2d, monkeypatch):
    from spinglass_tpu_torch.anneal import graphs

    graphs.clear_caches()
    FAULTS[fault](monkeypatch)
    out = run_tiny(bench, tiny_ea2d)
    graphs.clear_caches()
    assert not out["correct"], out["checks"]


def test_the_2d_instance_is_the_records(bench):
    """The cell's configuration builds the recorded sample (its hash), and
    the program's lattice is the reference's."""
    import numpy as np

    from portbench.reference import ea2d
    from spinglass_tpu_torch.core.topology import lattice_coo

    cfg = harness.load_json("configs", "ea2d-l80.json")
    inst = ea2d.build(cfg, 7, "cpu")
    assert inst["n"] == 6400 and len(inst["rows"]) == 25600
    spec = cfg["instance"]
    n, rows, cols, vals = lattice_coo(80, dims=2, dist="uniform",
                                      scale=spec["scale"], seed=spec["seed"])
    for a, b in ((rows, inst["rows"]), (cols, inst["cols"]),
                 (vals, inst["vals"])):
        np.testing.assert_array_equal(a, b)
    assert inst["ground_energy"] < -1.5 * 6400
