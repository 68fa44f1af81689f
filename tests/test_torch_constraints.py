"""Port parity: the constraint compiler (``spinglass_tpu_torch.core.constraints``)
against the JAX package's (``spinglass_tpu.core.constraints``).

Both packages compile the same constraints from the same numpy inputs; every
``Terms`` array must be equal element for element, and the host-side checks
(violations, penalty energy, reports, the feasible-point search) must give
the same numbers.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.core import constraints as JC  # noqa: E402
from spinglass_tpu_torch.core import constraints as PC  # noqa: E402

TERM_FIELDS = ("lin_i", "lin_v", "quad_i", "quad_j", "quad_v")


def _build(C, kind: str):
    """One constraint of ``kind`` from module ``C`` (fixed, seeded inputs)."""
    rng = np.random.default_rng(KINDS.index(kind))
    idx = np.array([0, 2, 3, 5, 7, 8])
    coeffs = rng.integers(-3, 4, len(idx)).astype(np.float64)
    if kind == "equality":
        return C.EqualityConstraint(name="eq", indices=idx, coeffs=coeffs,
                                    target=2.0, weight=1.5)
    if kind == "inequality":
        return C.InequalityConstraint(name="ineq", indices=idx, coeffs=coeffs,
                                      bound=1.0, weight=0.75)
    if kind == "cardinality":
        return C.CardinalityConstraint(name="card", indices=idx, k=2,
                                       weight=3.0)
    if kind.startswith("logical_"):
        op = getattr(C.LogicalOp, kind.split("_")[1].upper())
        return C.LogicalConstraint(name=kind, op=op, x=1, y=4, z=6,
                                   ancilla=9 if op == C.LogicalOp.XOR else None,
                                   weight=2.0)
    if kind == "custom":
        def terms():
            return C.binary_quadratic_terms(
                np.array([0, 1, 2]), np.array([3, 4, 5]),
                np.array([1.0, -2.0, 0.5]), np.array([6, 7]),
                np.array([0.25, -1.0]), const=0.5)

        return C.CustomConstraint(
            name="custom", weight=1.25, terms_fn=terms,
            violation_fn=lambda s: float(np.sum(np.asarray(s)[[0, 1]] > 0)))
    raise ValueError(kind)


KINDS = ["equality", "inequality", "cardinality", "logical_and", "logical_or",
         "logical_not", "logical_xor", "custom"]


def _assert_terms_equal(mine, theirs):
    for f in TERM_FIELDS:
        a, b = getattr(mine, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert mine.const == theirs.const


def _spins(n=10, count=16, seed=0):
    return np.random.default_rng(seed).choice([-1.0, 1.0], (count, n))


@pytest.mark.parametrize("kind", KINDS)
def test_constraint_terms_equal_jax(kind):
    _assert_terms_equal(_build(PC, kind).terms(), _build(JC, kind).terms())


@pytest.mark.parametrize("kind", KINDS)
def test_constraint_violation_and_penalty_energy_equal_jax(kind):
    mine, theirs = _build(PC, kind), _build(JC, kind)
    t_mine, t_theirs = mine.terms(), theirs.terms()
    for s in _spins():
        assert mine.violation(s) == theirs.violation(s)
        assert mine.is_satisfied(s) == theirs.is_satisfied(s)
        assert PC.penalty_energy(t_mine, s) == JC.penalty_energy(t_theirs, s)


@pytest.mark.parametrize("kind", ["equality", "cardinality", "logical_and",
                                  "logical_or", "logical_not", "logical_xor"])
def test_penalty_is_zero_exactly_when_satisfied(kind):
    """The compiled penalty is >= 0 and vanishes on satisfying spins (the
    XOR gadget at its best ancilla), so the encoding is the constraint."""
    c = _build(PC, kind)
    t = c.terms()
    for s in _spins(count=256, seed=3):
        e = PC.penalty_energy(t, s)
        if kind == "logical_xor":
            e = min(e, PC.penalty_energy(t, np.where(np.arange(10) == 9,
                                                     -s, s)))
        assert e >= -1e-9
        assert (abs(e) < 1e-9) == c.is_satisfied(s), (s, e)


def test_xor_needs_an_ancilla():
    with pytest.raises(ValueError, match="ancilla"):
        PC.LogicalConstraint(op=PC.LogicalOp.XOR, x=0, y=1, z=2).terms()


@pytest.mark.parametrize("with_lin", [False, True])
@pytest.mark.parametrize("with_quad", [False, True])
def test_binary_quadratic_terms_equal_jax(with_quad, with_lin):
    rng = np.random.default_rng(5)
    kw = {}
    if with_quad:
        kw.update(quad_i=rng.integers(0, 12, 20), quad_j=rng.integers(0, 12, 20),
                  quad_v=rng.normal(size=20))
    if with_lin:
        kw.update(lin_i=rng.integers(0, 12, 7), lin_v=rng.normal(size=7))
    mine = PC.binary_quadratic_terms(**kw, const=1.5)
    theirs = JC.binary_quadratic_terms(**kw, const=1.5)
    _assert_terms_equal(mine, theirs)
    x = rng.integers(0, 2, (8, 12))
    for row in x:   # the spin terms are the QUBO on x = (1 + s) / 2
        s = 2.0 * row - 1.0
        qubo = 1.5
        if with_quad:
            qubo += np.sum(kw["quad_v"] * row[kw["quad_i"]] * row[kw["quad_j"]])
        if with_lin:
            qubo += np.sum(kw["lin_v"] * row[kw["lin_i"]])
        assert PC.penalty_energy(mine, s) == pytest.approx(qubo, abs=1e-9)


def _compiler(C):
    comp = C.ConstraintCompiler()
    for kind in KINDS:
        comp.add(_build(C, kind))
    return comp


def test_compiler_compile_report_and_counts_equal_jax():
    mine, theirs = _compiler(PC), _compiler(JC)
    _assert_terms_equal(mine.compile(), theirs.compile())
    _assert_terms_equal(PC.Terms.concat([]), JC.Terms.concat([]))
    for s in _spins(seed=7):
        assert mine.violation_report(s) == theirs.violation_report(s)
        assert mine.total_violation(s) == theirs.total_violation(s)
        assert mine.count_violations(s) == theirs.count_violations(s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_feasible_equals_jax(seed):
    def comp(C):
        c = C.ConstraintCompiler()
        c.add(C.CardinalityConstraint(name="a", indices=np.arange(4), k=1))
        c.add(C.CardinalityConstraint(name="b", indices=np.arange(4, 8), k=2))
        return c

    mine = comp(PC).find_feasible(8, n_attempts=200, seed=seed)
    theirs = comp(JC).find_feasible(8, n_attempts=200, seed=seed)
    assert mine is not None and np.array_equal(mine, theirs)
    impossible = PC.ConstraintCompiler().add(PC.CardinalityConstraint(
        name="c", indices=np.arange(3), k=5))
    assert impossible.find_feasible(3, n_attempts=20, seed=seed) is None
