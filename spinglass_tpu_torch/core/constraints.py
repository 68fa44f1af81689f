"""Penalty-method constraint compiler: constraints -> (linear, quadratic) Ising terms.

A numpy copy of ``spinglass_tpu.core.constraints``: the same constraints
give the same term arrays, so a test can compile one instance with both
packages and compare them array for array. The port keeps its own copy
because importing ``spinglass_tpu`` pulls in JAX, which the GPU machine does
not have. Every constraint expands into flat (index, value) term arrays, and
all terms reach the problem in one scatter-add (``IsingProblem.from_terms``).

Energy bookkeeping convention (matches core/problem.py):
    E = -1/2 sum_ij J_ij s_i s_j - sum_i h_i s_i + const
A penalty P(s) >= 0 is added to E by accumulating
    J_ij -= 2 * (coefficient of s_i s_j in P),  i != j
    h_i  -= (coefficient of s_i in P)
    const += constant part of P

Key expansion (s_i^2 = 1):
    lam * (sum_i c_i s_i - t)^2
      = lam * [ sum_{i!=j} c_i c_j s_i s_j - 2 t sum_i c_i s_i + (sum_i c_i^2 + t^2) ]
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional, Sequence

import numpy as np


class ConstraintType(Enum):
    EQUALITY = "equality"
    INEQUALITY = "inequality"
    CARDINALITY = "cardinality"
    LOGICAL = "logical"
    CUSTOM = "custom"


@dataclass
class Terms:
    """Flat Ising terms contributed by one or more constraints."""

    lin_i: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    lin_v: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    quad_i: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    quad_j: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    quad_v: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    const: float = 0.0

    @staticmethod
    def concat(parts: Sequence["Terms"]) -> "Terms":
        if not parts:
            return Terms()
        return Terms(
            lin_i=np.concatenate([p.lin_i for p in parts]),
            lin_v=np.concatenate([p.lin_v for p in parts]),
            quad_i=np.concatenate([p.quad_i for p in parts]),
            quad_j=np.concatenate([p.quad_j for p in parts]),
            quad_v=np.concatenate([p.quad_v for p in parts]),
            const=float(sum(p.const for p in parts)),
        )


def quadratic_penalty_terms(indices: np.ndarray, coeffs: np.ndarray, target: float,
                            weight: float) -> Terms:
    """Terms for lam * (sum c_i s_i - t)^2 over the given spin indices.

    Vectorized expansion of EqualityConstraint.get_penalty_terms
    (reference core/constraints.py:73-92).
    """
    idx = np.asarray(indices, dtype=np.int64)
    c = np.asarray(coeffs, dtype=np.float64)
    n = len(idx)
    # pairwise i<j within the constraint's support
    iu, ju = np.triu_indices(n, k=1)
    # penalty contains 2*c_i*c_j s_i s_j per unordered pair (sum over i!=j);
    # E-convention: J_ij -= 2 * coeff_of(s_i s_j). Unordered-pair coeff = 2 c_i c_j,
    # and from_terms adds v to both J[i,j] and J[j,i] while E has -1/2 sum_ij, so
    # E gains -v per unordered pair: v = -2 * lam * c_i * c_j.
    quad_v = -2.0 * weight * c[iu] * c[ju]
    # linear: coeff of s_i is -2 t c_i * lam; E has -h_i s_i → h_i = +2 t c_i lam
    lin_v = 2.0 * weight * target * c
    const = weight * (np.sum(c * c) + target * target)
    return Terms(
        lin_i=idx, lin_v=lin_v,
        quad_i=idx[iu], quad_j=idx[ju], quad_v=quad_v,
        const=float(const),
    )


@dataclass
class Constraint:
    """Base constraint (reference core/constraints.py:33-70)."""

    name: str = "constraint"
    weight: float = 1.0

    def terms(self) -> Terms:
        raise NotImplementedError

    def violation(self, spins: np.ndarray) -> float:
        raise NotImplementedError

    def is_satisfied(self, spins: np.ndarray, tol: float = 1e-6) -> bool:
        return abs(self.violation(spins)) <= tol


@dataclass
class EqualityConstraint(Constraint):
    """sum_i c_i s_i == target (reference constraints.py:73-114)."""

    indices: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    coeffs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    target: float = 0.0

    def terms(self) -> Terms:
        return quadratic_penalty_terms(self.indices, self.coeffs, self.target, self.weight)

    def violation(self, spins: np.ndarray) -> float:
        return float(np.dot(self.coeffs, spins[..., self.indices]) - self.target)


@dataclass
class InequalityConstraint(Constraint):
    """sum_i c_i s_i <= bound.

    Like the reference (constraints.py:117-144) this compiles as an equality
    penalty at the bound (no slack variables); violation() is one-sided so
    decode-side accounting stays correct.
    """

    indices: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    coeffs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    bound: float = 0.0

    def terms(self) -> Terms:
        return quadratic_penalty_terms(self.indices, self.coeffs, self.bound, self.weight)

    def violation(self, spins: np.ndarray) -> float:
        v = float(np.dot(self.coeffs, spins[..., self.indices]) - self.bound)
        return max(0.0, v)


@dataclass
class CardinalityConstraint(Constraint):
    """Exactly k of the n binary vars x_i = (1+s_i)/2 are one.

    sum x = k  <=>  sum s = 2k - n (reference constraints.py:147-158; the
    reference folds the x->s Jacobian into a lam/4 weight — we keep the spin-space
    weight explicit and scale identically).
    """

    indices: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    k: int = 1

    def terms(self) -> Terms:
        idx = np.asarray(self.indices, dtype=np.int64)
        n = len(idx)
        target = float(2 * self.k - n)
        return quadratic_penalty_terms(idx, np.ones(n), target, self.weight / 4.0)

    def violation(self, spins: np.ndarray) -> float:
        ones = float(np.sum(spins[..., self.indices] > 0))
        return ones - self.k


class LogicalOp(Enum):
    AND = "and"
    OR = "or"
    NOT = "not"
    XOR = "xor"


@dataclass
class LogicalConstraint(Constraint):
    """z = op(x, y) over binary vars x=(1+s)/2 (reference constraints.py:161-217).

    Standard QUBO gadgets expanded to spin space:
      AND: P = xy - 2(x+y)z + 3z
      OR:  P = xy + (x+y)(1-2z) ... using P = (x+y+z)... we use
           P = 3z + xy - 2xz - 2yz + ... (complement trick via AND on negations)
      NOT: P = 2xz - x - z + 1   (z = 1-x)
      XOR: needs an ancilla in strict QUBO; here penalized as
           P = (x + y + z - 2a)^2 with ancilla index a.
    """

    op: LogicalOp = LogicalOp.AND
    x: int = 0
    y: int = 0
    z: int = 0
    ancilla: Optional[int] = None

    def _binary_penalty_terms(self, pen: dict) -> Terms:
        """Expand a penalty given in binary vars {i: lin}, {(i,j): quad}, const."""
        lin = pen.get("lin", {})
        quad = pen.get("quad", {})
        const = pen.get("const", 0.0)
        # x_i = (1+s_i)/2: lin a*x -> a/2 s + a/2 ; quad b*x_i*x_j ->
        # b/4 (s_i s_j + s_i + s_j + 1)
        lin_acc: dict[int, float] = {}
        quad_acc: dict[tuple, float] = {}
        for i, a in lin.items():
            lin_acc[i] = lin_acc.get(i, 0.0) + a / 2.0
            const += a / 2.0
        for (i, jdx), b in quad.items():
            key = (min(i, jdx), max(i, jdx))
            quad_acc[key] = quad_acc.get(key, 0.0) + b / 4.0
            lin_acc[i] = lin_acc.get(i, 0.0) + b / 4.0
            lin_acc[jdx] = lin_acc.get(jdx, 0.0) + b / 4.0
            const += b / 4.0
        w = self.weight
        li = np.array(list(lin_acc.keys()), dtype=np.int64)
        lv = np.array([w * -v for v in lin_acc.values()])  # E has -h s → h -= coeff
        qi = np.array([k[0] for k in quad_acc], dtype=np.int64)
        qj = np.array([k[1] for k in quad_acc], dtype=np.int64)
        qv = np.array([w * -v for v in quad_acc.values()])  # J gets -coeff (pair conv.)
        return Terms(lin_i=li, lin_v=lv, quad_i=qi, quad_j=qj, quad_v=qv,
                     const=w * const)

    def terms(self) -> Terms:
        x, y, z = self.x, self.y, self.z
        if self.op == LogicalOp.AND:
            pen = {"lin": {z: 3.0}, "quad": {(x, y): 1.0, (x, z): -2.0, (y, z): -2.0}}
        elif self.op == LogicalOp.OR:
            # z = x OR y: P = x + y + z + xy - 2xz - 2yz  ... standard gadget:
            # P = (1-z)(x+y) + xy - z(x+y) + z? Use: P = x + y + z - 2xz - 2yz + xy + ...
            # Verified gadget: P = xy + (x + y)(1 - 2z) + z  (0 iff z = x|y)
            pen = {"lin": {x: 1.0, y: 1.0, z: 1.0},
                   "quad": {(x, y): 1.0, (x, z): -2.0, (y, z): -2.0}}
        elif self.op == LogicalOp.NOT:
            pen = {"lin": {x: -1.0, z: -1.0}, "quad": {(x, z): 2.0}, "const": 1.0}
        elif self.op == LogicalOp.XOR:
            if self.ancilla is None:
                raise ValueError("XOR constraint requires an ancilla spin index")
            a = self.ancilla
            pen = {"lin": {x: 1.0, y: 1.0, z: 1.0, a: 4.0},
                   "quad": {(x, y): 2.0, (x, z): 2.0, (y, z): 2.0,
                            (x, a): -4.0, (y, a): -4.0, (z, a): -4.0}}
        else:
            raise ValueError(self.op)
        return self._binary_penalty_terms(pen)

    def violation(self, spins: np.ndarray) -> float:
        xb = spins[..., self.x] > 0
        yb = spins[..., self.y] > 0
        zb = spins[..., self.z] > 0
        if self.op == LogicalOp.AND:
            want = xb & yb
        elif self.op == LogicalOp.OR:
            want = xb | yb
        elif self.op == LogicalOp.NOT:
            want = ~xb
        else:
            want = xb ^ yb
        return 0.0 if bool(want == zb) else 1.0


@dataclass
class CustomConstraint(Constraint):
    """User-supplied terms + violation fn (reference constraints.py:220-241)."""

    terms_fn: Optional[Callable[[], Terms]] = None
    violation_fn: Optional[Callable[[np.ndarray], float]] = None

    def terms(self) -> Terms:
        t = self.terms_fn() if self.terms_fn else Terms()
        return dataclasses.replace(
            t, lin_v=t.lin_v * self.weight, quad_v=t.quad_v * self.weight,
            const=t.const * self.weight)

    def violation(self, spins: np.ndarray) -> float:
        return self.violation_fn(spins) if self.violation_fn else 0.0


class ConstraintCompiler:
    """Accumulates constraints and compiles them into term arrays.

    Replaces ConstraintEncoder (reference core/constraints.py:244-423): instead of
    mutating a model per constraint, collect everything and scatter once.
    """

    def __init__(self) -> None:
        self.constraints: List[Constraint] = []

    def add(self, c: Constraint) -> "ConstraintCompiler":
        self.constraints.append(c)
        return self

    def compile(self) -> Terms:
        return Terms.concat([c.terms() for c in self.constraints])

    def total_violation(self, spins: np.ndarray) -> float:
        return float(sum(abs(c.violation(spins)) for c in self.constraints))

    def count_violations(self, spins: np.ndarray, tol: float = 1e-6) -> int:
        return sum(0 if c.is_satisfied(spins, tol) else 1 for c in self.constraints)

    def violation_report(self, spins: np.ndarray) -> dict:
        """Per-constraint violations (reference constraints.py:312-330)."""
        return {c.name: c.violation(spins) for c in self.constraints}

    def find_feasible(self, n_spins: int, n_attempts: int = 1000,
                      seed: int = 0):
        """Random search for a feasible configuration (reference
        constraints.py:332-358). Returns spins or None."""
        rng = np.random.default_rng(seed)
        for _ in range(n_attempts):
            s = rng.choice([-1.0, 1.0], n_spins)
            if self.count_violations(s) == 0:
                return s
        return None


def binary_quadratic_terms(
    quad_i=None, quad_j=None, quad_v=None,
    lin_i=None, lin_v=None, const: float = 0.0,
) -> Terms:
    """Convert a QUBO objective in BINARY vars x=(1+s)/2 into spin Terms.

    min sum q_ij x_i x_j + sum a_i x_i + c. Expansion per ordered listed term:
      q x_i x_j -> (q/4) s_i s_j + (q/4) s_i + (q/4) s_j + q/4
      a x_i     -> (a/2) s_i + a/2
    mapped into the E-convention (quad term value v contributes -v s_i s_j,
    lin value v contributes -v s_i — see module docstring). Vectorized; this is
    the shared encoder primitive every problems/ module uses instead of the
    reference's per-coupling model mutation."""
    parts = []
    if quad_i is not None and len(quad_i):
        qi = np.asarray(quad_i, np.int64)
        qj = np.asarray(quad_j, np.int64)
        qv = np.asarray(quad_v, np.float64)
        lin_idx = np.concatenate([qi, qj])
        lin_val = np.concatenate([qv, qv]) / 4.0
        parts.append(Terms(
            lin_i=lin_idx, lin_v=-lin_val,
            quad_i=qi, quad_j=qj, quad_v=-qv / 4.0,
            const=float(np.sum(qv) / 4.0)))
    if lin_i is not None and len(lin_i):
        li = np.asarray(lin_i, np.int64)
        lv = np.asarray(lin_v, np.float64)
        parts.append(Terms(lin_i=li, lin_v=-lv / 2.0,
                           const=float(np.sum(lv) / 2.0)))
    out = Terms.concat(parts) if parts else Terms()
    out.const += const
    return out


def penalty_energy(terms: Terms, spins: np.ndarray) -> float:
    """Evaluate the penalty contribution of compiled terms on a spin config
    (host-side check; useful for tests). Uses the E-convention above."""
    s = np.asarray(spins, dtype=np.float64)
    e = -np.sum(terms.lin_v * s[..., terms.lin_i])
    e += -np.sum(terms.quad_v * s[..., terms.quad_i] * s[..., terms.quad_j])
    return float(e + terms.const)
