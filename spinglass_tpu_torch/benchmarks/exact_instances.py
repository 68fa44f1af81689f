"""Problem instances whose arithmetic or whose optimum is known exactly.

They hold a kernel bit for bit against its plain twin on an encoded problem,
and a solver against a known optimum.
"""

import numpy as np

from spinglass_tpu_torch.problems import TSPProblem


def grid_tsp(n_cities: int, *, seed: int = 0, span: int = 16,
             template=TSPProblem, **kwargs):
    """TSP on integer points in [0, span)^2 with the Manhattan metric and the
    integer penalty 2 max(d), encoded. Every J and h entry is then a multiple
    of 1/4 (``core/constraints.binary_quadratic_terms``), so every field is
    exact in float32 in any summation order, and in K1's three bf16 planes.

    ``template`` is the TSP class to build (any class with
    ``TSPProblem``'s constructor); ``kwargs`` go to it, e.g. ``device=``.
    Returns the template and its encoded problem."""
    loc = np.random.default_rng(seed).integers(0, span, (n_cities, 2))
    t = template(locations=loc.astype(np.float64), metric="manhattan",
                 **kwargs)
    return t, t.encode_to_ising(penalty_weight=float(
        2 * int(t.distances.max())))


def bipartite_weights(n: int, n_edges: int, seed: int) -> np.ndarray:
    """Unit weights on ``n_edges`` distinct random pairs across the two
    halves of ``n`` nodes: the optimum cut takes every edge, so it equals
    the total weight."""
    rng = np.random.default_rng(seed)
    half = n // 2
    pairs = rng.choice(half * (n - half), size=n_edges, replace=False)
    w = np.zeros((n, n))
    w[pairs // (n - half), half + pairs % (n - half)] = 1.0
    return w + w.T
