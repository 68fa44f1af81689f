"""Coupling-topology generators, graph analysis and greedy graph colouring
(numpy).

A copy of ``spinglass_tpu.core.topology``: the same seeds give the same
matrices and COO lists, so a test can build one instance and hand it to both
packages.
The port keeps its own copy because importing ``spinglass_tpu`` pulls in
JAX, which the GPU machine does not have. The native C++ colourings are not
ported; the pure-Python greedy colourings below are the JAX package's
reference implementations and give the native output (10k spins, average
degree 6: 0.06 s).
"""

from __future__ import annotations

import numpy as np


def _sample(rng: np.random.Generator, size: int, dist: str, scale: float) -> np.ndarray:
    if dist == "gaussian":
        return rng.normal(0.0, scale, size)
    if dist == "uniform":
        return rng.uniform(-scale, scale, size)
    if dist == "binary":  # +-J spin glass
        return scale * rng.choice([-1.0, 1.0], size)
    if dist == "ferromagnetic":
        return np.full(size, scale)
    raise ValueError(f"unknown coupling distribution: {dist}")


def _from_edges(n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
    j = np.zeros((n, n))
    j[rows, cols] = vals
    j[cols, rows] = vals
    np.fill_diagonal(j, 0.0)
    return j


def fully_connected(n: int, *, dist: str = "gaussian", scale: float = 1.0,
                    seed: int = 0) -> np.ndarray:
    """All-pairs couplings (SK glass for ``dist="gaussian"``)."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    vals = _sample(rng, len(iu[0]), dist, scale)
    return _from_edges(n, iu[0], iu[1], vals)


def chain(n: int, *, periodic: bool = False, dist: str = "binary", scale: float = 1.0,
          seed: int = 0) -> np.ndarray:
    """1D nearest-neighbour chain, or ring when ``periodic``."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n - 1)
    cols = rows + 1
    if periodic and n > 2:
        rows = np.concatenate([rows, [n - 1]])
        cols = np.concatenate([cols, [0]])
    vals = _sample(rng, len(rows), dist, scale)
    return _from_edges(n, rows, cols, vals)


def grid_2d(width: int, height: int, *, periodic: bool = False,
            dist: str = "binary", scale: float = 1.0, seed: int = 0) -> np.ndarray:
    """2D nearest-neighbour grid: bipartite, so 2-colourable."""
    rng = np.random.default_rng(seed)
    n = width * height
    idx = np.arange(n).reshape(height, width)
    rows_l, cols_l = [], []
    rows_l.append(idx[:, :-1].ravel()); cols_l.append(idx[:, 1:].ravel())
    rows_l.append(idx[:-1, :].ravel()); cols_l.append(idx[1:, :].ravel())
    if periodic:
        if width > 2:
            rows_l.append(idx[:, -1].ravel()); cols_l.append(idx[:, 0].ravel())
        if height > 2:
            rows_l.append(idx[-1, :].ravel()); cols_l.append(idx[0, :].ravel())
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = _sample(rng, len(rows), dist, scale)
    return _from_edges(n, rows, cols, vals)


def random_graph(n: int, *, density: float = 0.1, dist: str = "gaussian",
                 scale: float = 1.0, seed: int = 0) -> np.ndarray:
    """Erdos-Renyi G(n, p) couplings."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, k=1)
    keep = rng.random(len(iu[0])) < density
    rows, cols = iu[0][keep], iu[1][keep]
    vals = _sample(rng, len(rows), dist, scale)
    return _from_edges(n, rows, cols, vals)


def small_world(n: int, *, k: int = 4, rewire_prob: float = 0.1,
                dist: str = "gaussian", scale: float = 1.0, seed: int = 0) -> np.ndarray:
    """Watts-Strogatz small world: a ring lattice of k neighbours, each edge
    rewired to a uniform non-self target with probability ``rewire_prob``."""
    rng = np.random.default_rng(seed)
    edges = set()
    for i in range(n):
        for off in range(1, k // 2 + 1):
            jn = (i + off) % n
            edges.add((min(i, jn), max(i, jn)))
    edges = sorted(edges)
    out = set()
    for (a, b) in edges:
        if rng.random() < rewire_prob:
            for _ in range(8):
                c = int(rng.integers(0, n))
                e = (min(a, c), max(a, c))
                if c != a and e not in out:
                    out.add(e)
                    break
            else:
                out.add((a, b))
        else:
            out.add((a, b))
    rows = np.array([e[0] for e in sorted(out)], dtype=np.int64)
    cols = np.array([e[1] for e in sorted(out)], dtype=np.int64)
    vals = _sample(rng, len(rows), dist, scale)
    return _from_edges(n, rows, cols, vals)


def scale_free(n: int, *, m: int = 3, dist: str = "gaussian", scale: float = 1.0,
               seed: int = 0) -> np.ndarray:
    """Barabasi-Albert preferential attachment, m edges per new vertex."""
    rng = np.random.default_rng(seed)
    m = max(1, min(m, n - 1))
    targets = list(range(m))
    repeated: list[int] = []
    rows_l, cols_l = [], []
    for v in range(m, n):
        for t in set(targets):
            rows_l.append(min(v, t)); cols_l.append(max(v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        if len(repeated) > 0:
            targets = [int(repeated[int(rng.integers(0, len(repeated)))]) for _ in range(m)]
    rows = np.array(rows_l, dtype=np.int64)
    cols = np.array(cols_l, dtype=np.int64)
    vals = _sample(rng, len(rows), dist, scale)
    return _from_edges(n, rows, cols, vals)


def sparse_random_graph_coo(n: int, *, avg_degree: float = 6.0,
                            dist: str = "binary", scale: float = 1.0,
                            seed: int = 0):
    """Large sparse Erdos-Renyi instance as COO, with no dense [N, N]
    intermediate (the path for 10k+ spins).

    Returns (rows, cols, vals) with BOTH directions present (symmetric)."""
    rng = np.random.default_rng(seed)
    n_edges = int(n * avg_degree / 2)
    a = rng.integers(0, n, int(n_edges * 1.3))
    b = rng.integers(0, n, int(n_edges * 1.3))
    keep = a != b
    a, b = a[keep], b[keep]
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    uniq = np.unique(lo * n + hi)[:n_edges]
    lo, hi = uniq // n, uniq % n
    vals = _sample(rng, len(lo), dist, scale)
    rows = np.concatenate([lo, hi])
    cols = np.concatenate([hi, lo])
    return rows.astype(np.int64), cols.astype(np.int64), np.tile(vals, 2)


def greedy_coloring_coo(rows: np.ndarray, cols: np.ndarray, n: int,
                        max_colors: int = 256,
                        balanced: bool = False) -> np.ndarray:
    """Greedy colouring straight from symmetric COO (no dense matrix),
    highest degree first.

    balanced=True picks, among the feasible colours already opened, the one
    with the smallest class so far, and opens a new colour only when every
    opened one is blocked: the sorted sparse layouts pad each colour span,
    so even classes waste less. Raises ``ValueError`` beyond ``max_colors``.
    """
    order = np.argsort(rows, kind="stable")
    r_s, c_s = np.asarray(rows)[order], np.asarray(cols)[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, r_s + 1, 1)
    indptr = np.cumsum(indptr)
    colors = np.full(n, -1, dtype=np.int64)
    deg = np.diff(indptr)
    class_size = np.zeros(max_colors, np.int64)
    for v in np.argsort(-deg, kind="stable"):
        nb = c_s[indptr[v]:indptr[v + 1]]
        used = set(colors[nb][colors[nb] >= 0].tolist())
        if balanced:
            opened = int(np.count_nonzero(class_size))
            feasible = [c for c in range(opened) if c not in used]
            if feasible:
                c = min(feasible, key=lambda c: (class_size[c], c))
            elif opened < max_colors:
                c = opened
            else:
                raise ValueError(f"graph needs >{max_colors} colors")
        else:
            c = 0
            while c in used:
                c += 1
            if c >= max_colors:
                raise ValueError(f"graph needs >{max_colors} colors")
        colors[v] = c
        class_size[c] += 1
    return colors


def density(j: np.ndarray) -> float:
    """Fraction of the N(N-1)/2 pairs that carry a non-zero coupling."""
    n = j.shape[0]
    nnz = np.count_nonzero(np.triu(j, k=1))
    total = n * (n - 1) // 2
    return nnz / total if total else 0.0


def degrees(j: np.ndarray) -> np.ndarray:
    return np.count_nonzero(j, axis=1)


def neighbors(j: np.ndarray, i: int) -> np.ndarray:
    return np.nonzero(j[i])[0]


def to_networkx(j: np.ndarray):
    """Coupling graph as a networkx.Graph with 'weight' edge attributes.
    Imports networkx when called."""
    import networkx as nx

    g = nx.Graph()
    n = j.shape[0]
    g.add_nodes_from(range(n))
    rows, cols = np.nonzero(np.triu(j, k=1))
    g.add_weighted_edges_from(
        (int(a), int(b), float(j[a, b])) for a, b in zip(rows, cols))
    return g


def greedy_coloring(j: np.ndarray, max_colors: int = 256) -> np.ndarray:
    """Greedy vertex colouring of the coupling graph, highest degree first.

    Returns color[i] in [0, n_colors). No edge joins two same-colour
    vertices, so a sweep may propose flips for a whole colour class at once
    with exact Metropolis semantics. Raises ``ValueError`` when more than
    ``max_colors`` colours are needed (dense J: use the blocked sweep).
    """
    n = j.shape[0]
    colors = np.full(n, -1, dtype=np.int64)
    order = np.argsort(-np.count_nonzero(j, axis=1), kind="stable")
    adj = [np.nonzero(j[i])[0] for i in range(n)]
    for v in order:
        used = set(colors[adj[v]][colors[adj[v]] >= 0].tolist())
        c = 0
        while c in used:
            c += 1
        if c >= max_colors:
            raise ValueError(
                f"graph needs >{max_colors} colors; use the blocked sweep for dense J")
        colors[v] = c
    return colors
