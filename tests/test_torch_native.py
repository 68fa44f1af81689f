"""Port parity for the host C++ routines (``spinglass_tpu_torch.native``)
against ``spinglass_tpu.native``, which g++ builds here too, and against
the port's own numpy versions (forced by taking the loader away): every
wrapper gives the same arrays bit for bit; the problem path's callers
(``core.topology``'s colourings, ``kernels.sparse.build_ell`` under
``EllProblem.from_coo``, ``IsingProblem.from_terms``) go through the C++
library and equal the JAX package's functions; two processes building the
library at once into an empty directory both load a whole one."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu import native as jax_native  # noqa: E402
from spinglass_tpu.core import topology as jax_topology  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.kernels import sparse as jax_sparse  # noqa: E402
from spinglass_tpu_torch import native  # noqa: E402
from spinglass_tpu_torch.benchmarks.native_host import numpy_path  # noqa: E402
from spinglass_tpu_torch.core import constraints  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels.sparse import EllProblem  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _both(fn, *args, **kwargs):
    """(the C++ path's result, the numpy path's result: the loader taken
    away, as on a host with no compiler) of a port wrapper, each counted
    once in native.CALLS under its path."""
    name = fn.__name__
    before = dict(native.CALLS)
    got = fn(*args, **kwargs)
    with numpy_path():
        fallback = fn(*args, **kwargs)
    new = {k: v - before.get(k, 0) for k, v in native.CALLS.items()
           if v != before.get(k, 0)}
    assert sorted(p for _, p in new) == ["native", "numpy"], (name, new)
    assert all(v == 1 for v in new.values())
    return got, fallback


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


def _coo(n, degree, seed, dist="gaussian"):
    return topology.sparse_random_graph_coo(n, avg_degree=degree, dist=dist,
                                            seed=seed)


def _csr(rows, cols, n):
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows[order] + 1, 1)
    return np.cumsum(indptr), cols[order].astype(np.int64)


def test_the_library_builds_in_the_package():
    """g++ builds the port's copy of kernels.cpp here, into the package's
    build directory under a name hashed over the source, the command and
    the host's -march=native; the copy has the JAX source's six C
    functions."""
    assert native.available() and native.BACKEND == "native"
    path = native.library_path("g++")
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR == str(
        ROOT / "spinglass_tpu_torch" / "build")
    assert os.path.basename(path).startswith("native-")
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC")
    assert native.native_target("g++").split()[0].startswith("-march=")
    lib = native.get_lib()
    for fn in ("build_ell", "greedy_coloring", "greedy_coloring_balanced",
               "cardinality_terms", "at_most_one_pairs",
               "scatter_add_symmetric"):
        assert hasattr(lib, fn)


@pytest.mark.parametrize("n,degree,k,seed", [
    (100, 4.0, 16, 0), (300, 6.0, 3, 1), (513, 6.0, 1, 2), (64, 10.0, 30, 3)])
def test_build_ell_bitwise(n, degree, k, seed):
    """build_ell on symmetric COO (k below the degree truncates; max_degree
    counts what was dropped; rows past n_pad are skipped) equals the JAX
    package's native build_ell and the port's numpy version."""
    rows, cols, vals = _coo(n, degree, seed)
    n_pad = ((n + 127) // 128) * 128
    rows = np.concatenate([rows, [n_pad, -1]])  # skipped by both
    cols = np.concatenate([cols, [0, 0]])
    vals = np.concatenate([vals, [1.0, 1.0]])
    got, fallback = _both(native.build_ell, rows, cols, vals, n_pad, k)
    want = jax_native.build_ell(rows, cols, vals, n_pad, k)
    _equal(got, want)
    _equal(fallback, want)
    idx, val, max_deg = got
    assert idx.dtype == np.int32 and val.dtype == np.float32
    assert max_deg == int(np.bincount(rows[(rows >= 0) & (rows < n_pad)]).max())
    if k < max_deg:
        assert (val != 0).sum(axis=1).max() == k


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("n,degree,seed", [(200, 4.0, 0), (1000, 8.0, 1)])
def test_greedy_coloring_csr_bitwise(n, degree, seed, balanced):
    """Both colourings of a CSR adjacency (plain: first fit; balanced: the
    smallest opened class) equal the JAX package's native ones and the
    port's numpy loop, and colour properly."""
    rows, cols, _ = _coo(n, degree, seed)
    indptr, indices = _csr(rows, cols, n)
    got, fallback = _both(native.greedy_coloring_csr, indptr, indices, n,
                          64, balanced=balanced)
    want = jax_native.greedy_coloring_csr(indptr, indices, n, 64,
                                          balanced=balanced)
    _equal(got, want)
    _equal(fallback, want)
    assert got.dtype == np.int64 and np.all(got[rows] != got[cols])


@pytest.mark.parametrize("balanced", [False, True])
def test_greedy_coloring_overflow_raises_on_the_numpy_path(balanced):
    """A clique of 12 needs 12 colours: with max_colors 5 the numpy path
    raises the JAX message too."""
    j = topology.fully_connected(12, dist="binary", seed=0)
    rows, cols = np.nonzero(j)
    indptr, indices = _csr(rows, cols, 12)
    name = "greedy_coloring_balanced" if balanced else "greedy_coloring"
    before = native.CALLS[(name, "numpy")]
    with numpy_path(), pytest.raises(ValueError,
                                     match="graph needs >5 colors"):
        native.greedy_coloring_csr(indptr, indices, 12, 5, balanced=balanced)
    assert native.CALLS[(name, "numpy")] == before + 1


@pytest.mark.parametrize("balanced", [False, True])
def test_greedy_coloring_overflow_raises_natively(balanced):
    j = topology.fully_connected(12, dist="binary", seed=0)
    rows, cols = np.nonzero(j)
    indptr, indices = _csr(rows, cols, 12)
    for fn in (native.greedy_coloring_csr, jax_native.greedy_coloring_csr):
        with pytest.raises(ValueError, match="graph needs >5 colors"):
            fn(indptr, indices, 12, 5, balanced=balanced)
    with pytest.raises(ValueError, match="use the blocked sweep"):
        topology.greedy_coloring(j, max_colors=5)
    with pytest.raises(ValueError, match="graph needs >5 colors"):
        topology.greedy_coloring_coo(rows, cols, 12, max_colors=5,
                                     balanced=balanced)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cardinality_terms_batch_bitwise(seed):
    """Many exactly-k constraints expanded at once equal the JAX native
    expansion, the port's numpy version and the port's per-constraint
    compiler (core.constraints.quadratic_penalty_terms)."""
    rng = np.random.default_rng(seed)
    supports = [rng.choice(60, size=m, replace=False)
                for m in rng.integers(2, 9, 7)]
    ks = np.array([rng.integers(0, len(s) + 1) for s in supports])
    ws = rng.uniform(0.5, 3.0, len(supports))
    got, fallback = _both(native.cardinality_terms_batch, supports, ks, ws)
    want = jax_native.cardinality_terms_batch(supports, ks, ws)
    _equal(got, want)
    _equal(fallback, want)
    ref = constraints.Terms.concat([
        constraints.quadratic_penalty_terms(s, np.ones(len(s)),
                                            2.0 * k - len(s), w)
        for s, k, w in zip(supports, ks, ws)])
    qi, qj, qv, li, lv, const = got
    np.testing.assert_array_equal(qi, ref.quad_i)
    np.testing.assert_array_equal(qj, ref.quad_j)
    np.testing.assert_allclose(qv, ref.quad_v, rtol=1e-12)
    np.testing.assert_array_equal(li, ref.lin_i)
    np.testing.assert_allclose(lv, ref.lin_v, rtol=1e-12)
    assert const == pytest.approx(ref.const, rel=1e-12)
    empty = native.cardinality_terms_batch([], np.zeros(0), np.zeros(0))
    _equal(empty, jax_native.cardinality_terms_batch([], np.zeros(0),
                                                      np.zeros(0)))


@pytest.mark.parametrize("n,terms,seed", [(40, 300, 5), (129, 5000, 6)])
def test_scatter_add_symmetric_bitwise(n, terms, seed):
    """J accumulated from Gaussian terms with repeated, reversed, diagonal
    and out-of-range pairs: the numpy version adds in the C++ order, so
    both equal the JAX native scatter bit for bit."""
    rng = np.random.default_rng(seed)
    qi = rng.integers(0, n, terms)
    qj = rng.integers(0, n, terms)
    qi[:20], qj[:20] = qj[20:40], qi[20:40]  # reversed pairs
    qi[-3:] = [n, -1, 0]                     # skipped
    qj[-3:] = [0, 0, n + 5]
    qv = rng.normal(size=terms)
    got, fallback = _both(native.scatter_add_symmetric, qi, qj, qv, n)
    want = jax_native.scatter_add_symmetric(qi, qj, qv, n)
    _equal(got, want)
    _equal(fallback, want)
    assert np.array_equal(got, got.T) and not np.diag(got).any()


def test_from_terms_equals_jax():
    """IsingProblem.from_terms (the scatter through native) gives the JAX
    package's J and h exactly."""
    rng = np.random.default_rng(9)
    n = 150
    qi, qj = rng.integers(0, n, 2000), rng.integers(0, n, 2000)
    qv = rng.normal(size=2000) / 8
    li, lv = rng.integers(0, n, 300), rng.normal(size=300)
    before = native.CALLS[("scatter_add_symmetric", "native")]
    ours = IsingProblem.from_terms(n, qi, qj, qv, li, lv, device="cpu")
    assert native.CALLS[("scatter_add_symmetric", "native")] == before + 1
    ref = JaxProblem.from_terms(n, qi, qj, qv, li, lv)
    assert ours.n_padded == ref.n_padded
    np.testing.assert_array_equal(ours.j.numpy(), np.asarray(ref.j))
    np.testing.assert_array_equal(ours.h.numpy(), np.asarray(ref.h))


@pytest.mark.parametrize("balanced", [False, True])
def test_coloring_coo_at_10k_goes_through_native(balanced):
    """greedy_coloring_coo on a 10k-spin graph is native's colouring (one
    native call, no numpy one) and equals the JAX function's."""
    rows, cols, _ = _coo(10000, 6.0, 42)
    before = dict(native.CALLS)
    got = topology.greedy_coloring_coo(rows, cols, 10000, balanced=balanced)
    new = {k: v - before.get(k, 0) for k, v in native.CALLS.items()
           if v != before.get(k, 0)}
    name = "greedy_coloring_balanced" if balanced else "greedy_coloring"
    assert new == {(name, "native"): 1}
    want = jax_topology.greedy_coloring_coo(rows, cols, 10000,
                                            balanced=balanced)
    _equal(got, want)


def test_dense_coloring_goes_through_native():
    """greedy_coloring of a dense J (make_engine's choice) is native's
    colouring of its non-zeros and equals the JAX function's."""
    j = jax_topology.random_graph(300, density=0.05, seed=3)
    before = native.CALLS[("greedy_coloring", "native")]
    got = topology.greedy_coloring(j)
    assert native.CALLS[("greedy_coloring", "native")] == before + 1
    _equal(got, jax_topology.greedy_coloring(j))


def test_ell_from_coo_at_10k_goes_through_native():
    """EllProblem.from_coo at 10k spins builds its ELL arrays through
    native.build_ell and equals the JAX EllProblem.from_coo."""
    rows, cols, vals = _coo(10000, 6.0, 7)
    h = np.random.default_rng(7).normal(size=10000)
    before = native.CALLS[("build_ell", "native")]
    ours = EllProblem.from_coo(10000, rows, cols, vals, h=h, device="cpu")
    assert native.CALLS[("build_ell", "native")] == before + 1
    ref = jax_sparse.EllProblem.from_coo(10000, rows, cols, vals, h=h)
    for name in ("idx", "val", "h", "active_mask"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert ours.n_spins == ref.n_spins


_BUILD = """
import sys
from spinglass_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
lib = native.get_lib()
import numpy as np
idx, val, deg = native.build_ell(np.array([0, 1]), np.array([1, 0]),
                                 np.array([0.5, 0.5]), 128, 2)
print(native.BACKEND, native.library_path("g++"), deg, float(val[0, 0]))
"""


def test_two_processes_build_at_once(tmp_path):
    """Two processes that find an empty build directory both compile, each
    into a file of its own renamed into place, and both load a whole
    library at the one hashed path; no partial file is left."""
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build_dir)],
                              cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1, lines
    backend, path, deg, v = lines.pop().split()
    assert backend == "native" and deg == "1" and v == "0.5"
    assert os.path.dirname(path) == str(build_dir)
    assert os.listdir(build_dir) == [os.path.basename(path)]


def test_native_host_benchmark_compares_both_paths():
    """benchmarks/native_host.compare times each host step once through the
    C++ library and once through numpy (its context puts the loader back)
    and finds the same arrays; main's JSON carries the seconds."""
    from spinglass_tpu_torch.benchmarks import native_host

    real = native.get_lib
    res = native_host.compare(3000, seed=1)
    assert native.get_lib is real
    assert set(res) == {"coloring", "coloring_balanced", "build_ell"}
    for r in res.values():
        assert r["same"] is True and r["native_s"] > 0 and r["numpy_s"] > 0
    assert native_host.main(["2000"]) == 0


@pytest.mark.parametrize("indptr,indices", [
    ([0, 1, 2], [1, 2]),       # a neighbour past n
    ([0, 1, 2], [1, -1]),      # a negative neighbour
    ([0, 2, 1], [1, 0]),       # indptr falls
    ([0, 1], [1]),             # indptr one short
    ([0, 1, 3], [1, 0]),       # indptr past the indices
])
def test_greedy_coloring_rejects_a_bad_csr(indptr, indices):
    """An adjacency that is not n vertices' CSR raises before the C++ loop
    (which would read out of bounds) on both paths."""
    indptr, indices = np.array(indptr), np.array(indices)
    with pytest.raises(ValueError, match="CSR adjacency of 2"):
        native.greedy_coloring_csr(indptr, indices, 2)
    with numpy_path(), pytest.raises(ValueError, match="CSR adjacency of 2"):
        native.greedy_coloring_csr(indptr, indices, 2)
