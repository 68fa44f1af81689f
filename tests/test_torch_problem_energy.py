"""Port parity: problem construction, .npz round trip, conversion from the
JAX package, and the seven energy functions against spinglass_tpu.core.energy.

N=100 spins (padded to 128), R=8 replicas. +-J couplings with h on a
quarter grid make every product exact in float32, so those cases compare
exactly; Gaussian couplings compare at rtol 1e-5 (float32 summation order).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.core import energy as jax_energy  # noqa: E402
from spinglass_tpu.core import topology as jax_topology  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu_torch.core import energy as E  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.convert import problem_from_numpy  # noqa: E402
from spinglass_tpu_torch.core.problem import (  # noqa: E402
    IsingProblem, random_spins, round_up)

N, R = 100, 8


def _instance(dist):
    rng = np.random.default_rng(5)
    if dist == "binary":
        j = topology.fully_connected(N, dist="binary", seed=5)
        h = rng.integers(-8, 9, N) / 4.0
    else:
        j = topology.fully_connected(N, dist="gaussian", scale=0.3, seed=5)
        h = rng.normal(0, 0.5, N)
    spins = np.where(rng.random((R, round_up(N))) < 0.5, -1.0, 1.0)
    spins[:, N:] = 1.0
    return j, h, spins.astype(np.float32)


def test_topology_copies_match_jax_generators():
    for name, kw in (("fully_connected", {"dist": "gaussian"}),
                     ("chain", {"periodic": True}),
                     ("random_graph", {"density": 0.2})):
        ours = getattr(topology, name)(40, seed=3, **kw)
        ref = getattr(jax_topology, name)(40, seed=3, **kw)
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(topology.grid_2d(6, 5, seed=1),
                                  jax_topology.grid_2d(6, 5, seed=1))
    j = topology.random_graph(60, density=0.1, seed=2)
    assert topology.density(j) == jax_topology.density(j)
    np.testing.assert_array_equal(topology.greedy_coloring(j),
                                  jax_topology.greedy_coloring(j))


@pytest.mark.parametrize("name,n,kw", [
    ("small_world", 30, {"k": 4, "rewire_prob": 0.1, "seed": 0}),
    ("small_world", 41, {"k": 6, "rewire_prob": 0.5, "seed": 3}),
    ("small_world", 25, {"k": 2, "rewire_prob": 1.0, "dist": "binary", "seed": 9}),
    ("scale_free", 30, {"m": 3, "seed": 0}),
    ("scale_free", 50, {"m": 1, "dist": "binary", "seed": 4}),
    ("scale_free", 12, {"m": 20, "scale": 0.5, "seed": 11}),
])
def test_random_topologies_match_jax_generators(name, n, kw):
    ours = getattr(topology, name)(n, **kw)
    ref = getattr(jax_topology, name)(n, **kw)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


def test_graph_queries_match_jax():
    j = topology.small_world(40, k=4, rewire_prob=0.3, seed=2)
    np.testing.assert_array_equal(topology.degrees(j), jax_topology.degrees(j))
    for i in (0, 7, 39):
        np.testing.assert_array_equal(topology.neighbors(j, i),
                                      jax_topology.neighbors(j, i))
    nx = pytest.importorskip("networkx")
    ours, ref = topology.to_networkx(j), jax_topology.to_networkx(j)
    assert isinstance(ours, nx.Graph)
    assert sorted(ours.nodes) == sorted(ref.nodes)
    assert (sorted(ours.edges(data="weight"))
            == sorted(ref.edges(data="weight")))


def test_from_dense_pads_and_symmetrises():
    a = np.random.default_rng(0).normal(size=(N, N))
    a[3, 3] = 5.0
    h = np.arange(N, dtype=np.float64)
    p = IsingProblem.from_dense(a, h, device="cpu")
    ref = JaxProblem.from_dense(a, h)
    assert p.n_spins == N and p.n_padded == 128 == ref.n_padded
    for ours, theirs in ((p.j, ref.j), (p.h, ref.h),
                         (p.active_mask, ref.active_mask)):
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert torch.equal(p.j, p.j.t()) and float(p.j[3, 3]) == 0.0
    assert float(p.j[N:].abs().sum()) == 0.0 and float(p.active_mask.sum()) == N
    with pytest.raises(ValueError):
        IsingProblem.from_dense(np.ones((3, 4)), device="cpu")
    with pytest.raises(ValueError):
        IsingProblem.from_dense(np.ones((3, 3)), np.ones(2), device="cpu")


def test_from_terms_matches_jax():
    qi, qj, qv = [0, 1, 2, 0], [1, 2, 3, 1], [1.0, -2.0, 0.5, 0.25]
    p = IsingProblem.from_terms(5, qi, qj, qv, lin_i=[0, 4], lin_val=[1.5, -1.0], device="cpu")
    ref = JaxProblem.from_terms(5, qi, qj, qv, lin_i=[0, 4], lin_val=[1.5, -1.0])
    np.testing.assert_array_equal(p.j.numpy(), np.asarray(ref.j))
    np.testing.assert_array_equal(p.h.numpy(), np.asarray(ref.h))


def test_npz_round_trip_with_jax_format(tmp_path):
    j, h, _ = _instance("gaussian")
    ours = IsingProblem.from_dense(j, h, device="cpu")
    ref = JaxProblem.from_dense(j, h)
    ours.save(str(tmp_path / "ours.npz"))
    ref.save(str(tmp_path / "ref.npz"))
    # each package reads the other's file
    a = IsingProblem.load(str(tmp_path / "ref.npz"), device="cpu")
    b = JaxProblem.load(str(tmp_path / "ours.npz"))
    np.testing.assert_array_equal(a.j.numpy(), ours.j.numpy())
    np.testing.assert_array_equal(np.asarray(b.j), np.asarray(ref.j))
    np.testing.assert_array_equal(a.h.numpy(), np.asarray(b.h))
    assert ours.to_dict()["n_spins"] == N and a.n_spins == N


def test_problem_from_numpy_takes_jax_arrays():
    j, h, _ = _instance("binary")
    ref = JaxProblem.from_dense(j, h)
    p = problem_from_numpy(np.asarray(ref.j), np.asarray(ref.h),
                           np.asarray(ref.active_mask), ref.n_spins,
                           device="cpu")
    assert p.n_spins == ref.n_spins and p.n_padded == ref.n_padded
    np.testing.assert_array_equal(p.j.numpy(), np.asarray(ref.j))
    np.testing.assert_array_equal(p.active_mask.numpy(),
                                  np.asarray(ref.active_mask))


def test_random_spins_masked():
    p = IsingProblem.from_dense(np.zeros((N, N)), device="cpu")
    s = random_spins(torch.Generator().manual_seed(0), (R, p.n_padded),
                     p.active_mask)
    assert s.shape == (R, 128) and s.dtype == torch.float32
    assert set(s.unique().tolist()) <= {-1.0, 1.0}
    assert bool((s[:, N:] == 1.0).all())


@pytest.mark.parametrize("dist", ["binary", "gaussian"])
@pytest.mark.parametrize("fn", ["local_fields", "energy", "delta_energy",
                                "energy_t", "magnetization",
                                "energy_decomposition", "energy_gradient"])
def test_energy_functions_match_jax(fn, dist):
    j, h, spins = _instance(dist)
    p = IsingProblem.from_dense(j, h, device="cpu")
    ref = JaxProblem.from_dense(j, h)
    x = spins.T.copy() if fn == "energy_t" else spins
    ours = getattr(E, fn)(p, torch.as_tensor(x))
    theirs = getattr(jax_energy, fn)(ref, x)
    if fn == "energy_decomposition":
        pairs = [(ours[k], theirs[k]) for k in ("total", "interaction",
                                                 "field", "per_spin")]
    else:
        pairs = [(ours, theirs)]
    for a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        if dist == "binary":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
