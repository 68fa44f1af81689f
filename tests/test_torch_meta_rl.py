"""The port's meta-RL tier (``spinglass_tpu_torch.research.meta_rl``) on the
CPU, against ``spinglass_tpu.research.meta_rl``: the strategy codec, the
episodic memory, the architecture search (numpy, so equal), the strategy
network with flax's parameters carried across
(``core.convert.meta_network_from_flax``), its Adam fit against the optax
scan from the same parameters, and the JAX unit tests' behaviour
(``tests/unit/test_meta_rl.py``) on the port.

Tolerances: the codec, the memory and the search are equal. The network's
forward pass agrees to 1e-5 (torch's and XLA's matmuls and LayerNorm round
differently); after 200 Adam steps the fit's loss agrees to 1e-3 relative
and its parameters to 1e-3 absolute (optax and torch.optim.Adam order
their arithmetic differently, and the difference compounds over the
steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.core.problem import IsingProblem as JaxProblem  # noqa: E402
from spinglass_tpu.research import meta_rl as JM  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.convert import meta_network_from_flax  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.research import meta_rl as M  # noqa: E402


def _problem(n=24, seed=0):
    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=seed)
    return IsingProblem.from_dense(j, device="cpu")


def _flax(hidden, seed=0):
    model = JM.MetaLearningNetwork(hidden_sizes=hidden)
    params = model.init(jax.random.key(seed), jnp.zeros((1, M.EMBED_DIM)))
    return model, params, jax.tree_util.tree_map(np.asarray, params)


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, M.EMBED_DIM)).astype(np.float32)
    y = (x @ rng.normal(size=(M.EMBED_DIM, M.STRATEGY_DIM))).astype(np.float32)
    return x, y, rng.uniform(-0.2, 1.0, n).astype(np.float32)


@pytest.mark.parametrize("hidden", [(64, 64), (32,), (16, 128, 32)])
def test_network_forward_equals_flax(hidden):
    model, params, tree = _flax(hidden)
    net = meta_network_from_flax(tree, device="cpu")
    assert net.hidden_sizes == hidden
    x, _, _ = _data()
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    got = net(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert all(n.eps == 1e-6 for n in net.norm)


def test_fit_equals_optax_scan():
    """200 full-batch Adam steps from the same parameters on the same
    score-weighted data: the final loss and parameters agree with the JAX
    scan's."""
    model, params, tree = _flax((32,), seed=3)
    x, y, w = _data(seed=1)
    want_params, want_loss = JM.fit_meta_network(model, x, y, w, n_steps=200,
                                                 params=params)
    net = meta_network_from_flax(tree, device="cpu")
    start = {k: v.detach() for k, v in net.named_parameters()}
    got_params, got_loss = M.fit_meta_network(net, x, y, w, n_steps=200,
                                              params=start)
    assert got_loss == pytest.approx(want_loss, rel=1e-3)
    want = dict(meta_network_from_flax(jax.tree_util.tree_map(
        np.asarray, want_params), device="cpu").named_parameters())
    for k, v in got_params.items():
        np.testing.assert_allclose(v.numpy(), want[k].detach().numpy(),
                                   atol=1e-3, err_msg=k)
    # the parameters passed in are not trained in place
    for k, v in start.items():
        assert torch.equal(v, dict(net.named_parameters())[k])


def test_fit_reduces_loss():
    x, y, _ = _data()
    model = M.MetaLearningNetwork(hidden_sizes=(32,))
    _, short = M.fit_meta_network(model, x, y, np.ones(32), n_steps=5,
                                  device="cpu")
    _, long = M.fit_meta_network(model, x, y, np.ones(32), n_steps=300,
                                 device="cpu")
    assert long < short * 0.5


def test_codec_equals_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        t0, a, m = rng.uniform(0.01, 50), rng.uniform(0.85, 1.0), \
            rng.uniform(0.1, 5)
        np.testing.assert_array_equal(M.encode_strategy(t0, a, m),
                                      JM.encode_strategy(t0, a, m))
        v = rng.normal(0, 3, 3)
        assert M.decode_strategy(v) == JM.decode_strategy(v)
    out = M.decode_strategy(M.encode_strategy(5.0, 0.99, 1.0))
    assert abs(out["initial_temp"] - 5.0) < 1e-6
    assert abs(out["alpha"] - 0.99) < 1e-4


def test_episodic_memory_equals_jax():
    rng = np.random.default_rng(5)
    got, want = M.EpisodicMemory(capacity=6), JM.EpisodicMemory(capacity=6)
    assert got.recall(np.zeros(M.EMBED_DIM)) is None
    for _ in range(15):
        e = rng.normal(size=M.EMBED_DIM)
        s = M.encode_strategy(rng.uniform(1, 9), rng.uniform(0.9, 0.999))
        score = float(rng.uniform(-0.5, 1))
        got.store(e, s, score)
        want.store(e, s, score)
        q = rng.normal(size=M.EMBED_DIM)
        np.testing.assert_array_equal(got.recall(q), want.recall(q))
        assert got.nearest_distance(q) == want.nearest_distance(q)
    assert len(got) == len(want) == 6
    for a, b in zip(got.dataset(), want.dataset()):
        np.testing.assert_array_equal(a, b)


def test_eviction_drops_worst():
    mem = M.EpisodicMemory(capacity=3)
    for i, s in enumerate([0.9, 0.1, 0.8, 0.7]):
        mem.store(np.full(M.EMBED_DIM, i, np.float32),
                  M.encode_strategy(2.0 + i, 0.95), score=s)
    assert len(mem) == 3 and min(e.score for e in mem.episodes) >= 0.7


def test_nas_equals_jax():
    def eval_fn(arch):
        return -abs(sum(arch) - 150) - 0.1 * len(arch)

    got = M.NeuralArchitectureSearch(population=5, generations=3,
                                     seed=4).search(eval_fn)
    want = JM.NeuralArchitectureSearch(population=5, generations=3,
                                       seed=4).search(eval_fn)
    assert (got.architecture, got.score, got.history) == (
        want.architecture, want.score, want.history)


def test_nas_default_eval_fits_on_the_device():
    x, y, w = _data(16)
    score = M.NeuralArchitectureSearch.default_eval(x, y, w, n_steps=10,
                                                    device="cpu")((16,))
    assert np.isfinite(score) and score < 0


def test_characterizer_equals_jax():
    c, jc = M.ProblemCharacterizer(), JM.ProblemCharacterizer()
    js = [topology.fully_connected(n, dist="gaussian", seed=n)
          for n in (16, 32)]
    got = c.characterize_batch([IsingProblem.from_dense(j, device="cpu")
                                for j in js])
    want = jc.characterize_batch([JaxProblem.from_dense(j) for j in js])
    np.testing.assert_array_equal(got, want)
    assert set(c.describe(_problem(16))) == set(c.feature_names)
    assert got[1][0] > got[0][0]


def test_agent_solves_records_and_refits():
    agent = M.AdaptiveMetaRLAgent(M.MetaRLConfig(
        n_sweeps=60, n_replicas=4, refit_interval=4, fit_steps=20),
        device="cpu")
    for i in range(4):
        res, info = agent.solve(_problem(16, seed=i))
        assert np.isfinite(res.best_energy)
        assert info["source"] in ("default", "memory", "network")
    rep = agent.report()
    assert rep["n_solves"] == 4 and rep["memory_size"] == 4
    assert rep["fits"] == 1 and np.isfinite(rep["last_fit_loss"])
    assert rep["architecture"] == (64, 64)


def test_agent_recalls_memory_for_a_repeat_problem():
    agent = M.AdaptiveMetaRLAgent(M.MetaRLConfig(
        n_sweeps=40, n_replicas=4, refit_interval=100, explore_std=0.0),
        device="cpu")
    p = _problem(16, seed=3)
    agent.solve(p)
    _, info = agent.solve(p)
    assert info["source"] == "memory"


def test_agent_proposes_from_its_network_and_searches():
    """Far from every stored episode the fitted network proposes; with
    ``nas_after`` the first refit searches the architecture first."""
    agent = M.AdaptiveMetaRLAgent(M.MetaRLConfig(
        n_sweeps=20, n_replicas=4, refit_interval=4, fit_steps=8,
        recall_distance=0.0, nas_after=4), device="cpu")
    for i in range(4):
        agent.solve(_problem(12, seed=i))
    assert agent.params is not None and len(agent.fit_log) == 1
    _, strat, source = agent.propose(_problem(20, seed=9))
    assert source == "network" and 0.9 < strat["alpha"] < 1.0
