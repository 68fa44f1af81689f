"""The Swendsen-Wang kernels' plain versions (``kernels/cluster_cuda.py``:
C2 the bond activation, C1 the labels and flip) against
``spinglass_tpu.core.cluster.SwendsenWang._sweep`` on the CPU.

JAX's own bonds and start labels are read from inside its sweep: the test
runs ``_sweep`` eagerly and records the ``lax.while_loop`` it calls (its
start value is JAX's ``init``; its body closes over JAX's ``bond``). The
draws come from the JAX key as ``tests/test_torch_cluster.py`` derives
them. +-J couplings with h on a quarter grid make every product exact, so
masks, start labels, spins and cluster counts compare exactly; dE within
1e-5 relative (two float32 energies), as in ``test_torch_cluster.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.core import cluster as JC  # noqa: E402
from spinglass_tpu.core.problem import IsingProblem as JProblem  # noqa: E402
from spinglass_tpu.kernels import sparse as JS  # noqa: E402
from spinglass_tpu_torch.anneal import graphs, pt  # noqa: E402
from spinglass_tpu_torch.benchmarks import planted  # noqa: E402
from spinglass_tpu_torch.core import cluster as TC  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.kernels import cluster_cuda as CC  # noqa: E402
from spinglass_tpu_torch.kernels import metropolis_cuda as MC  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402


def _problems(kind):
    if kind == "ell":
        rows, cols, vals = topology.sparse_random_graph_coo(
            160, avg_degree=4.0, dist="binary", seed=21)
        h = np.random.default_rng(21).integers(-4, 5, 160) / 4.0
        return (JS.EllProblem.from_coo(160, rows, cols, vals, h),
                S.EllProblem.from_coo(160, rows, cols, vals, h, device="cpu"))
    j = topology.fully_connected(40, dist="binary", seed=22)
    h = np.random.default_rng(22).integers(-4, 5, 40) / 4.0
    return (JProblem.from_dense(j, h),
            IsingProblem.from_dense(j, h, device="cpu"))


def _spins(r, n_pad, n, seed):
    s = np.where(np.random.default_rng(seed).random((r, n_pad)) < 0.5,
                 -1.0, 1.0).astype(np.float32)
    s[:, n:] = 1.0
    return s


def _jax_draws(key, r, n_pad, k):
    k_bond, k_ghost, k_flip = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k_bond, (r, n_pad, k))),
            np.array(jax.random.uniform(k_ghost, (r, n_pad))),
            np.array(jax.random.bernoulli(k_flip, 0.5, (r, n_pad))))


class _Recorder:
    """Stands in for ``jax.lax`` in the JAX cluster module: records the
    labelling loop's body and start value, then runs it."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax.lax, name)

    def while_loop(self, cond, body, init):
        self.calls.append((body, init))
        return jax.lax.while_loop(cond, body, init)


def _jax_sweep_inside(monkeypatch, jsw, s, betas, key):
    """JAX's sweep run eagerly: (spins, dE, n_clusters, bond, init)."""
    rec = _Recorder()
    monkeypatch.setattr(JC, "lax", rec)
    out = jsw._sweep(jnp.asarray(s), jnp.asarray(betas), key)
    monkeypatch.undo()
    body, init = rec.calls[-1]
    cells = dict(zip(body.__code__.co_freevars, body.__closure__))
    return (*(np.asarray(o) for o in out),
            np.asarray(cells["bond"].cell_contents), np.asarray(init[0]))


@pytest.mark.parametrize("kind,beta", [("ell", 0.3), ("ell", 1.1),
                                       ("dense", 0.6)])
def test_bond_masks_and_start_labels_equal_jax(monkeypatch, kind, beta):
    """C2's plain version on JAX's draws: its masks unpack to exactly the
    bonds JAX's sweep forms, its start labels are JAX's (ELL at two betas,
    and a dense 40-spin problem: K = 39, two mask words)."""
    jp, tp = _problems(kind)
    jsw, tsw = JC.SwendsenWang(jp), TC.SwendsenWang(tp)
    r, n_pad = 5, tp.n_padded
    k = tsw.ell.idx.shape[1]
    if kind == "dense":
        assert k == 39
    before = build.launch_snapshot()
    betas = np.float32(beta) * np.linspace(0.5, 1.5, r, dtype=np.float32)
    s = _spins(r, n_pad, tp.n_spins, 23)
    for trial in range(2):
        key = jax.random.key(40 + trial)
        _, _, _, bond, init = _jax_sweep_inside(monkeypatch, jsw, s, betas,
                                                key)
        u_dir, u_ghost, _ = (torch.as_tensor(d) for d in
                             _jax_draws(key, r, n_pad, k))
        masks, t_init = tsw.bonds(torch.as_tensor(s), torch.as_tensor(betas),
                                  u_dir=u_dir, u_ghost=u_ghost)
        assert masks.shape == (r, n_pad, -(-k // 32))
        assert masks.dtype == torch.int32 and t_init.dtype == torch.int32
        np.testing.assert_array_equal(CC.unpack_masks(masks, k).numpy(), bond)
        np.testing.assert_array_equal(t_init.numpy(), init)
        assert bond.any() and build.launches_since(
            before, [CC.BONDS_KERNEL]) == {CC.BONDS_KERNEL: 0}


@pytest.mark.parametrize("kind,beta", [("ell", 0.4), ("ell", 1.3),
                                       ("dense", 0.8)])
def test_plain_labels_and_flip_equal_jax_sweep(monkeypatch, kind, beta):
    """C2 then C1's plain version (labels_reference on the unpacked masks,
    then flip_reference) on JAX's draws: spins and n_clusters equal JAX's
    sweep exactly, dE (from the port's two ELL energies) within 1e-5
    relative; the whole sweep_with_draws gives the same."""
    jp, tp = _problems(kind)
    jsw, tsw = JC.SwendsenWang(jp), TC.SwendsenWang(tp)
    r, n_pad = 6, tp.n_padded
    k = tsw.ell.idx.shape[1]
    betas = torch.as_tensor(np.float32(beta)
                            * np.linspace(0.5, 1.5, r, dtype=np.float32))
    s = _spins(r, n_pad, tp.n_spins, 24)
    before = build.launch_snapshot()
    for trial in range(3):
        key = jax.random.key(60 + trial)
        js, jde, jnc, _, _ = _jax_sweep_inside(monkeypatch, jsw, s,
                                               betas.numpy(), key)
        u_dir, u_ghost, coins = (torch.as_tensor(d) for d in
                                 _jax_draws(key, r, n_pad, k))
        st = torch.as_tensor(s)
        masks, init = tsw.bonds(st, betas, u_dir=u_dir, u_ghost=u_ghost)
        c1 = CC.ClusterLabels()
        new, n_cl, labels, rounds = c1.flip(tsw._idx, masks, init, st,
                                            coins=coins)
        de = S.sparse_energy(tsw.ell, new) - S.sparse_energy(tsw.ell, st)
        np.testing.assert_array_equal(new.numpy(), js)
        np.testing.assert_array_equal(n_cl.numpy(), jnc)
        np.testing.assert_allclose(de.numpy(), jde, rtol=1e-5)
        assert build.launches_since(before, [CC.KERNEL_NAME]) == {
            CC.KERNEL_NAME: 0} and (rounds >= 1).all()
        assert (rounds <= n_pad).all()
        act = tp.active_mask.numpy() > 0
        assert (labels.numpy()[:, ~act] == n_pad).all()
        ws, wde, wnc = tsw.sweep_with_draws(st, betas, u_dir, u_ghost, coins)
        assert torch.equal(ws, new) and torch.equal(wnc, n_cl)
        assert torch.equal(wde, de)
        s = np.array(js)


@pytest.mark.parametrize("kind", ["ell", "dense"])
def test_philox_mode_equals_given_mode_on_its_words(kind):
    """C2's Philox mode equals its given mode fed ``sw_philox_draws``' words
    (each edge's uniform drawn at its lower end's counter), C1's Philox
    coins equal the given coins, and ``sweep`` (one seed from the
    generator) equals ``sweep_with_draws`` on that seed's draws."""
    _, tp = _problems(kind)
    tsw = TC.SwendsenWang(tp)
    r, n_pad = 7, tp.n_padded
    k = tsw.ell.idx.shape[1]
    betas = torch.linspace(0.2, 1.6, r)
    st = torch.as_tensor(_spins(r, n_pad, tp.n_spins, 25))
    for seed in (3, 2 ** 61 + 12345):
        u_dir, u_ghost, coins = MC.sw_philox_draws(seed, r, n_pad, k)
        assert u_dir.shape == (r, n_pad, k) and coins.dtype == torch.bool
        assert 0 < float(u_dir.min()) and float(u_dir.max()) < 1
        m_p, i_p = tsw.bonds(st, betas, seed=seed)
        m_g, i_g = tsw.bonds(st, betas, u_dir=u_dir, u_ghost=u_ghost)
        assert torch.equal(m_p, m_g) and torch.equal(i_p, i_g)
        labels, _ = CC.labels_reference(tsw._idx, CC.unpack_masks(m_p, k), i_p)
        a = CC.flip_reference(st, labels, i_p, seed=seed)
        b = CC.flip_reference(st, labels, i_p, coins=coins)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    gen = torch.Generator().manual_seed(11)
    seed = torch.Generator().manual_seed(11)
    want = tsw.sweep_with_draws(st, betas, *MC.sw_philox_draws(
        int(torch.randint(0, 2 ** 62, (1,), generator=seed)), r, n_pad, k))
    got = tsw.sweep(st, betas, gen)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # both ends of an edge see one uniform: the bond sets are symmetric
    bond = CC.unpack_masks(m_p, k)
    rev = bond[:, tsw.rev_i.long(), tsw.rev_k.long()]
    real = tsw.ell.val != 0
    assert torch.equal(bond[:, real], rev[:, real])


def test_mask_packing_and_word_layout():
    """pack_bonds / unpack_masks round-trip at K = 19, 32, 33 and 70 (bit
    q % 32 of word q // 32, bit 31 as the int32 sign)."""
    rng = np.random.default_rng(5)
    for k in (19, 32, 33, 70):
        bond = torch.as_tensor(rng.random((3, 9, k)) < 0.4)
        masks = CC.pack_bonds(bond)
        assert masks.shape == (3, 9, -(-k // 32))
        assert masks.dtype == torch.int32
        assert torch.equal(CC.unpack_masks(masks, k), bond)
        words = masks.numpy().view(np.uint32).astype(np.int64)
        for q in (0, k - 1, min(31, k - 1)):
            np.testing.assert_array_equal(
                (words[:, :, q // 32] >> (q % 32)) & 1, bond[:, :, q].numpy())


def test_labels_plan_picks_shared_cluster_or_device_memory():
    """Where C1 keeps its parent table: one block at R=128, a cluster of 8
    at R=16 (128 blocks on 132 SMs), 4 at 32, the least cluster beyond one
    block's shared memory, device memory beyond 8 x 32768 nodes; a fixed
    ``blocks`` is honoured or refused."""
    assert CC.labels_plan(10112, 128) == (0, 1, 0)
    assert CC.labels_plan(10112, 16) == (1, 8, 11)      # 2048-node chunks
    assert CC.labels_plan(10112, 32)[:2] == (1, 4)
    assert CC.labels_plan(10112, 16, blocks=1) == (0, 1, 0)
    assert CC.labels_plan(10112, 16, blocks=0) == (2, 1, 0)
    assert CC.labels_plan(60000, 128) == (1, 2, 15)
    assert CC.labels_plan(200000, 128)[:2] == (1, 8)
    assert CC.labels_plan(300000, 16) == (2, 1, 0)
    for n, r, blocks in ((60000, 16, 1), (300000, 16, 8), (100, 16, 9)):
        with pytest.raises(ValueError):
            CC.labels_plan(n, r, blocks=blocks)
    for n, r in ((1, 1), (57998, 1), (10112, 3), (262142, 2)):
        mode, blocks, shift = CC.labels_plan(n, r)
        assert mode == 2 or blocks << shift >= n + 1


def test_wrappers_check_their_modes():
    """C2 takes the given draws or a seed, C1's flip coins or a seed."""
    _, tp = _problems("ell")
    tsw = TC.SwendsenWang(tp)
    st = torch.ones(2, tp.n_padded)
    with pytest.raises(ValueError):
        tsw.bonds(st, torch.ones(2))
    with pytest.raises(ValueError):
        tsw.bonds(st, torch.ones(2), u_dir=torch.rand(2, tp.n_padded, 4),
                  seed=1)
    masks, init = tsw.bonds(st, torch.ones(2), seed=1)
    with pytest.raises(ValueError):
        tsw.labeller.flip(tsw._idx, masks, init, st)


def test_captured_cluster_move_step_draws_a_seed_not_uniforms():
    """pt.run with cluster_moves=1 on the CPU equals its eager super-step
    loop, and the captured step's random tape holds one seed per SW sweep
    (beside the engine's sweeps) and no device draw of [R, Np, K]."""
    inst = planted.planted_gauge_coo(90, 4.0, seed=8)
    ell = S.EllProblem.from_coo(90, inst.rows, inst.cols, inst.vals,
                                device="cpu")
    cfg = pt.PTConfig(n_replicas=3, n_chains=2, n_sweeps=40,
                      exchange_interval=4, cluster_moves=2, seed=4)
    res = pt.run(ell, cfg)
    step, _, eng = pt.make_pt_step(ell, cfg)
    st = pt.init_state(ell, cfg, torch.Generator().manual_seed(4), eng)
    best = []
    for _ in range(10):
        st, stats = step(st)
        best.append(float(stats["best_energy"]))
    np.testing.assert_array_equal(res.energy_history, np.float32(best))
    np.testing.assert_array_equal(res.replica_best_energy,
                                  st.best_energy.numpy())
    assert res.metadata["kernel_launches"]["sw_bonds"] == 0
    assert res.metadata["kernel_launches"]["sw_labels"] == 0
    captured = graphs.PT_CACHE.get(ell, ("run", graphs.config_key(cfg)))[2]
    k = ell.idx.shape[1]
    shapes = [tuple(op[1]) for e in captured.tape.entries if e != "seed"
              for op in e[2] if op[0] != "randperm"]
    assert all(len(s) < 3 or s[-1] != k for s in shapes), shapes
    assert sum(e == "seed" for e in captured.tape.entries) >= 2

