"""Checkpoint/resume of the port (``utils/checkpoint.py``, ``sa.anneal`` and
``pt.run`` with ``checkpoint_dir``), held to the JAX package's contract
(``tests/unit/test_anneal.py`` TestCheckpointResume): a run resumed from an
earlier checkpoint equals the uninterrupted run, here bit for bit, since
every draw comes from the run's one host generator.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.utils import checkpoint as jck  # noqa: E402
from spinglass_tpu_torch.anneal import pt, sa  # noqa: E402
from spinglass_tpu_torch.benchmarks import planted  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels.sparse import EllProblem  # noqa: E402
from spinglass_tpu_torch.utils import checkpoint as ck  # noqa: E402
from spinglass_tpu_torch.utils.exceptions import CheckpointError  # noqa: E402

RESULT_ARRAYS = ("best_spins", "replica_best_energy", "energy_history",
                 "mean_energy_history", "temperature_history",
                 "acceptance_history")


def _dense(n=24, seed=5):
    j = topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-4, 5, n) / 4.0
    return IsingProblem.from_dense(j, h, device="cpu")


def _ell(n=120, seed=1):
    inst = planted.planted_gauge_coo(n, 4.0, seed=seed)
    return EllProblem.from_coo(n, inst.rows, inst.cols, inst.vals,
                               device="cpu")


def _same(a, b):
    for name in RESULT_ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)
    assert a.best_energy == b.best_energy and a.n_sweeps == b.n_sweeps
    assert a.converged == b.converged


def _keep_first(d):
    """Simulate a crash: every checkpoint but the earliest kept one goes."""
    steps = sorted(int(f[5:-3]) for f in os.listdir(d) if f.startswith("ckpt_"))
    assert len(steps) >= 2
    for s in steps[1:]:
        os.remove(os.path.join(d, f"ckpt_{s}.pt"))
    return steps[0]


# -- utils/checkpoint.py -------------------------------------------------------

def test_tree_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    tree = {"spins": torch.tensor([[1.0, -1.0]]), "s8": torch.ones(3, dtype=torch.int8),
            "gen": gen, "hist": {"e": np.arange(4, dtype=np.float32)},
            "n": np.int64(7), "k": 3, "lst": [torch.zeros(2), 1.5]}
    path = str(tmp_path / "t.pt")
    ck.save_pytree(tree, path)
    tmpl = {"spins": torch.zeros(1, 2), "s8": torch.zeros(3, dtype=torch.int8),
            "gen": torch.Generator(), "hist": {"e": np.zeros(0)},
            "n": np.int64(0), "k": 0, "lst": [torch.ones(2), 0.0]}
    out = ck.load_pytree(tmpl, path)
    assert torch.equal(out["spins"], tree["spins"]) and out["s8"].dtype == torch.int8
    assert torch.equal(torch.rand(4, generator=out["gen"]),
                       torch.rand(4, generator=gen))
    # numpy leaves take the template's dtype, not its shape (as in JAX)
    assert out["hist"]["e"].dtype == np.float64
    np.testing.assert_array_equal(out["hist"]["e"], np.arange(4))
    assert out["n"] == 7 and isinstance(out["n"], np.int64)
    assert out["k"] == 3 and out["lst"][1] == 1.5


@pytest.mark.parametrize("bad,match", [
    ({"s": torch.zeros(3, 2)}, "stored shape"),
    ({"s": torch.zeros(2, 3, dtype=torch.int8)}, "different kind"),
    ({"t": torch.zeros(2, 3)}, "missing leaf"),
])
def test_load_checks_tensor_leaves_as_jax(tmp_path, bad, match):
    """Shape and dtype kind of each tensor leaf are checked against the
    template, like the JAX npz loader's (a float spin array never loads
    into an int8 layout); the JAX loader raises on the same trees."""
    path = str(tmp_path / "c.pt")
    ck.save_pytree({"s": torch.ones(2, 3)}, path)
    with pytest.raises(CheckpointError, match=match):
        ck.load_pytree(bad, path)
    jpath = str(tmp_path / "c.npz")
    jck.save_pytree({"s": jnp.ones((2, 3))}, jpath)
    jbad = {k: jnp.asarray(v.numpy()) for k, v in bad.items()}
    with pytest.raises(jck.CheckpointError, match=match):
        jck.load_pytree(jbad, jpath)


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_manager_cadence_and_retention(tmp_path, keep):
    """maybe_save saves when ``every`` divides the step, keeps the last
    ``keep`` files, and restore_latest reads the newest (JAX behaviour)."""
    d = str(tmp_path / "m")
    mgr = ck.CheckpointManager(d, every=2, keep=keep)
    jmgr = jck.CheckpointManager(str(tmp_path / "j"), every=2, keep=keep,
                                 use_orbax=False)
    assert mgr.latest_step() is None and mgr.restore_latest({"x": 0}) is None
    for step in range(1, 10):
        saved = mgr.maybe_save(step, {"x": torch.tensor(float(step))})
        jmgr.maybe_save(step, {"x": np.float32(step)})
        assert (saved is not None) == (step % 2 == 0)
    files = sorted(os.listdir(d), key=lambda f: int(f[5:-3]))
    assert files == [f"ckpt_{s}.pt" for s in (2, 4, 6, 8)[-keep:]]
    assert len(os.listdir(str(tmp_path / "j"))) == keep
    assert mgr.latest_step() == jmgr.latest_step() == 8
    assert float(mgr.restore_latest({"x": torch.zeros(())})["x"]) == 8.0


# -- sa.anneal -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_sa_resume_equals_uninterrupted(tmp_path, kind):
    """Checkpoint every 2 chunks, delete all but the first, resume: every
    result array equals the uninterrupted run's (a short last chunk too)."""
    p = _dense() if kind == "dense" else _ell()
    cfg = sa.SAConfig(n_sweeps=115, n_replicas=4, record_interval=10,
                      enable_early_stop=False, seed=11)
    ref = sa.anneal(p, cfg)
    d = str(tmp_path / "sa")
    _same(sa.anneal(p, cfg, checkpoint_dir=d, checkpoint_every=2), ref)
    assert sorted(os.listdir(d)) == ["ckpt_10.pt", "ckpt_12.pt", "ckpt_8.pt"]
    assert _keep_first(d) == 8
    _same(sa.anneal(p, cfg, checkpoint_dir=d, resume=True), ref)
    # a resume from the final checkpoint runs nothing and still agrees
    _same(sa.anneal(p, cfg, checkpoint_dir=d, checkpoint_every=2,
                    resume=True), ref)


def test_sa_resume_with_early_stop(tmp_path):
    """A ferromagnet converges: the resumed run stops at the same sweep."""
    p = IsingProblem.from_dense(topology.fully_connected(
        16, dist="ferromagnetic"), device="cpu")
    cfg = sa.SAConfig(n_sweeps=600, n_replicas=2, record_interval=10,
                      convergence_tolerance=1e-3, seed=2)
    ref = sa.anneal(p, cfg)
    assert ref.converged and ref.n_sweeps < 600
    d = str(tmp_path / "es")
    sa.anneal(p, cfg, checkpoint_dir=d, checkpoint_every=5)
    _keep_first(d)
    res = sa.anneal(p, cfg, checkpoint_dir=d, resume=True)
    _same(res, ref)
    assert res.convergence_sweep == ref.convergence_sweep


def test_sa_resume_on_an_empty_directory_starts_fresh(tmp_path):
    p = _dense()
    cfg = sa.SAConfig(n_sweeps=40, n_replicas=2, record_interval=10, seed=4)
    _same(sa.anneal(p, cfg, checkpoint_dir=str(tmp_path / "e"), resume=True),
          sa.anneal(p, cfg))


def test_sa_resume_refuses_another_layout(tmp_path):
    """A checkpoint of the [R, Np] layout does not load into another
    replica count: the template check raises CheckpointError."""
    p = _dense()
    d = str(tmp_path / "lay")
    cfg = sa.SAConfig(n_sweeps=40, n_replicas=2, record_interval=10)
    sa.anneal(p, cfg, checkpoint_dir=d, checkpoint_every=1)
    with pytest.raises(CheckpointError, match="stored shape"):
        sa.anneal(p, sa.SAConfig(n_sweeps=40, n_replicas=3,
                                 record_interval=10),
                  checkpoint_dir=d, resume=True)


# -- pt.run --------------------------------------------------------------------

def _pt_same(a, b):
    _same(a, b)
    for key in ("exchange_rates", "slot_energy", "ladder"):
        assert a.metadata[key] == b.metadata[key], key
    for key in ("slot_trajectory", "slot_energy_history"):
        np.testing.assert_array_equal(a.metadata[key], b.metadata[key], key)


@pytest.mark.parametrize("kind,method", [("dense", "blocked"),
                                         ("ell", "sparse_t"),
                                         ("ell", "sparse")])
def test_pt_segmented_and_resumed_equal_single_dispatch(tmp_path, kind, method):
    """Checkpoint every 3 super-steps: the segmented run, and a run resumed
    after deleting all but the first checkpoint (its history.npz is then
    ahead of the state and must be cut), equal the single-dispatch run."""
    p = _dense() if kind == "dense" else _ell()
    cfg = pt.PTConfig(n_replicas=4, n_chains=2, n_sweeps=100,
                      exchange_interval=5, sweep_method=method, seed=4)
    ref = pt.run(p, cfg)
    d = str(tmp_path / "pt")
    _pt_same(pt.run(p, cfg, checkpoint_dir=d, checkpoint_every=3), ref)
    with np.load(os.path.join(d, "history.npz")) as z:
        assert z["best_energy"].shape == (20,)
    meta = json.load(open(os.path.join(d, "engine_meta.json")))
    assert meta["engine"] == ref.metadata["engine"]
    assert meta["sweep_method"] == method and meta["update_rule"] == "metropolis"
    assert _keep_first(d) == 15
    res = pt.run(p, cfg, checkpoint_dir=d, checkpoint_every=3, resume=True)
    _pt_same(res, ref)
    with np.load(os.path.join(d, "history.npz")) as z:
        np.testing.assert_array_equal(z["best_energy"], ref.energy_history)


def test_pt_resume_refuses_engine_mismatch(tmp_path):
    p = _dense()
    d = str(tmp_path / "mis")
    cfg = pt.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=10,
                      sweep_method="colored", seed=5)
    pt.run(p, cfg, checkpoint_dir=d, checkpoint_every=2)
    cfg2 = pt.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=10,
                       sweep_method="blocked", seed=5)
    with pytest.raises(CheckpointError, match="sweep_method"):
        pt.run(p, cfg2, checkpoint_dir=d, resume=True)


def test_pt_resume_refuses_state_dtype_mismatch(tmp_path):
    """The sparse transposed engine keeps int8 spins on the threshold and K4
    paths and float32 under K2: the sidecar's state dtype must match."""
    p = _ell()
    d = str(tmp_path / "dt")
    cfg = pt.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=10,
                      sweep_method="sparse_t", seed=5)
    pt.run(p, cfg, checkpoint_dir=d, checkpoint_every=2)
    meta_path = os.path.join(d, "engine_meta.json")
    meta = json.load(open(meta_path))
    assert meta["spin_dtype"] == "torch.int8"
    meta["spin_dtype"] = "torch.float32"      # as K2 would have written it
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(CheckpointError, match="spin dtype"):
        pt.run(p, cfg, checkpoint_dir=d, resume=True)
    # without the sidecar the template's dtype-kind check still refuses
    os.remove(meta_path)
    state = torch.load(os.path.join(d, "ckpt_4.pt"), weights_only=True)
    state["/state/spins"] = state["/state/spins"].float()
    torch.save(state, os.path.join(d, "ckpt_4.pt"))
    with pytest.raises(CheckpointError, match="different kind"):
        pt.run(p, cfg, checkpoint_dir=d, resume=True)


def test_pt_resume_without_checkpoint_dir_is_a_value_error():
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        pt.run(_ell(), pt.PTConfig(n_replicas=4, n_sweeps=10), resume=True)
