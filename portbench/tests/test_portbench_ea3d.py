"""The PT cells (``ea3d-l32.pt``, ``sk4096.pt``) through the whole harness
on the CPU at tiny sizes: sound runs are correct, and each fault fails a
check: the ladder off by one slot, the overlap of replicas not matched by
slot, a sweep that returns its state unchanged, half the replicas left
out."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import TINY_SK
from portbench.tests.test_portbench_check import _faulty

TINY_EA = {"L": 6, "seed": 5}
TINY_PARAMS = {
    "ea3d-l32.pt": {"n_replicas": 6, "replicas": 12, "n_chains": 2,
                    "max_temp": 3.0, "n_sweeps": 400},
    "sk4096.pt": {"n_replicas": 8, "replicas": 16, "n_chains": 2,
                  "n_sweeps": 100},
}
TINY_CHECK = {"chains": 4, "burn": 300, "measure": 400}


@pytest.fixture(scope="module")
def tiny_ea():
    """The tiny lattice's configuration, its best-known energy the least
    of two deep runs of the program (as the cell's record is made)."""
    from spinglass_tpu_torch.anneal import pt
    from spinglass_tpu_torch.core.topology import lattice_coo
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    p = EllProblem.from_coo(*lattice_coo(TINY_EA["L"], seed=TINY_EA["seed"]),
                            device="cpu")
    best = min(pt.run(p, pt.PTConfig(
        n_replicas=8, n_sweeps=3000, ladder="linear", min_temp=0.5,
        max_temp=3.0, seed=s)).best_energy for s in (1, 2))
    return {"name": "ea3d-l32", "generator": "ea3d",
            "instance": dict(TINY_EA, dims=3, periodic=True, dist="binary",
                             best_known_energy=best)}


def run_tiny(bench, name, cfg, seconds=1.0, seed=2 ** 31 + 5):
    wl = harness.cell(name, bench)
    wl = dict(wl, params=dict(wl["params"], **TINY_PARAMS[name]))
    if "check" in wl:
        wl["check"] = dict(wl["check"], **TINY_CHECK)
    return harness.run_cell(wl, cfg, bench, seed, seconds, False,
                            device="cpu")


def _config(name, tiny_ea):
    return tiny_ea if name == "ea3d-l32.pt" else TINY_SK


@pytest.mark.parametrize("name", ["ea3d-l32.pt", "sk4096.pt"])
def test_sound_pt_runs_are_correct(bench, name, tiny_ea):
    out = run_tiny(bench, name, _config(name, tiny_ea))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"flips_per_s", "setup_s"}
    want = {"energy_gap", "best_not_min", "quality_gap", "unmoved"}
    if name == "ea3d-l32.pt":
        want |= {"overlap_gap", "thermal_gap"}
        # q in float32: exact where N is a power of two, here N = 216
        assert out["checks"]["overlap_gap"]["value"] < 1e-7
    assert set(out["checks"]) == want


def _ladder_off_by_one(monkeypatch):
    """Slot k sweeps at the temperature of slot k + 1 (the top two slots at
    the top one's)."""
    from spinglass_tpu_torch.anneal import pt

    ladder = pt.temperature_ladder

    def shifted(cfg):
        t = ladder(cfg)
        return np.concatenate([t[1:], t[-1:]])

    monkeypatch.setattr(pt, "temperature_ladder", shifted)


def _overlap_by_position(monkeypatch):
    """The overlap of the replicas at the same place of each chain, not of
    those that hold the same slot."""
    from spinglass_tpu_torch.kernels import overlap_cuda

    call = overlap_cuda.ReplicaOverlap.__call__

    def by_position(self, spins, slot):
        t = slot.shape[0] // self.n_chains
        return call(self, spins, torch.arange(
            t, dtype=slot.dtype, device=slot.device).repeat(self.n_chains))

    monkeypatch.setattr(overlap_cuda.ReplicaOverlap, "__call__", by_position)


def _sweep_fault(kind):
    def plant(monkeypatch):
        from spinglass_tpu_torch.anneal import pt

        monkeypatch.setattr(pt, "make_engine", _faulty(kind))
    return plant


FAULTS = {"ladder": (_ladder_off_by_one, "thermal_gap"),
          "overlap_by_position": (_overlap_by_position, "overlap_gap"),
          "unchanged": (_sweep_fault("unchanged"), "unmoved"),
          "half": (_sweep_fault("half"), "unmoved")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_ea3d_faults_are_not_correct(bench, fault, tiny_ea, monkeypatch):
    plant, check = FAULTS[fault]
    plant(monkeypatch)
    out = run_tiny(bench, "ea3d-l32.pt", tiny_ea)
    assert not out["correct"], out["checks"]
    assert out["checks"][check]["value"] > out["checks"][check]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_sk_pt_faults_are_not_correct(bench, fault, monkeypatch):
    _sweep_fault(fault)(monkeypatch)
    out = run_tiny(bench, "sk4096.pt", TINY_SK)
    assert not out["correct"], out["checks"]


def test_the_sk_pt_bf16_control_is_not_correct(bench):
    wl = harness.cell("sk4096.pt", bench)
    wl = dict(wl, params=dict(wl["params"], **TINY_PARAMS["sk4096.pt"]))
    out = harness.run_cell(wl, TINY_SK, bench, 2 ** 31 + 5, 1.0, False,
                           device="cpu", control="reference_bf16")
    assert out["checks"]["energy_gap"]["value"] > \
        out["checks"]["energy_gap"]["limit"]


def test_the_lattice_instance_is_the_records(bench):
    """The cell's configuration builds the recorded sample (its hash), and
    the program's lattice is the reference's."""
    from portbench.reference import ea3d
    from spinglass_tpu_torch.core.topology import lattice_coo

    cfg = harness.load_json("configs", "ea3d-l32.json")
    inst = ea3d.build(cfg, 7, "cpu")
    assert inst["n"] == 32768 and len(inst["rows"]) == 196608
    n, rows, cols, vals = lattice_coo(32, seed=cfg["instance"]["seed"])
    for a, b in ((rows, inst["rows"]), (cols, inst["cols"]),
                 (vals, inst["vals"])):
        np.testing.assert_array_equal(a, b)
    assert inst["ground_energy"] < -1.6 * 32768


@pytest.mark.parametrize("name,want", [("ea3d-l32.pt", 136),
                                       ("sk4096.pt", 1024)])
def test_a_pt_cells_replica_count_is_its_sweeps(bench, name, want):
    """A sweep reader's replica count (``replicas_param``) is n_replicas x
    n_chains, and a count that is not is refused before any run."""
    from types import SimpleNamespace

    from portbench import readings
    from portbench.traffic import pt_runs

    wl = harness.cell(name, bench)
    assert readings.replicas(SimpleNamespace(params=wl["params"],
                                             workload=wl)) == want
    with pytest.raises(ValueError, match="replicas"):
        pt_runs._config(dict(wl["params"], replicas=want + 1))
