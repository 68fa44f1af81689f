"""Fixtures of the benchmark's own tests: tiny configurations that the CPU
runs through the whole harness, and the ``gpu`` marker for the tests that
need the card (decided inside a fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card")


@pytest.fixture(scope="session")
def bench():
    from portbench import harness

    return harness.benchmark()


TINY_SK = {"name": "sk4096", "generator": "sk", "sizes": {"n_spins": 128}}


def tiny_planted():
    """A 256-spin planted instance with no frustration: the planted state
    is its ground state, so its energy is the target's."""
    from portbench.reference import planted

    spec = {"n_spins": 256, "avg_degree": 6.0, "seed": 3, "frustration": 0.0,
            "magnitude": "uniform"}
    _, _, v = planted.planted_gauge_coo(**spec)
    return {"name": "planted10k", "generator": "planted",
            "instance": dict(spec, best_known_energy=-0.5 * float(abs(v).sum()),
                             rel_gap=0.05, max_sweeps=400)}


TINY_PARAMS = {"sk4096.sa": {"n_replicas": 16, "n_sweeps": 100},
               "planted10k.sa": {"n_replicas": 16, "n_sweeps": 100},
               "planted10k.ttt": {"n_replicas": 8},
               "planted10k.ppo": {"n_envs": 16, "rollout_len": 4,
                                  "max_steps": 6}}


def run_tiny(bench, name, seconds=1.0, seed=2 ** 31 + 11, **kw):
    """One CPU run of cell ``name`` at the tiny size, through ``run_cell``."""
    from portbench import harness

    wl = harness.cell(name, bench)
    wl = dict(wl, params=dict(wl["params"], **TINY_PARAMS[name]))
    cfg = TINY_SK if wl["config"] == "sk4096" else tiny_planted()
    return harness.run_cell(wl, cfg, bench, seed, seconds, False,
                            device="cpu", **kw)
