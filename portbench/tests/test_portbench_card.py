"""Tests that need the card (marker ``gpu``; they skip without one):
``python -m pytest portbench/tests -m gpu -q`` on a machine with an H100.

The program's own lower-precision paths as controls, at a size a test run
holds: K1 on J rounded to bfloat16, and PPO's matrix products in TF32, must
both come out not correct; and one short run of a cell through ``run.py``
prints a correct result."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT, TINY_SK


@pytest.mark.gpu
def test_dense_bf16_control_on_the_card(cuda, bench):
    params = {"n_replicas": 256, "n_sweeps": 200}
    sound = dict(TINY_SK, sizes={"n_spins": 1024})
    wl = harness.cell("sk4096.sa", bench)
    wl = dict(wl, params=dict(wl["params"], **params))
    ok = harness.run_cell(wl, sound, bench, 5, 2.0, False)
    assert ok["correct"], ok["checks"]
    low = harness.run_cell(wl, sound, bench, 5, 2.0, False,
                           control="program_bf16")
    assert not low["correct"], low["checks"]


@pytest.mark.gpu
def test_ppo_tf32_control_on_the_card(cuda, bench):
    """At the cell's own size (its check needs no window): at the tiny
    size TF32's gaps stay under the limits set at the cell's size."""
    wl = harness.cell("planted10k.ppo", bench)
    cfg = harness.load_json("configs", "planted10k.json")
    ok = harness.run_cell(wl, cfg, bench, 2 ** 31 + 98, 1.0, False)
    assert ok["correct"], ok["checks"]
    low = harness.run_cell(wl, cfg, bench, 2 ** 31 + 98, 1.0, False,
                           control="program_tf32")
    assert not low["correct"], low["checks"]


@pytest.mark.gpu
def test_run_prints_a_correct_result(cuda):
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "planted10k.sa",
         "--seed", str(2 ** 31 + 7), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
