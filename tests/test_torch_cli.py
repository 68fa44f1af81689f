"""The port's command line (``sgt-torch``, ``spinglass_tpu_torch.cli``) on
the CPU, in process through click's ``CliRunner``: ``solve`` (SA and PT),
``ising`` and ``load`` exit 0 with the JAX command's output lines; each
option that needs a module not ported yet exits 1 with the driver's
NotImplementedError, which names the module."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from click.testing import CliRunner  # noqa: E402

from spinglass_tpu_torch import cli  # noqa: E402
from spinglass_tpu_torch.anneal.result import AnnealResult  # noqa: E402


def _run(*args):
    return CliRunner().invoke(cli.main, ["--device", "cpu", *args])


@pytest.mark.parametrize("algorithm", ["sa", "pt"])
def test_solve_tsp_on_the_cpu(algorithm, tmp_path):
    out = tmp_path / "sol.json"
    res = _run("solve", "-p", "tsp", "-s", "5", "-a", algorithm, "--sweeps",
               "200", "--replicas", "8", "-o", str(out))
    assert res.exit_code == 0, res.output
    lines = res.output.splitlines()
    assert lines[0].startswith("objective: ")
    assert lines[1].startswith("energy:    ")
    assert lines[2] == "feasible:  True"
    assert lines[-1] == f"saved to {out}"
    sol = json.loads(out.read_text())
    assert sol["metadata"]["anneal"]["device"] == "cpu"
    assert sorted(sol["variables"]["tour"]) == list(range(5))
    assert sol["metadata"]["anneal"]["n_sweeps"] == 200
    assert sol["metadata"]["anneal"]["algorithm"].startswith(algorithm)


@pytest.mark.parametrize("problem", ["maxcut", "qap", "scheduling", "jobshop",
                                     "resource", "coordination",
                                     "simple_scheduler", "vrp", "vrp_arc"])
def test_solve_every_registered_problem(problem):
    res = _run("solve", "-p", problem, "-s", "3", "--sweeps", "50",
               "--replicas", "4", "--quiet")
    assert res.exit_code == 0, res.output
    assert res.output == ""


@pytest.mark.parametrize("topo", ["fully_connected", "grid", "chain",
                                  "random", "small_world", "scale_free"])
def test_ising_and_load(topo, tmp_path):
    out = tmp_path / "res.npz"
    res = _run("ising", "-n", "36", "--topology", topo, "--sweeps", "100",
               "--replicas", "4", "-o", str(out))
    assert res.exit_code == 0, res.output
    energy = float(res.output.splitlines()[0].split(":")[1])
    assert np.isfinite(energy) and energy < 0
    assert "algorithm:   sa/" in res.output
    loaded = CliRunner().invoke(cli.main, ["load", str(out)])
    assert loaded.exit_code == 0, loaded.output
    summary = json.loads(loaded.output)
    assert summary["n_sweeps"] == 100 and summary["n_replicas"] == 4
    assert summary["best_energy"] == pytest.approx(energy, abs=1e-4)
    assert AnnealResult.load(str(out)).best_energy == summary["best_energy"]


@pytest.mark.parametrize("args,message", [
    (["-a", "pt", "--tune-ladder"], "core/dynamics_analysis.py"),
    (["-a", "pt", "--cluster-moves", "1"], "core/cluster.py"),
    (["-a", "pt", "--checkpoint-dir", "ck"], "utils/checkpoint.py"),
    (["--checkpoint-dir", "ck"], "utils/checkpoint.py"),
    (["--resume"], "utils/checkpoint.py"),
    (["--sweep-method", "sparse_compact"], "sparse_compact"),
    (["-a", "pt", "--sweep-method", "sparse_compact"], "sparse_compact"),
])
def test_unported_options_exit_nonzero_with_the_message(args, message):
    """The driver's NotImplementedError propagates: exit status 1."""
    res = _run("solve", "-p", "tsp", "-s", "4", "--sweeps", "20",
               "--replicas", "4", *args)
    assert res.exit_code == 1, res.output
    assert isinstance(res.exception, NotImplementedError)
    text = str(res.exception)
    assert "not ported yet" in text and message in text
    assert "ROADMAP.md Queue 1 item" in text
    assert "objective:" not in res.output


def test_bad_problem_and_size_are_refused():
    res = _run("solve", "-p", "nope")
    assert res.exit_code != 0 and "unknown problem" in res.output
    res = _run("solve", "-s", "1")
    assert res.exit_code != 0 and "--size must be >= 2" in res.output


def test_device_defaults_to_the_card(monkeypatch):
    """Without --device the problem is built on the card; without one the
    command fails rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = CliRunner().invoke(cli.main, ["solve", "-s", "3", "--sweeps", "10"])
    assert res.exit_code != 0
    assert isinstance(res.exception, RuntimeError)
    assert 'device="cpu"' in str(res.exception)
    assert "objective:" not in res.output


def test_group_lists_the_ported_commands():
    res = CliRunner().invoke(cli.main, ["--help"])
    assert res.exit_code == 0
    for name in ("solve", "ising", "load", "--device"):
        assert name in res.output
    assert "0.1.0" in CliRunner().invoke(cli.main, ["--version"]).output
