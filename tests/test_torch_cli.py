"""The port's command line (``sgt-torch``, ``spinglass_tpu_torch.cli``) on
the CPU, in process through click's ``CliRunner``: ``solve`` (SA and PT),
``ising`` and ``load`` exit 0 with the JAX command's output lines; every
option of the JAX ``solve`` (``--tune-ladder``, ``--cluster-moves``,
``--checkpoint-dir`` / ``--resume``, ``--sweep-method sparse_compact``)
runs and exits 0. The operations commands: ``benchmark`` (a tiny suite,
the JAX summary's keys), ``health`` (exit 0 on the CPU, 1 without a card
unless the CPU is asked for), ``autoscale`` (the JAX command's JSON),
``monitor``, ``cache-stats``, and the /metrics server the group starts from
SGT_METRICS_PORT."""

import json
import pathlib

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
def test_unported_options_exit_nonzero_with_the_message(args, message,
                                                        tmp_path, monkeypatch):
    """The options that once raised for a missing module (named by
    ``message``) run now: exit 0 with the objective line. A checkpoint
    directory gets its checkpoints (and PT its sidecar), and a resume from
    it gives the same output."""
    if message.endswith(".py"):
        assert (pathlib.Path(cli.__file__).parent / message).exists(), message
    monkeypatch.chdir(tmp_path)
    res = _run("solve", "-p", "tsp", "-s", "4", "--sweeps", "20",
               "--replicas", "4", *args)
    assert res.exit_code == 0, (res.output, res.exception)
    assert any(line.startswith("objective: ")
               for line in res.output.splitlines()), res.output
    if "--tune-ladder" in args:
        assert res.output.startswith("tuned ladder: [")
    if "--checkpoint-dir" in args:
        # SA saves every 10 chunks of 50 sweeps (none in 20 sweeps), PT
        # after every 10 super-steps and at the end
        files = sorted(p.name for p in (tmp_path / "ck").iterdir())
        assert ("engine_meta.json" in files) == ("pt" in args), files
        assert any(f.startswith("ckpt_") for f in files) == ("pt" in args)
        again = _run("solve", "-p", "tsp", "-s", "4", "--sweeps", "20",
                     "--replicas", "4", *args, "--resume")
        assert again.exit_code == 0 and again.output == res.output


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
    for name in ("solve", "ising", "load", "--device", "train-rl",
                 "benchmark", "health", "monitor", "autoscale", "bench",
                 "cache-stats"):
        assert name in res.output
    assert "0.1.0" in CliRunner().invoke(cli.main, ["--version"]).output


def test_benchmark_command_on_the_cpu(tmp_path):
    """A tiny standard suite: one summary line per (problem, algorithm),
    and the JSON file's summary has the JAX runner's keys for each."""
    out = tmp_path / "bench.json"
    res = _run("benchmark", "--sizes", "8", "--sweeps", "30", "--trials",
               "1", "-o", str(out))
    assert res.exit_code == 0, (res.output, res.exception)
    lines = res.output.splitlines()
    assert lines[-1] == f"full results → {out}"
    data = json.loads(out.read_text())
    assert set(data["summary"]) == {f"{p}/{a}" for p in (
        "maxcut", "tsp", "qap", "scheduling") for a in ("sa", "pt")}
    for v in data["summary"].values():
        assert set(v) == {"n", "best_objective", "mean_objective",
                          "mean_time", "mean_flips_per_sec",
                          "feasibility_rate"}
    assert len(data["results"]) == 8 and len(lines) == 9
    assert all(np.isfinite(r["objective"]) for r in data["results"])


def test_health_command(monkeypatch):
    """Healthy on the CPU when asked for; without a card and without
    ``--device cpu`` the device checks fail and the command exits 1."""
    res = _run("health")
    assert res.exit_code == 0, res.output
    report = json.loads(res.output)
    assert report["status"] == "healthy"
    assert report["checks"]["annealer"]["status"] == "healthy"
    assert "device=cpu" in report["checks"]["device_compute"]["message"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = CliRunner().invoke(cli.main, ["health"])
    assert res.exit_code == 1
    report = json.loads(res.output)
    assert report["status"] == "unhealthy"
    assert report["checks"]["device_compute"]["status"] == "unhealthy"
    assert report["checks"]["annealer"]["status"] == "unhealthy"


@pytest.mark.parametrize("args", [[], ["--replicas", "1024", "--hbm-used",
                                       "0.95"],
                                  ["--utilization", "0.1", "--queue", "0"]])
def test_autoscale_equals_the_jax_command(args):
    from spinglass_tpu import cli as jcli

    got = CliRunner().invoke(cli.main, ["autoscale", *args])
    want = CliRunner().invoke(jcli.main, ["autoscale", *args])
    assert got.exit_code == want.exit_code == 0
    assert json.loads(got.output) == json.loads(want.output)


def test_monitor_and_cache_stats():
    res = _run("monitor")
    assert res.exit_code == 0, res.output
    snap = json.loads(res.output)
    assert set(snap) == {"host", "device"}
    if not torch.cuda.is_available():
        assert snap["device"] == {}
    res = _run("cache-stats")
    assert res.exit_code == 0, res.output
    stats = json.loads(res.output)
    assert {"size", "max_size", "hits", "misses", "hit_rate", "sa_steps",
            "pt_steps", "batch_runs"} <= set(stats)


def test_group_serves_metrics_from_the_env(monkeypatch):
    """SGT_METRICS_PORT set: the group starts the /metrics server, and a
    solve's gauges are scraped from it."""
    import urllib.request

    from spinglass_tpu_torch.utils import metrics_exporter as me

    monkeypatch.setenv("SGT_METRICS_PORT", "0")
    monkeypatch.setattr(me, "_global_server", None)
    try:
        res = _run("ising", "-n", "16", "--sweeps", "20", "--replicas", "4")
        assert res.exit_code == 0, res.output
        srv = me._global_server
        assert srv is not None
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5).read().decode()
        assert 'spinglass_solver_flips_per_sec{solver="sa"}' in body
    finally:
        if me._global_server is not None:
            me._global_server.stop()
        me._global_server = None
